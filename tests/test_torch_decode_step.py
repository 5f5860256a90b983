"""The port's dense-cache decode against the JAX reference on the CPU:
decode attention at one shared position (the reference's windowed slice
of the cache, whose values are the masked read's), and decode_step's
stack split and pattern fallback on configs tests/test_torch_ssm.py and
tests/test_torch_encdec_frontend.py do not reach: deepseek_v2_lite (a
dense prologue in ``dense_attn``, MoE decode layers in ``main_attn``)
and gemma3_4b at 4 layers (its six-kind pattern does not divide them, so
every layer is local) with window 2, which the 4 scalar positions cross.
Bars: decode attention within 1e-6 of the reference (f32), the slice
the masked read bit for bit; decode_step as
tests/torch_model_parity.py's (logits cosine >= 0.9999 a step, every
cache leaf cosine >= 0.9999 with the reference's dtypes)."""
import torch_threads  # noqa: F401  (first: one intra-op thread)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro_torch.configs import get_arch
from repro_torch.models import layers
import torch_model_parity as h
from tests.conftest import make_mesh11

CUTS = {"deepseek_v2_lite": {},
        "gemma3_4b": dict(n_layers=4, window=2)}


@pytest.mark.parametrize("window", [0, 3])
def test_decode_attention_at_a_shared_position(window):
    """pos 0..9 of a 12-row cache, GQA 4 heads over 2: the scalar path
    (with a window, the reference's slice of the last `window` rows)
    against the reference, and bit for bit against the per-request path
    (every request at that position: the full cache, window-masked)."""
    r = np.random.default_rng(7)
    q = r.normal(size=(2, 1, 4, 16)).astype(np.float32)
    k = r.normal(size=(2, 12, 2, 16)).astype(np.float32)
    v = r.normal(size=(2, 12, 2, 16)).astype(np.float32)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    for pos in range(10):
        got = layers.decode_attention(tq, tk, tv, pos=pos, window=window)
        want = jlayers.decode_attention(*map(jnp.asarray, (q, k, v)),
                                        pos=jnp.int32(pos), window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
        masked = layers.decode_attention(tq, tk, tv, pos=torch.full(
            (2,), pos), window=window)
        assert torch.equal(got, masked), pos


@pytest.mark.parametrize("arch", list(CUTS))
def test_decode_step_stack_split_and_fallback_match_reference(arch):
    """4 tokens from init_cache at scalar positions 0-3 in fp8_flow, from
    the reference's init_params(key(0)) carried across."""
    jcfg = dataclasses.replace(jget_arch(arch).reduced(), **CUTS[arch])
    cfg = dataclasses.replace(get_arch(arch).reduced(), **CUTS[arch])
    jparams = jlm.init_params(jcfg, jax.random.key(0))
    mesh = make_mesh11()
    ref = dict(jcfg=jcfg, jparams=jparams, mesh=mesh,
               plan=jlm.ParallelPlan(mesh=mesh, dp_axes=("data",)))
    toks = h.decode_tokens(cfg)
    want, jcache, jdtypes = h.reference_decode(ref, "fp8_flow", toks)
    got, cache, dtypes = h.port_decode(
        arch, "fp8_flow", jax.tree.map(np.asarray, jparams), toks, cfg=cfg)
    assert sorted(cache) == sorted(jcache) == (
        ["dense_attn", "main_attn"] if cfg.moe else ["main_attn"])
    for g, w in zip(got, want):
        assert np.isfinite(g).all() and h.cos(g, w) >= 0.9999
    assert dtypes == jdtypes
    h.assert_cache_close(cache, jcache, 0.9999)
