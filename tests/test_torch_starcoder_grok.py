"""starcoder2_15b (an ungated GELU MLP, LayerNorm with biases, QKV bias)
and grok1_314b (8 GeGLU experts, top-2, no dense layer) served against
the JAX reference on the CPU at reduced() size, with the reference's
init_params(key(0)) carried across bit for bit: the trees and W8 trees,
teacher-forced logits against routes A and B, and route A's prefill cast
ledger, to tests/test_torch_gemma.py's bars (which are
tests/test_torch_archs.py's).  grok's masked recipe (#5 GEMM-1, the
GeGLU, #1; no fused epilogue) serves the padded recipe's logits bit for
bit, and grok's block kind, a GeGLU MoE block, matches the reference's in
every recipe.  The four configs equal the reference's; the last four
still raise."""
import torch_threads  # noqa: F401  (first: one intra-op thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core import casts as jcasts
from repro.core import recipes as jrecipes
from repro.core.moe import MoEConfig as JMoEConfig
from repro.core.moe import moe_block as jmoe_block
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.core import casts, recipes
from repro_torch.core.moe import MoEConfig, moe_block
from repro_torch.core.recipes import get_recipe
from repro_torch.serve.w8 import quantize_params_for_serving
from test_cast_count import EXPECTED_MOE
from test_torch_gemma import (check_ledger, check_logits, check_trees,
                              serve_case)
from test_torch_recipes import NAMES, _cos, _events, _np32, _t
from test_torch_serve import _port_teacher_forced


@pytest.fixture(scope="module", params=["starcoder2_15b", "grok1_314b"])
def served(request):
    return serve_case(request.param)


def test_trees_carry_across_bitwise(served):
    check_trees(served)


@pytest.mark.parametrize("route", ["A", "B"])
def test_teacher_forced_logits_match_reference(served, route):
    check_logits(served, route)


def test_prefill_cast_ledger_matches_reference(served):
    check_ledger(served)


def test_masked_recipe_serves_the_padded_logits(served):
    """The masked recipe's served logits are the padded recipe's bit for
    bit (a dense config takes the padded kernels for its MLPs)."""
    params = quantize_params_for_serving(served["params"])
    masked, _, _ = _port_teacher_forced(
        served["cfg"], params, served["toks"],
        recipe=get_recipe("fp8_flow", masked_experts=True,
                          swiglu_epilogue=True))
    padded, _, _ = served["port"]
    for a, b in zip(masked, padded):
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("arch", ["starcoder2_15b", "gemma3_4b", "gemma2_9b",
                                  "grok1_314b", "llava_next_34b",
                                  "seamless_m4t_v2", "mamba2_27b",
                                  "hymba_15b"])
def test_config_is_the_reference_config(arch):
    """The configs are registered and equal the reference's, field for
    field, with the same derived SSM sizes and parameter count (full and
    reduced)."""
    assert arch in ARCH_IDS
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    assert vars(cfg) == vars(jcfg)
    for c, j in ((cfg, jcfg), (cfg.reduced(), jcfg.reduced())):
        assert (c.d_inner, c.ssm_heads, c.n_params()) == \
            (j.d_inner, j.ssm_heads, j.n_params())


@pytest.mark.parametrize("name", NAMES)
def test_geglu_moe_block_matches_reference(name):
    """grok1_314b's block kind, a GeGLU MoE block at EP = 1 (the reference's
    local path), forward and backward, as tests/test_torch_recipes.py holds
    the SwiGLU block: output and every gradient cosine >= 0.999, the cast
    ledger event for event, EXPECTED_MOE activation casts (0 / 8 / 12 / 2)."""
    E, Dm, Fm, T = 4, 256, 128, 256
    r = np.random.default_rng(1)
    inputs = (jnp.asarray(r.normal(size=(T, Dm)).astype(np.float32)
                          ).astype(jnp.bfloat16),
              jnp.asarray(r.normal(size=(Dm, E)).astype(np.float32) * 0.02),
              jnp.asarray(r.normal(size=(E, Dm, 2 * Fm)).astype(np.float32)
                          * 0.05),
              jnp.asarray(r.normal(size=(E, Fm, Dm)).astype(np.float32)
                          * 0.05))
    kw = dict(n_experts=E, top_k=2, d_model=Dm, d_ff=Fm, act="geglu")
    jcfg = JMoEConfig(ep_axis=None, dp_axes=(), **kw)

    def fwd(*a):
        return jmoe_block(jrecipes.get_recipe(name), jcfg, *a)[0]

    with jcasts.ledger() as jled:
        y, vjp = jax.vjp(fwd, *inputs)
        jg = vjp((2 * y.astype(jnp.float32)).astype(y.dtype))
    ref = [np.asarray(y, np.float32)] + [np.asarray(g, np.float32)
                                         for g in jg]
    ts = [_t(a).requires_grad_() for a in inputs]
    with casts.ledger() as led:
        yt, _ = moe_block(recipes.get_recipe(name), MoEConfig(**kw), *ts)
        yt.backward((2 * yt.detach().to(torch.float32)).to(yt.dtype))
    got = [_np32(yt)] + [_np32(t.grad) for t in ts]
    for what, a, b in zip(("y", "gx", "gwr", "gw13", "gw2"), got, ref):
        assert np.isfinite(a).all() and np.abs(a).max() > 0, what
        assert _cos(a, b) >= 0.999, (what, _cos(a, b))
    assert _events(led) == _events(jled)
    assert led.activation_casts() == EXPECTED_MOE[name]
