"""The port's training slice against the JAX reference on the CPU: the
fp8_flow expert FFN's hand-written backward (gradients and cast ledger)
against the reference's Pallas route (``Recipe(use_pallas=True)``,
interpret mode, no mesh), the MoE block's two activation casts, the cross
entropy, AdamW and its schedule, the data pipeline, and the launcher.

Tolerances: FFN gradients cosine >= 0.999 (the reference rounds the same
FP8 operands, but its f32 sums run in another order and its sigmoid bits
differ on a fraction of a percent of lanes); the cross entropy and AdamW
to f32 rounding (rtol 1e-5 / 1e-6: reduction order), the bf16 dlogits to
one bf16 rounding (rtol 1e-2); tokens, schedules and the ledger exactly.  The 20-step whole-run comparison is in
tests/test_torch_train_steps.py."""
import torch_threads  # noqa: F401  (first: one intra-op thread)
import dataclasses
import os
import subprocess
import sys
from collections import Counter
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import casts as jcasts
from repro.core.linear import expert_ffn as jexpert_ffn
from repro.core.linear import quantize_entry as jquantize_entry
from repro.core.recipes import get_recipe as jget_recipe
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import make_batch as jmake_batch
from repro.models.lm import _xent as jxent
from repro.optim import adamw as jadamw
from repro.optim.schedules import warmup_cosine as jwarmup_cosine
from repro_torch.core import casts
from repro_torch.core.linear import expert_ffn, quantize_entry
from repro_torch.core.moe import MoEConfig, moe_block
from repro_torch.core.recipes import Recipe, get_recipe
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.models.lm import xent
from repro_torch.optim import adamw
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.train.train_step import make_train_step
from repro_torch.weights import tensor_from_numpy

ROOT = Path(__file__).resolve().parents[1]


def _t(a):
    return tensor_from_numpy(np.asarray(a), device="cpu")


def _cos(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


def _ffn_inputs():
    """tests/test_cast_count.py's _ffn_loss setup."""
    r = np.random.default_rng(0)
    E, C, K, F = 2, 128, 256, 128
    x = jnp.asarray(r.normal(size=(E, C, K)).astype(np.float32)
                    ).astype(jnp.bfloat16)
    w13 = jnp.asarray(r.normal(size=(E, K, 2 * F)).astype(np.float32) * 0.05)
    w2 = jnp.asarray(r.normal(size=(E, F, K)).astype(np.float32) * 0.05)
    return x, w13, w2


def _reference_ffn():
    recipe = dataclasses.replace(jget_recipe("fp8_flow"), use_pallas=True)

    def L(x, w13, w2):
        y = jexpert_ffn(recipe, "swiglu", (), (),
                        jquantize_entry(recipe, x), w13, w2)
        return jnp.sum(y.astype(jnp.float32) ** 2)

    with jcasts.ledger() as led:
        grads = jax.grad(L, argnums=(0, 1, 2))(*_ffn_inputs())
    return [np.asarray(g, np.float32) for g in grads], led


def _port_ffn():
    x, w13, w2 = (_t(a).requires_grad_() for a in _ffn_inputs())
    with casts.ledger() as led:
        y = expert_ffn(get_recipe("fp8_flow"), "swiglu",
                       quantize_entry(get_recipe("fp8_flow"), x), w13, w2)
        (y.to(torch.float32) ** 2).sum().backward()
    grads = [t.grad.to(torch.float32).numpy() for t in (x, w13, w2)]
    return grads, led


def test_expert_ffn_grads_match_reference_pallas_route():
    ref, _ = _reference_ffn()
    got, _ = _port_ffn()
    for name, a, b in zip(("gx", "wg13", "wg2"), got, ref):
        assert a.shape == b.shape
        assert np.isfinite(a).all()
        assert _cos(a, b) >= 0.999, (name, _cos(a, b))


def test_expert_ffn_cast_ledger_matches_reference():
    """The same multiset of (kind, tag) events as the reference's Pallas
    route, and the paper's count: 2 activation casts (the entry quantize
    and the backward island quantize)."""
    _, jled = _reference_ffn()
    _, led = _port_ffn()
    assert Counter(led.by_tag()) == Counter(jled.by_tag()), led.summary()
    assert led.activation_casts() == 2
    assert ("quantize", "q_bwd_island") in led.by_tag()


def test_moe_block_fwd_bwd_two_activation_casts():
    """tests/test_cast_count.py's MoE block (E=4, D=256, F=128, top-2,
    T=256): forward + backward records EXPECTED_MOE['fp8_flow'] = 2, and
    every parameter and the input get a finite gradient."""
    E, D, F, topk, T = 4, 256, 128, 2, 256
    cfg = MoEConfig(n_experts=E, top_k=topk, d_model=D, d_ff=F)
    r = np.random.default_rng(1)
    x = torch.from_numpy(r.normal(size=(T, D)).astype(np.float32)).to(
        torch.bfloat16).requires_grad_()
    wr = torch.from_numpy(r.normal(size=(D, E)).astype(np.float32) * 0.1
                          ).requires_grad_()
    w13 = torch.from_numpy(r.normal(size=(E, D, 2 * F)).astype(np.float32)
                           * 0.05).to(torch.bfloat16).requires_grad_()
    w2 = torch.from_numpy(r.normal(size=(E, F, D)).astype(np.float32)
                          * 0.05).to(torch.bfloat16).requires_grad_()
    with casts.ledger() as led:
        y, m = moe_block(get_recipe("fp8_flow"), cfg, x, wr, w13, w2)
        ((y.to(torch.float32) ** 2).sum() + m["aux_loss"]).backward()
    assert led.activation_casts() == 2, led.summary()
    for t in (x, wr, w13, w2):
        assert t.grad is not None and torch.isfinite(t.grad).all()
        assert t.grad.abs().sum() > 0


@pytest.mark.parametrize("step", [0, 3, 2 ** 20 + 5])
@pytest.mark.parametrize("seed", [0, 7])
def test_make_batch_tokens_bitwise(step, seed):
    jb = jmake_batch(JDataConfig(vocab=151936, seq_len=64, global_batch=4,
                                 seed=seed), step)
    b = make_batch(DataConfig(vocab=151936, seq_len=64, global_batch=4,
                              seed=seed), step, device="cpu")
    for k in ("tokens", "targets", "mask"):
        assert np.array_equal(b[k].numpy(), np.asarray(jb[k])), k


def test_xent_value_and_grad_match_reference():
    r = np.random.default_rng(2)
    B, S, V = 2, 8, 512
    logits = jnp.asarray(r.normal(size=(B, S, V)).astype(np.float32) * 3
                         ).astype(jnp.bfloat16)
    tg = jnp.asarray(r.integers(0, V, (B, S)).astype(np.int32))
    mask = jnp.asarray((r.random((B, S)) > 0.2).astype(np.float32))
    lj, gj = jax.value_and_grad(jxent)(logits, tg, mask)
    lt = _t(logits).requires_grad_()
    loss = xent(lt, _t(tg), _t(mask))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(lj), rtol=1e-5)
    np.testing.assert_allclose(lt.grad.to(torch.float32).numpy(),
                               np.asarray(gj, np.float32), rtol=1e-2,
                               atol=1e-6)


def test_adamw_update_matches_reference():
    """Two updates of a small tree (bf16 and f32 leaves, with clipping)
    against the reference's apply_updates."""
    r = np.random.default_rng(3)
    shapes = {"a": (4, 130), "b": {"c": (7,), "d": (3, 5, 6)}}

    def tree(fn):
        return jax.tree.map(fn, shapes, is_leaf=lambda s: isinstance(s, tuple))

    params = tree(lambda s: jnp.asarray(r.normal(size=s).astype(np.float32)
                                        ).astype(jnp.bfloat16))
    params["b"]["c"] = params["b"]["c"].astype(jnp.float32)
    grads = [jax.tree.map(lambda p: jnp.asarray(
        r.normal(size=p.shape).astype(np.float32) * 2).astype(p.dtype),
        params) for _ in range(2)]
    jopt = jadamw.AdamWConfig(lr=1e-2)
    jstate = jadamw.init_state(jopt, params)
    opt = adamw.AdamWConfig(lr=1e-2)
    tparams = jax.tree.map(_t, params)
    state = adamw.init_state(opt, tparams)
    jp = params
    for i, g in enumerate(grads):
        jp, jstate, jm = jadamw.apply_updates(jopt, jp, g, jstate,
                                              lr_scale=0.5)
        m = adamw.apply_updates(opt, tparams, jax.tree.map(_t, g), state,
                                lr_scale=0.5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
    for a, b in zip(adamw.tree_leaves(tparams), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.to(torch.float32).numpy(),
                                   np.asarray(b, np.float32), rtol=1e-6,
                                   atol=1e-6)
    for a, b in zip(adamw.tree_leaves(state["master"]),
                    jax.tree.leaves(jstate["master"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    assert state["step"] == int(jstate["step"]) == 2


@pytest.mark.parametrize("step", [0, 1, 9, 10, 50, 399, 500])
def test_warmup_cosine_matches_reference(step):
    got = warmup_cosine(step, warmup_steps=10, total_steps=400)
    ref = jwarmup_cosine(jnp.int32(step), warmup_steps=10, total_steps=400)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


def test_unported_training_options_raise():
    from repro_torch.configs import get_arch
    cfg = get_arch("qwen3_moe_235b").reduced()
    opt = adamw.AdamWConfig()
    recipe = get_recipe("fp8_flow")
    for kw in ({"dist": object()}, {"guard": object()}, {"grad_accum": 2}):
        with pytest.raises(NotImplementedError, match="Queue 1"):
            make_train_step(cfg, recipe, opt, **kw)
    with pytest.raises(NotImplementedError, match="Queue 1"):
        Recipe(save_h=True)
    with pytest.raises(NotImplementedError, match="Queue 1"):
        adamw.AdamWConfig(state_policy=object())


def test_train_launcher_refuses_unported_arch():
    """Every config is ported; the launcher refuses the one its batches
    cannot feed: seamless_m4t_v2's encoder needs an input make_batch does
    not make (the reference launcher raises KeyError there)."""
    from repro_torch.launch.train import main
    with pytest.raises(ValueError, match="enc_input"):
        main(["--arch", "seamless_m4t_v2", "--reduced", "--device", "cpu",
              "--steps", "1"])


def test_train_launcher_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
         "--device", "cpu", "--steps", "2", "--seq-len", "64",
         "--global-batch", "4"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "[train] done" in out.stdout
