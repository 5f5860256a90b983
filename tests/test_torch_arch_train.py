"""Training the port's dense layers and shared experts against the JAX
reference on the CPU: reduced() deepseek_v2_lite (a dense layer, then an
MoE layer with a shared expert) and qwen15_05b (every layer dense, QKV
bias, the tied embedding as lm_head), from the reference's
init_params(key(0)) carried across bit for bit, on one make_batch batch
of 8 x 64 tokens.

The reference is its whole-model forward on a 1x1 mesh, differentiated
with jax.value_and_grad under jit: the XLA route, the only one its train
step can take on this jax (ROADMAP.md, Queue 3), with remat off, as the
port runs.  Bars: the loss within 1e-3 relative; the cast ledger by
(kind, tag) the reference's (traced for differentiation, the reference
records each forward event twice, so a forward-only trace of it is
subtracted); every token the two route to other experts has a router
near-tie (``ROUTE_TIE``; tests/test_torch_serve.py's rule: torch and XLA
round bf16 differently, and a few of 512 tokens sit that close); and,
with the port routed as the reference routed (its expert ids fed in),
every leaf's gradient cosine >= 0.999 (as chip_smoke.py's GPU-vs-CPU
check; a leaf zero on both sides agrees).  Unforced, those few tokens
move the expert gradients to cosine ~0.997.  Then 20 train steps of
deepseek_v2_lite fp8_flow within 1% of the reference's loss at every
step (tests/test_torch_train_steps.py's bar, on one thread), and the
masked recipe's losses the padded recipe's bit for bit."""
import torch_threads  # noqa: F401  (first: one intra-op thread)
import dataclasses
import sys
from collections import Counter
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core import casts as jcasts
from repro.core import moe as jmoe
from repro.core.recipes import get_recipe as jget_recipe
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import make_batch as jmake_batch
from repro.models.lm import ParallelPlan
from repro.models.lm import forward as jforward
from repro.models.lm import init_params as jinit_params
from repro_torch.configs import get_arch
from repro_torch.core import casts
from repro_torch.core.recipes import get_recipe
from repro_torch.models.lm import forward
from repro_torch.optim.adamw import tree_leaves
from repro_torch.weights import params_from_numpy
from test_torch_archs import _named
from test_torch_train_steps import (_one_thread, _port_losses,
                                    _track_the_reference_loss)
from tests.conftest import make_mesh11

ROOT = Path(__file__).resolve().parents[1]
CASES = [(arch, name) for arch in ("deepseek_v2_lite", "qwen15_05b")
         for name in ("fp8_flow", "bf16")]
# The largest router gap (top_k-th minus next probability) at which a
# token may go to other experts in the port and the reference.  Measured
# on these batches: 6.3e-4 (deepseek_v2_lite fp8_flow, whose FP8 dense
# layer feeds the router; the XLA route rounds its SwiGLU product to
# bf16), 1.7e-5 (bf16).
ROUTE_TIE = 1e-3


def _cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na == 0.0 and nb == 0.0:
        return 1.0
    return float(a @ b / max(na * nb, 1e-300))


def _batch_np(cfg):
    return {k: np.asarray(v) for k, v in jmake_batch(
        JDataConfig(vocab=cfg.vocab, seq_len=64, global_batch=8), 0).items()}


def _reference(arch, name, cut=None):
    """(loss, grads by path, params, batch, ledger by tag, the expert ids
    of each router call) of the reference's jitted value_and_grad, on
    reduced() with the fields of `cut` replaced."""
    jcfg = dataclasses.replace(jget_arch(arch).reduced(), remat_policy="none",
                               **(cut or {}))
    params = jinit_params(jcfg, jax.random.key(0))
    batch = _batch_np(jcfg)
    mesh = make_mesh11()
    plan = ParallelPlan(mesh=mesh, dp_axes=("data",))
    router_topk, ids = jmoe.router_topk, []

    def recorded(x, w_router, top_k):
        out = router_topk(x, w_router, top_k)
        jax.debug.callback(lambda i: ids.append(np.asarray(i)), out[1])
        return out

    def loss_fn(p, b):
        return jforward(jcfg, jget_recipe(name), plan, p, b)[0]

    with pytest.MonkeyPatch.context() as mp, mesh:
        mp.setattr(jmoe, "router_topk", recorded)
        with jcasts.ledger() as fwd:
            jax.eval_shape(loss_fn, params, batch)
        with jcasts.ledger() as full:
            loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, batch)
            jax.block_until_ready(grads)
    # traced for differentiation, the forward records its events twice
    # (the primal and each custom VJP's forward rule): one forward and the
    # backward are the full trace less a forward-only trace
    led = Counter(full.by_tag())
    led.subtract(fwd.by_tag())
    assert all(n >= 0 for n in led.values()), led
    return (float(loss), _named(jax.tree.map(np.asarray, grads)),
            jax.tree.map(np.asarray, params), batch, +led, ids)


def _port(arch, recipe, params_np, batch_np, ids_by_call=None, cut=None):
    """(loss, grads by path, ledger by tag, [(ids, gaps)] a router call),
    routed by its own router or, with `ids_by_call`, to those expert ids
    (chip_smoke.routed: the port's router with only its top-k replaced,
    the helper chip_smoke.py's GPU-vs-CPU check uses)."""
    sys.path.insert(0, str(ROOT))
    from chip_smoke import routed
    cfg = dataclasses.replace(get_arch(arch).reduced(), **(cut or {}))
    params = params_from_numpy(params_np, device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_()
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    forced = None if ids_by_call is None else [
        torch.from_numpy(np.asarray(i)).long() for i in ids_by_call]
    with routed(forced) as calls, casts.ledger() as led:
        loss, _ = forward(cfg, recipe, params, batch)
        loss.backward()
    grads = {path: p.grad.to(torch.float32).numpy()
             for path, p in _named(params).items()}
    return float(loss.detach()), grads, led.by_tag(), [
        (ids.numpy(), gaps.numpy()) for ids, gaps in calls]


@pytest.mark.parametrize("arch,name", CASES)
def test_loss_grads_and_ledger_match_reference(arch, name):
    ref_loss, ref_grads, params_np, batch_np, jled, ref_ids = \
        _reference(arch, name)
    loss, grads, led, calls = _port(arch, get_recipe(name), params_np,
                                    batch_np)
    assert np.isfinite(loss)
    assert abs(loss - ref_loss) / abs(ref_loss) <= 1e-3, (loss, ref_loss)
    # the tokens routed to other experts than the reference's, and their gaps
    cfg = get_arch(arch).reduced()
    assert len(calls) == len(ref_ids) == (cfg.n_layers - cfg.n_dense_layers
                                          if cfg.moe else 0)
    for (ids, gaps), rid in zip(calls, ref_ids):
        moved = (np.sort(ids, -1) != np.sort(rid, -1)).any(-1)
        assert (gaps[moved] < ROUTE_TIE).all(), gaps[moved]
    # the reference traces each scanned stack once (one layer); the port
    # records every layer: the DeepSeek stacks hold one layer each
    per_stack = 1 if cfg.moe else cfg.n_layers

    def outer(ledger, n=1):
        """The events less the XLA route's unfused inner quantizes."""
        return {k: v * n for k, v in ledger.items()
                if not k[0].endswith("_inner")}

    assert outer(led) == outer(jled, per_stack)
    if cfg.moe:                     # the gradients, routed as the reference
        loss, grads, _, _ = _port(arch, get_recipe(name), params_np,
                                  batch_np, ref_ids)
        assert abs(loss - ref_loss) / abs(ref_loss) <= 1e-3, (loss, ref_loss)
    assert grads.keys() == ref_grads.keys()
    low = {p: _cos(grads[p], ref_grads[p]) for p in grads}
    low = {p: c for p, c in low.items() if not c >= 0.999}
    assert not low, low
    # the MLP and expert leaves of every kind carry a gradient
    mlp = (["dense_layers/w13", "dense_layers/w2", "layers/we13",
            "layers/we2", "layers/ws13", "layers/ws2", "layers/w_router"]
           if cfg.moe else ["layers/w13", "layers/w2", "layers/bq", "embed"])
    assert all(np.abs(ref_grads[p]).max() > 0 for p in mlp), mlp


@pytest.mark.parametrize("arch", ["deepseek_v2_lite", "qwen15_05b"])
def test_fp8_flow_activation_casts_per_layer_kind(arch):
    """fp8_flow's two activation casts an FP8 MLP a step (the entry
    quantize and the backward island quantize, nothing else explicit): a
    dense layer 2, an MoE layer with a shared expert 4 (the routed
    block's 2 and the shared expert's 2)."""
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models.lm import init_params
    cfg = get_arch(arch).reduced()
    params = init_params(cfg, seed=0, device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_()
    batch = make_batch(DataConfig(vocab=cfg.vocab, seq_len=64,
                                  global_batch=8), 0, device="cpu")
    with casts.ledger() as led:
        forward(cfg, get_recipe("fp8_flow"), params, batch)[0].backward()
    nd = cfg.n_dense_layers if cfg.moe else cfg.n_layers
    n_moe = cfg.n_layers - nd
    assert led.activation_casts() == 2 * nd + 4 * n_moe, led.summary()
    by = led.by_tag()
    assert by[("quantize", "q_entry")] == by[("quantize", "q_bwd_island")] \
        == nd + 2 * n_moe
    assert not [e for e in led.events if e.kind == "dequantize"]


def test_twenty_steps_deepseek_v2_lite_track_the_reference_loss():
    """20 steps of fp8_flow within 1% of the reference at every step (one
    thread); the masked recipe's 20 losses the padded recipe's bit for
    bit."""
    padded, params_np = _track_the_reference_loss(
        "fp8_flow", _one_thread, arch="deepseek_v2_lite")
    masked = _port_losses(
        get_recipe("fp8_flow", masked_experts=True, swiglu_epilogue=True),
        params_np, "deepseek_v2_lite", _one_thread)
    assert masked == padded
