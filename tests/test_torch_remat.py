"""The activation-residency plan (``repro_torch.train.memory``) against
the reference's (``repro.train.memory``, spec ``tests/test_remat.py``) on
the CPU: the plan's structure and aliases, the port's single checkpoint
site, policy parity, the FP8 residency invariant of the paper's memory
claim, the bytes model, and the cast ledger under every policy.

Policy parity.  The port recomputes with the same kernels (their twins
here) and plain ops, so every policy gives the loss and every gradient
leaf of 'none' bit for bit: a stricter bar than the reference's 1e-6 /
1e-5 (``tests/test_remat.py``).  Against the reference under the same
policy (jax.checkpoint with its save_only_these_names policies, on a 1x1
mesh, which this jax takes) the bars are tests/test_torch_arch_train.py's:
the loss within 1e-3 relative and every leaf's gradient cosine >= 0.999,
the port routed as the reference routed (its expert ids recorded from its
'none' run: every reference policy computes the same forward).

Residency (qwen3_moe_235b.reduced(), one MoE layer, 4 x 128 tokens): the
saved set is what autograd keeps outside a checkpoint, the block's stash
and its held arguments (``memory.saved_residuals``), classified into the
reference's buckets; 'fp8_resident' keeps no wide bf16 tensor and some
e4m3, 'full' at least 3x its bytes, and ``layer_saved_bytes_model`` <=
measured <= 4x the model for both, as tests/test_remat.py asks."""
import torch_threads  # noqa: F401  (first: one intra-op thread)
import dataclasses
import functools
import os
import re
from collections import Counter
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
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
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.guards import GuardPlan
from repro_torch.train.memory import (POLICIES, MemoryPlan,
                                      layer_saved_bytes_model,
                                      measure_layer_residuals)
from repro_torch.train.train_step import init_train_state, make_train_step
from test_torch_arch_train import _cos, _port
from test_torch_archs import _named
from tests.conftest import make_mesh11

ROOT = Path(__file__).resolve().parents[1]
ARCH = "deepseek_v2_lite"


# ---------------------------------------------------------------------------
# Structure, aliases, and the single checkpoint site.
# ---------------------------------------------------------------------------
def test_plan_structure_and_aliases():
    assert MemoryPlan("pair").block_size == 2
    assert MemoryPlan("full").block_size == 1
    assert MemoryPlan("pair").layer_blocks(5) == ((0, 1), (2, 3), (4,))
    assert MemoryPlan("full").layer_blocks(3) == ((0,), (1,), (2,))
    assert MemoryPlan("pair").blocks_of("abcde") == (("a", "b"), ("c", "d"),
                                                     ("e",))
    assert MemoryPlan("pair").group_factor(4) == 2
    assert MemoryPlan("pair").group_factor(3) == 1
    # the legacy bool spelling, on the plan and on the config
    assert MemoryPlan(True).policy == "full"
    assert MemoryPlan(False).policy == "none"
    cfg = get_arch("qwen15_05b").reduced()
    assert dataclasses.replace(cfg, remat_policy=False).remat_policy == "none"
    assert cfg.remat is True
    assert MemoryPlan.from_config(cfg).policy == "full"
    with pytest.raises(ValueError, match="remat policy"):
        MemoryPlan("selective")

    def f(x):
        return x
    assert MemoryPlan("none").wrap(f) is f


def test_torch_checkpoint_only_in_memory():
    """train/memory.py holds the port's one torch.utils.checkpoint call
    (tests/test_torch_import.py holds the port to no jax and no repro)."""
    files = sorted(Path(ROOT, "src", "repro_torch").rglob("*.py")) + \
        sorted(ROOT.glob("chip_*.py"))
    hits = [str(p.relative_to(ROOT)) for p in files
            if re.search(r"checkpoint\.checkpoint\(", p.read_text())]
    assert hits == [os.path.join("src", "repro_torch", "train", "memory.py")]


# ---------------------------------------------------------------------------
# Policy parity: against 'none' bit for bit, against the reference under
# the same policy at the arch-train bars.
# ---------------------------------------------------------------------------
@functools.cache
def _reference(policy):
    """(loss, grads by path, params, batch, router ids: recorded in the
    'none' run only) of the reference's jitted value_and_grad on
    deepseek_v2_lite.reduced() under `policy`, fp8_flow, one 8 x 64
    make_batch batch."""
    jcfg = dataclasses.replace(jget_arch(ARCH).reduced(), remat_policy=policy)
    params = jinit_params(jcfg, jax.random.key(0))
    batch = {k: np.asarray(v) for k, v in jmake_batch(
        JDataConfig(vocab=jcfg.vocab, seq_len=64, global_batch=8), 0).items()}
    mesh = make_mesh11()
    plan = ParallelPlan(mesh=mesh, dp_axes=("data",))
    router_topk, ids = jmoe.router_topk, []

    def recorded(x, w_router, top_k):
        out = router_topk(x, w_router, top_k)
        jax.debug.callback(lambda i: ids.append(np.asarray(i)), out[1])
        return out

    def loss_fn(p, b):
        return jforward(jcfg, jget_recipe("fp8_flow"), plan, p, b)[0]

    with pytest.MonkeyPatch.context() as mp, mesh:
        if policy == "none":
            mp.setattr(jmoe, "router_topk", recorded)
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, batch)
        jax.block_until_ready(grads)
    return (float(loss), _named(jax.tree.map(np.asarray, grads)),
            jax.tree.map(np.asarray, params), batch, ids)


@functools.cache
def _port_under(policy, forced=True):
    """The port's loss, grads by path and ledger under `policy`, from the
    reference's params and batch, routed as the reference routed (or by
    its own router)."""
    _, _, params, batch, ids = _reference("none")
    return _port(ARCH, get_recipe("fp8_flow"), params, batch,
                 ids if forced else None, cut={"remat_policy": policy})


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_matches_reference_under_the_same_policy(policy):
    jloss, jgrads = _reference(policy)[:2]
    loss, grads, _, _ = _port_under(policy)
    assert abs(loss - jloss) <= 1e-3 * abs(jloss), (loss, jloss)
    low = {path: _cos(grads[path], jgrads[path]) for path in jgrads}
    assert min(low.values()) >= 0.999, sorted(low.items(),
                                              key=lambda kv: kv[1])[:3]


@pytest.mark.parametrize("policy", [p for p in POLICIES if p != "none"])
def test_policies_agree_bitwise(policy):
    """Losses, every gradient leaf and the cast ledger of each policy are
    'none''s to the bit, on the port's own routing."""
    l0, g0, led0, _ = _port_under("none", forced=False)
    loss, grads, led, _ = _port_under(policy, forced=False)
    assert loss == l0
    assert grads.keys() == g0.keys()
    for path in g0:
        np.testing.assert_array_equal(grads[path], g0[path], err_msg=path)
    assert led == led0


# ---------------------------------------------------------------------------
# The residency invariant and the bytes ordering (the memory claim).
# ---------------------------------------------------------------------------
@functools.cache
def _layer_residuals(policy, batch=4, seq=128):
    return measure_layer_residuals(get_arch("qwen3_moe_235b").reduced(),
                                   get_recipe("fp8_flow"), policy,
                                   batch=batch, seq=seq)


def _act(c):
    return c["fp8"] + c["scale"] + c["wide_bf16"] + c["small"]


def test_fp8_resident_saves_nothing_wide_in_bf16():
    cls = _layer_residuals("fp8_resident")
    assert cls["wide_bf16"] == 0, cls
    assert cls["fp8"] > 0, cls               # qx / qa payloads are kept
    cls_full = _layer_residuals("full")
    assert cls_full["wide_bf16"] > 0, cls_full
    assert _act(cls_full) >= 3.0 * _act(cls), (cls_full, cls)
    # 'none' keeps more than 'full', 'pair' only the block's input
    assert _act(_layer_residuals("none")) > _act(cls_full)
    assert _act(_layer_residuals("pair")) == 0


@pytest.mark.parametrize("policy", ["full", "fp8_resident"])
def test_bytes_model_tracks_measurement(policy):
    cfg = get_arch("qwen3_moe_235b").reduced()
    model = layer_saved_bytes_model(cfg, 4 * 128, policy)
    act = _act(_layer_residuals(policy))
    assert model <= act <= 4.0 * model, (policy, model, act)


# FFN GEMMs in a block's recompute: 'full' keeps h and the expert output,
# so its recompute launches neither GEMM-1 nor GEMM-2; 'fp8_resident'
# keeps qa, so GEMM-2 alone; 'pair' keeps nothing, so both; 'none' has no
# recompute.
RECOMPUTED_GEMMS = {"none": 0, "full": 0, "fp8_resident": 1, "pair": 2}


@pytest.mark.parametrize("policy", POLICIES)
def test_recompute_launches_no_gemm_whose_output_was_kept(policy,
                                                          monkeypatch):
    """One MoE layer of qwen3_moe_235b.reduced() (fp8_flow), forward and
    backward: the grouped GEMMs its recompute runs, and the gradients
    'none''s bit for bit."""
    from repro_torch.core import linear, quant
    from repro_torch.models.lm import first_layer, init_params
    from repro_torch.train.memory import layer_loss
    cfg = get_arch("qwen3_moe_235b").reduced()
    recipe = get_recipe("fp8_flow")
    ggemm, n = linear._ggemm, Counter()

    def counted(*a, **k):
        st = quant._RESIDENCY.get()
        n["recompute" if st is not None and st.cursor is not None
          else "other"] += 1
        return ggemm(*a, **k)

    monkeypatch.setattr(linear, "_ggemm", counted)

    def grads(pol):
        params = init_params(cfg, seed=0, device="cpu")
        kind, moe_layer, p = first_layer(cfg, params)
        leaves = [p[k] for k in sorted(p)]
        for t in leaves:
            t.requires_grad_()
        x = torch.full((2, 32, cfg.d_model), 0.1, dtype=torch.bfloat16,
                       requires_grad=True)
        f = MemoryPlan(pol).wrap(layer_loss(cfg, recipe, kind, moe_layer))
        f(p, x).backward()
        return [t.grad for t in leaves + [x]]

    want = grads("none")
    n.clear()
    got = grads(policy)
    assert n["recompute"] == RECOMPUTED_GEMMS[policy], n
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The train step under every policy: casts, accumulation, the guard.
# ---------------------------------------------------------------------------
def _train(policy, steps, grad_accum=1, guard=None):
    cfg = dataclasses.replace(get_arch(ARCH).reduced(), remat_policy=policy)
    opt = AdamWConfig(lr=1e-3)
    state = init_train_state(cfg, opt, device="cpu", guard=guard)
    step = make_train_step(cfg, get_recipe("fp8_flow"), opt,
                           grad_accum=grad_accum, total_steps=10,
                           warmup_steps=2, guard=guard)
    data = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4)
    out = []
    for i in range(steps):
        batch = make_batch(data, i, device="cpu")
        if grad_accum > 1:
            batch = {k: v.reshape(grad_accum, -1, *v.shape[1:])
                     for k, v in batch.items()}
        with casts.ledger() as led:
            state, m = step(state, batch)
        out.append((float(m["loss"]), int(m.get("guard_flags", -1)),
                    Counter(led.by_tag())))
    return out


@pytest.mark.parametrize("policy", POLICIES)
def test_cast_tags_and_counts_under_every_policy(policy):
    """The only explicit activation casts are the entry quantize and the
    backward island quantize, no dequantize materializes, and a recompute
    adds no record: the counts are 'none''s."""
    (_, _, led), = _train(policy, 1)
    tags = {t for (k, t) in led if k in ("quantize", "dequantize")
            and not t.startswith("q_w")}
    assert tags == {"q_entry", "q_bwd_island"}, led
    assert not [k for (k, _) in led if k == "dequantize"], led
    assert led == _train("none", 1)[0][2]


@functools.cache
def _guarded_accum(policy):
    return [(loss, flags) for loss, flags, _ in
            _train(policy, 2, grad_accum=2, guard=GuardPlan())]


@pytest.mark.parametrize("policy", [p for p in POLICIES if p != "none"])
def test_train_step_with_accumulation_and_guard(policy):
    got, want = _guarded_accum(policy), _guarded_accum("none")
    assert all(np.isfinite(loss) and flags == 0 for loss, flags in want)
    assert got == want
