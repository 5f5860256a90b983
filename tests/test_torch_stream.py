"""The streaming FP8 DP wire over the layer-aligned layout
(``DistPlan(schedule='stream')``), held to the reference's layout and
probe and to the invariants its tests state (tests/test_dist.py:365-620,
tests/test_cast_count.py:144 and :187, which the reference itself fails
under jax 0.9 here: ROADMAP.md, Queue 3).

- The layered layout equals ``repro.dist.build_layout(params,
  DistPlan(schedule='stream'))`` slot for slot on reduced deepseek_v2_lite
  and qwen15_05b, and its flat space round-trips every layer slice.
- ``streaming_fallback_reason`` is the reference's for all twelve
  configs.
- At world 2 on gloo ranks: stream equals posthoc over the same layered
  layout bit for bit (losses and every parameter, 5 steps; so also within
  the reference's rtol 1e-3 / atol 2e-2), with grad_accum = 2 too, where
  a step sends one reduce-scatter a bucket; the fp8 stream tracks the f32
  stream within 1% over 20 steps; the first reduce-scatter is issued
  before the last backward GEMM (the post-hoc wire's after it); 2
  activation casts a MoE block under every remat policy; a flipped wire
  byte is flagged and recovered under stream.
"""
import torch_threads  # noqa: F401  (first: one intra-op thread)

import jax
import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from repro.configs import get_arch as jget_arch
from repro.dist import plan as jplan
from repro.models.lm import init_params as jinit_params
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.dist import plan
from repro_torch.dist.opt_state import StatePolicy
from repro_torch.train.guards import WIRE_SCALE
from repro_torch.weights import params_from_numpy
from torch_dist_harness import run_ranks

STREAM = dict(schedule="stream")
LAYERED = dict(layered=True)
F32 = StatePolicy(m="f32", v="f32", master="f32")


def _tree(arch):
    cfg = jget_arch(arch).reduced()
    jp = jinit_params(cfg, jax.random.key(0))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.mark.parametrize("arch", ["deepseek_v2_lite", "qwen15_05b"])
@pytest.mark.parametrize("bucket_mb", [4.0, 0.01])
def test_layered_layout_equals_the_reference(arch, bucket_mb):
    """build_layout with schedule='stream' on the reference's init_params
    tree (carried across bit for bit): every bucket's (stack, layer) and
    padded rows, every slot's index, path, offset, rows, size and layer,
    the sensitive leaves with their stack tags, in order; then every
    layered slot's layer slice round-trips through the flat space."""
    jp, tp = _tree(arch)
    a = plan.build_layout(tp, plan.DistPlan(bucket_mb=bucket_mb, **STREAM))
    b = jplan.build_layout(jp, jplan.DistPlan(bucket_mb=bucket_mb, **STREAM))
    assert a.n_leaves == b.n_leaves
    assert [(s.index, s.path, s.stack) for s in a.sensitive] == \
        [(s.index, s.path, s.stack) for s in b.sensitive]
    assert len(a.buckets) == len(b.buckets) and a.buckets
    for x, y in zip(a.buckets, b.buckets):
        assert (x.rows, x.stack, x.layer) == (y.rows, y.stack, y.layer)
        assert [(s.index, s.path, s.offset_rows, s.rows, s.size, s.layer)
                for s in x.slots] == \
            [(s.index, s.path, s.offset_rows, s.rows, s.size, s.layer)
             for s in y.slots]
    assert all(bk.layer is not None for bk in a.buckets)
    leaves = plan.tree_leaves(tp)
    seen = set()
    for bk in a.buckets:
        back = plan.bucket_scatter(bk, plan.bucket_flat(bk, leaves), leaves)
        for (i, layer), t in back.items():
            assert torch.equal(t, leaves[i][layer])
            seen.add((i, layer))
    assert len(seen) == sum(len(bk.slots) for bk in a.buckets)


@pytest.mark.parametrize("arch", sorted(ARCH_IDS))
def test_streaming_fallback_reason_is_the_references(arch):
    """The probe on the config alone and with its layered layout (of the
    reduced tree), for every config: the same reason, or None."""
    jp, tp = _tree(arch)
    a = plan.build_layout(tp, plan.DistPlan(**STREAM))
    b = jplan.build_layout(jp, jplan.DistPlan(**STREAM))
    for layouts in ((None, None), (a, b)):
        assert plan.streaming_fallback_reason(
            get_arch(arch).reduced(), layouts[0], grad_accum=2) == \
            jplan.streaming_fallback_reason(jget_arch(arch).reduced(),
                                            layouts[1], grad_accum=2)


def test_stream_without_the_layered_layout_raises():
    """schedule='stream' with layered=False raises (a bucket spanning
    layers could only leave after all of them); layered defaults to the
    schedule."""
    with pytest.raises(ValueError, match="layer-aligned"):
        plan.DistPlan(schedule="stream", layered=False)
    assert plan.DistPlan(**STREAM).layered
    assert not plan.DistPlan().layered
    assert plan.DistPlan(**LAYERED).schedule == "posthoc"


# ---------------------------------------------------------------------------
# The streaming step at world 2.
# ---------------------------------------------------------------------------
def _jobs():
    """(name, args, kwargs) of every world-2 run, all in one spawn."""
    a5 = ("deepseek_v2_lite", "fp8_flow", "fp8", 5)
    out = [("stream", a5, dict(dist_kw=STREAM, order_log=True)),
           ("posthoc", a5, dict(dist_kw=LAYERED, order_log=True))]
    a2 = ("deepseek_v2_lite", "fp8_flow", "fp8", 2)
    for name, dk in (("stream_acc", STREAM), ("posthoc_acc", LAYERED)):
        out.append((name, a2, dict(dist_kw=dk, grad_accum=2,
                                   order_log=True)))
    for policy in ("none", "full", "fp8_resident", "pair"):
        for name, dk in (("stream", STREAM), ("posthoc", LAYERED)):
            out.append((f"{name}_{policy}",
                        ("qwen3_moe_235b", "fp8_flow", "fp8", 1),
                        dict(dist_kw=dk, remat=policy)))
    return out


@pytest.fixture(scope="module")
def stream_runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("stream"))
    jobs = _jobs()
    res = run_ranks(ranks.train_many, 2, tmp,
                    args=([(a, kw) for _, a, kw in jobs],))
    return {name: [r[i] for r in res] for i, (name, _, _) in enumerate(jobs)}


@pytest.mark.parametrize("acc", ["", "_acc"])
def test_stream_equals_posthoc_layered(stream_runs, acc):
    """deepseek_v2_lite (dense prologue, shared experts, stacked
    sensitive leaves) at world 2, 5 steps (2 with grad_accum = 2): the
    streaming schedule against the post-hoc one over the same layered
    buckets, losses and every parameter on both ranks bit for bit (the
    reference's bars, rtol 1e-3 on the losses and atol 2e-2 on the
    params, hold a fortiori)."""
    s, p = stream_runs[f"stream{acc}"], stream_runs[f"posthoc{acc}"]
    for a, b in zip(s, p):
        assert a["losses"] == b["losses"]
        np.testing.assert_allclose(a["losses"], b["losses"], rtol=1e-3)
        for k, v in b["params"].items():
            assert np.array_equal(a["params"][k], v), k
    assert np.isfinite(s[0]["losses"]).all()


def test_stream_sends_one_reduce_scatter_a_bucket(stream_runs):
    """With grad_accum = 2 a step's wire is one all-to-all a layered
    bucket (sent from the last microbatch's backward), as posthoc's."""
    from repro_torch.dist.plan import DistPlan, build_layout
    from repro_torch.models.lm import init_params
    cfg = get_arch("deepseek_v2_lite").reduced()
    n = len(build_layout(init_params(cfg, device="cpu"),
                         DistPlan(**STREAM)).buckets)
    for name in ("stream_acc", "posthoc_acc", "stream", "posthoc"):
        for r in stream_runs[name]:
            assert all(o.count("a2a") == n for o in r["orders"]), (
                name, n, [o.count("a2a") for o in r["orders"]])


def test_stream_issues_before_the_last_backward_gemm(stream_runs):
    """Each step's launch order: the streaming wire's first reduce-scatter
    comes before the step's last grouped-GEMM launch (the backward of the
    layers below is still to run); the post-hoc wire's comes after it."""
    for r in stream_runs["stream"]:
        for o in r["orders"]:
            last_gemm = len(o) - 1 - o[::-1].index("gemm")
            assert o.index("a2a") < last_gemm
    for r in stream_runs["posthoc"]:
        for o in r["orders"]:
            assert o.index("a2a") > len(o) - 1 - o[::-1].index("gemm")


@pytest.mark.parametrize("policy", ["none", "full", "fp8_resident", "pair"])
def test_stream_keeps_two_casts_a_moe_block(stream_runs, policy):
    """qwen3 (2 MoE layers) one step under each remat policy: the streamed
    step records 2 activation casts a MoE block, as the post-hoc one (the
    recompute records none), and the same loss bit for bit."""
    cfg = get_arch("qwen3_moe_235b").reduced()
    for s, p in zip(stream_runs[f"stream_{policy}"],
                    stream_runs[f"posthoc_{policy}"]):
        assert s["casts"] == p["casts"] == 2 * cfg.n_layers
        assert s["losses"] == p["losses"]


@pytest.fixture(scope="module")
def twenty_stream_steps(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("stream20"))
    a = ("qwen15_05b", "fp8_flow")
    res = run_ranks(ranks.train_many, 2, tmp, args=([
        (a + ("fp8", 20), dict(n_total=400, dist_kw=STREAM)),
        (a + ("f32", 20), dict(n_total=400, dist_kw=STREAM,
                               state_policy=F32))],))
    return [np.array(r["losses"]) for r in res[0]]


def test_fp8_vs_f32_stream_training_parity(twenty_stream_steps):
    """20 streamed steps of qwen15_05b at world 2: the FP8 wire (the
    FP8-split state) against the f32 wire (f32 state), the reference's
    bars: the last 5 losses' mean within 1%, every step within 5%, and
    both learn."""
    l_fp8, l_f32 = twenty_stream_steps
    assert np.isfinite(l_fp8).all() and np.isfinite(l_f32).all()
    assert l_fp8[-5:].mean() < l_fp8[:3].mean() - 0.1
    rel = abs(l_fp8[-5:].mean() - l_f32[-5:].mean()) / l_f32[-5:].mean()
    assert rel < 0.01, rel
    assert np.max(np.abs(l_fp8 - l_f32) / np.abs(l_f32)) < 0.05


def test_stream_guard_catches_and_recovers_a_flipped_byte(tmp_path):
    """A flipped payload byte on the streamed wire at step 1: flagged
    (WIRE_SCALE) on both ranks, the verdicts read after the backward, the
    poisoned bucket sent again on the bf16 all-reduce, and the losses
    within 1% of the clean streamed run's."""
    a = ("qwen15_05b", "fp8_flow", "fp8", 3)
    res = run_ranks(ranks.train_many, 2, tmp_path, args=([
        (a, dict(guard=True, dist_kw=STREAM)),
        (a, dict(guard=True, dist_kw=STREAM,
                 faults=(("payload_bitflip", 1),)))],))
    clean, hit = res[0][0], [r[1] for r in res]
    assert not any(f & WIRE_SCALE for f in clean["flags"])
    for r in hit:
        assert [bool(f & WIRE_SCALE) for f in r["flags"]] == \
            [False, True, False], r["flags"]
        assert np.isfinite(r["losses"]).all()
        np.testing.assert_allclose(r["losses"], clean["losses"], rtol=0.01)
