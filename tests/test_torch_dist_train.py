"""The DistPlan train step (the FP8 DP wire with ZeRO-1) at world 2 on
gloo ranks, held to the invariants the reference's tests state
(tests/test_dist.py): the f32 wire equals the plain step, the FP8 wire
tracks the f32 wire over 20 steps at the reference's bars, the cast
ledger is unchanged by the wire, a ZeRO-1 checkpoint restores across DP
sizes bit for bit and trains on as if never stopped, the wire faults are
caught and recovered in the step, and a model axis is refused.  The
reference's own DistPlan step does not run under jax 0.9 here (its scan
carry, ROADMAP.md, Queue 3), so the port is held to these bars and not
to a run of it; its units (layout, wire, flat update, MoE blocks) are
held to the reference's in tests/test_torch_dist.py and
tests/test_torch_ep.py."""
import torch_threads  # noqa: F401  (first: one intra-op thread)

import numpy as np
import pytest

import torch_dist_ranks as ranks
from repro_torch.configs import get_arch
from repro_torch.core.recipes import get_recipe
from repro_torch.dist.opt_state import StatePolicy
from repro_torch.dist.plan import DistPlan
from repro_torch.launch.mesh import Mesh
from repro_torch.models.lm import ParallelPlan
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.guards import WIRE_SCALE
from repro_torch.train.train_step import make_train_step
from torch_dist_harness import run_ranks

F32 = StatePolicy(m="f32", v="f32", master="f32")


@pytest.mark.parametrize("arch", ["qwen15_05b", "deepseek_v2_lite"])
def test_f32_wire_equals_the_plain_step(tmp_path, arch):
    """wire='f32' with the f32 state against the plain step (its f32
    gradient all-reduce, f32 AdamW state) on the same 2 ranks and
    batches, 3 steps: the losses, the global norms and every parameter
    bit for bit (two ranks' f32 sums are one commutative add, and the
    wire's norm adds its leaves' squares in the plain step's order).
    min_fp8_size 256 puts the stacked f32 norm scales in the wire's
    buckets beside bf16 leaves, as at full width: their shards travel in
    f32, so they keep the plain step's f32 update."""
    kw = dict(state_policy=F32, min_fp8_size=256)
    wire = run_ranks(ranks.train, 2, tmp_path,
                     args=(arch, "fp8_flow", "f32", 3), kwargs=kw)
    plain = run_ranks(ranks.train, 2, tmp_path,
                      args=(arch, "fp8_flow", None, 3), kwargs=kw)
    assert wire[0]["losses"] == plain[0]["losses"]
    assert wire[0]["gnorms"] == plain[0]["gnorms"]
    for k, v in plain[0]["params"].items():
        assert np.array_equal(wire[0]["params"][k], v), k
        assert np.array_equal(wire[1]["params"][k], v), k


@pytest.fixture(scope="module")
def twenty_steps(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("parity"))
    fp8 = run_ranks(ranks.train, 2, tmp,
                    args=("qwen15_05b", "fp8_flow", "fp8", 20),
                    kwargs=dict(n_total=400))
    f32 = run_ranks(ranks.train, 2, tmp,
                    args=("qwen15_05b", "fp8_flow", "f32", 20),
                    kwargs=dict(n_total=400, state_policy=F32))
    return np.array(fp8[0]["losses"]), np.array(f32[0]["losses"])


def test_fp8_vs_f32_wire_training_parity(twenty_steps):
    """20 steps of qwen15_05b at world 2: the FP8 wire (with the FP8-split
    state) against the f32 wire (f32 state), the reference's bars: the
    mean of the last 5 losses within 1%, every step within 5%, and both
    learn."""
    l_fp8, l_f32 = twenty_steps
    assert np.isfinite(l_fp8).all() and np.isfinite(l_f32).all()
    assert l_fp8[-5:].mean() < l_fp8[:3].mean() - 0.1
    rel = abs(l_fp8[-5:].mean() - l_f32[-5:].mean()) / l_f32[-5:].mean()
    assert rel < 0.01, rel
    assert np.max(np.abs(l_fp8 - l_f32) / np.abs(l_f32)) < 0.05


def test_cast_count_unchanged_with_wire(tmp_path):
    """One step at world 2 with the FP8 wire and with the plain step: the
    same activation casts (fp8_flow's 2 a FFN), the explicit quantize /
    dequantize tags {q_entry, q_bwd_island}, and the wire's and the
    state's quantizes present as fused casts."""
    wire = run_ranks(ranks.train, 2, tmp_path,
                     args=("qwen15_05b", "fp8_flow", "fp8", 1))
    plain = run_ranks(ranks.train, 2, tmp_path,
                      args=("qwen15_05b", "fp8_flow", None, 1))
    for w, p in zip(wire, plain):
        assert w["casts"] == p["casts"] > 0
        for r in (w, p):
            tags = {t.split(":")[1] for t in r["tags"]
                    if t.split(":")[0] in ("quantize", "dequantize")
                    and not t.split(":")[1].startswith("q_w")}
            assert tags == {"q_entry", "q_bwd_island"}, r["tags"]
        assert "fused_quantize:dp_wire" in w["tags"]
        assert "fused_quantize:opt_state" in w["tags"]


def test_zero1_checkpoint_restores_across_dp_sizes(tmp_path):
    """A checkpoint saved at world 2 (step 2 of 3, qwen15_05b, the FP8
    wire and split state) restores at worlds 1 and 4 with every byte of
    the gathered ZeRO-1 state and the params; a world-2 run restarted
    from it gives the uninterrupted run's losses and state bit for bit,
    and a world-4 run goes on from it with finite losses within 5% of
    those."""
    d = str(tmp_path / "ckpt")
    arch = "qwen15_05b"
    kw = dict(ckpt_dir=d, ckpt_every=2, full_state=True)
    saved = run_ranks(ranks.train, 2, tmp_path,
                      args=(arch, "fp8_flow", "fp8", 3), kwargs=kw)[0]
    for world in (1, 4):
        back = run_ranks(ranks.train, world, tmp_path,
                         args=(arch, "fp8_flow", "fp8", 3), kwargs=kw)
        for r in back:
            assert r["losses"] == []            # restored past step 2
            for part in ("opt", "params"):
                for k, v in saved[part].items():
                    assert np.array_equal(np.asarray(r[part][k]),
                                          np.asarray(v)), (world, part, k)
    whole = run_ranks(ranks.train, 2, tmp_path,
                      args=(arch, "fp8_flow", "fp8", 5),
                      kwargs=dict(full_state=True))[0]
    on = dict(kw, ckpt_every=100)       # restore step 2, save nothing new
    again = run_ranks(ranks.train, 2, tmp_path,
                      args=(arch, "fp8_flow", "fp8", 5), kwargs=on)[0]
    assert again["losses"] == whole["losses"][3:]
    for part in ("opt", "params"):
        for k, v in whole[part].items():
            assert np.array_equal(np.asarray(again[part][k]),
                                  np.asarray(v)), (part, k)
    wider = run_ranks(ranks.train, 4, tmp_path,
                      args=(arch, "fp8_flow", "fp8", 5), kwargs=on)[0]
    assert len(wider["losses"]) == 2 and np.isfinite(wider["losses"]).all()
    np.testing.assert_allclose(wider["losses"], whole["losses"][3:],
                               rtol=0.05)


@pytest.fixture(scope="module")
def clean_guarded(tmp_path_factory):
    return run_ranks(ranks.train, 2, str(tmp_path_factory.mktemp("clean")),
                     args=("qwen15_05b", "fp8_flow", "fp8", 3),
                     kwargs=dict(guard=True))[0]


@pytest.mark.parametrize("kind", ["payload_bitflip", "wire_scale"])
def test_wire_faults_are_caught_and_recovered(tmp_path, clean_guarded,
                                              kind):
    """A flipped payload byte (0x7f, NaN) or a poisoned exponent (127) on
    the wire at step 1: the wire guard sees it on the received message
    on both ranks, flags WIRE_SCALE, and the poisoned bucket takes the
    bf16 all-reduce, so the step updates (a soft flag) with finite values
    and the losses stay within 1% of the clean run's."""
    clean = clean_guarded
    hit = run_ranks(ranks.train, 2, tmp_path,
                    args=("qwen15_05b", "fp8_flow", "fp8", 3),
                    kwargs=dict(guard=True, faults=((kind, 1),)))
    for r in hit:
        assert [bool(f & WIRE_SCALE) for f in r["flags"]] == \
            [False, True, False], r["flags"]
        assert np.isfinite(r["losses"]).all()
        np.testing.assert_allclose(r["losses"], clean["losses"], rtol=0.01)
    assert not any(f & WIRE_SCALE for f in clean["flags"])


def test_dist_step_refuses_a_model_axis():
    """The DistPlan step runs the forward replica-locally over the data
    axis; a mesh with a model axis of 2 raises (the reference's
    test_dist_rejects_model_parallel_mesh), as does a DP size that does
    not divide shard_multiple, and a DistPlan without a mesh."""
    cfg = get_arch("qwen15_05b").reduced()
    recipe, opt = get_recipe("fp8_flow"), AdamWConfig()
    with pytest.raises(ValueError, match="model-parallel"):
        make_train_step(cfg, recipe, opt, dist=DistPlan(), plan=ParallelPlan(
            mesh=Mesh(dp=1, ep=2, rank=0, device="cpu")))
    with pytest.raises(ValueError, match="shard_multiple"):
        make_train_step(cfg, recipe, opt, dist=DistPlan(shard_multiple=64),
                        plan=ParallelPlan(mesh=Mesh(dp=3, ep=1, rank=0,
                                                    device="cpu")))
    with pytest.raises(ValueError, match="plan.mesh"):
        make_train_step(cfg, recipe, opt, dist=DistPlan())


def test_zero1_gather_sends_each_bucket_in_its_param_dtype(tmp_path):
    """The ZeRO-1 gather sends a bucket in its param dtype: f32 where an
    f32 leaf (a stacked norm scale, min_fp8_size 256) shares it, where the
    reference gathers bf16 always (ROADMAP.md, Queue 3).  One DistPlan
    step of a reduced deepseek_v2_lite on a one-rank gloo group: its
    all-gather bytes are the buckets' rows at their own widths, and
    wire_param_bytes at those widths is what a world of 16 would send."""
    from repro_torch.core.fp8 import TILE
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.dist import comm, grad_comm
    from repro_torch.dist import opt_state as ost
    from repro_torch.dist.plan import build_layout, flatten_with_paths
    from repro_torch.launch.mesh import close_mesh, init_mesh
    from repro_torch.train.train_step import init_train_state
    cfg = get_arch("deepseek_v2_lite").reduced()
    dist = DistPlan(wire="f32", policy=F32, min_fp8_size=256)
    opt = AdamWConfig(lr=3e-3)
    mesh = init_mesh(1, 1, device="cpu", store=str(tmp_path / "store"),
                     timeout_s=60)
    try:
        state = init_train_state(cfg, opt, seed=0, device="cpu", dist=dist,
                                 mesh=mesh)
        step = make_train_step(cfg, get_recipe("fp8_flow"), opt, dist=dist,
                               plan=ParallelPlan(mesh=mesh), total_steps=10,
                               warmup_steps=1)
        batch = make_batch(DataConfig(vocab=cfg.vocab, seq_len=32,
                                      global_batch=2), 0, device="cpu")
        comm.reset_counts()
        step(state, batch)
        sent = comm.counts()["all-gather"]
    finally:
        close_mesh()
    leaves = [t for _, t in flatten_with_paths(state["params"])]
    layout = build_layout(state["params"], dist)
    widths = [ost.bucket_dtype(b, leaves).itemsize for b in layout.buckets]
    assert 4 in widths
    assert sent["calls"] == len(layout.buckets)
    assert sent["bytes"] == sum(b.rows * TILE * w
                                for b, w in zip(layout.buckets, widths))
    model = sum(grad_comm.wire_param_bytes(b.rows * TILE, 16, w)
                for b, w in zip(layout.buckets, widths))
    assert model == comm.wire_factor("all-gather", 16) * sent["bytes"]
