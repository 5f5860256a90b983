"""The FP8 DP gradient wire's pieces against the reference
(``repro.dist``): the bucket layout on the same tree, the wire message
byte for byte, the reduce-scatter at n = 2 and 4 (the port on gloo ranks,
the reference on forced host devices) at the reference test's bounds,
the ZeRO-1 flat update's twin, and ``compressed_psum``."""
import torch_threads  # noqa: F401  (first: one intra-op thread)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from repro.configs import get_arch as jget_arch
from repro.dist import grad_comm as jgc
from repro.dist import opt_state as jost
from repro.dist import plan as jplan
from repro.dist import scale_sync as jss
from repro.models.lm import init_params as jinit_params
from repro.optim.adamw import AdamWConfig as JAdamW
from repro.runtime import compression as jcomp
from repro_torch.core import casts
from repro_torch.core.fp8 import TILE
from repro_torch.dist import grad_comm, opt_state, plan, scale_sync
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime import compression
from repro_torch.weights import params_from_numpy
from torch_dist_harness import run_ranks, run_reference


def f8(a):
    return torch.from_numpy(np.ascontiguousarray(a)).view(torch.float8_e4m3fn)


@pytest.mark.parametrize("arch", ["qwen15_05b", "deepseek_v2_lite",
                                  "qwen3_moe_235b"])
@pytest.mark.parametrize("bucket_mb", [4.0, 0.01])
def test_layout_equals_the_reference(arch, bucket_mb):
    """build_layout on the reference's init_params tree (carried across
    bit for bit) gives the reference's buckets: every slot's leaf index,
    path, offset, rows and size, every bucket's padded rows, and the
    sensitive leaves, in order."""
    cfg = jget_arch(arch).reduced()
    jp = jinit_params(cfg, jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    a = plan.build_layout(tp, plan.DistPlan(bucket_mb=bucket_mb))
    b = jplan.build_layout(jp, jplan.DistPlan(bucket_mb=bucket_mb))
    assert a.n_leaves == b.n_leaves
    assert [tuple(s) for s in a.sensitive] == [tuple(s) for s in b.sensitive]
    assert len(a.buckets) == len(b.buckets) and a.buckets
    for x, y in zip(a.buckets, b.buckets):
        assert x.rows == y.rows
        assert [(s.index, s.path, s.offset_rows, s.rows, s.size)
                for s in x.slots] == \
            [(s.index, s.path, s.offset_rows, s.rows, s.size)
             for s in y.slots]
    assert a.fp8_elems == b.fp8_elems and a.wire_rows == b.wire_rows
    # the flat space round-trips every bucket leaf
    leaves = plan.tree_leaves(tp)
    for bk in a.buckets:
        back = plan.bucket_scatter(bk, plan.bucket_flat(bk, leaves), leaves)
        for i, t in back.items():
            assert torch.equal(t, leaves[i])


def test_wire_models_equal_the_references():
    """The bytes-on-wire models and the streaming schedule's exposed-time
    model: the reference's numbers."""
    for n in (1, 2, 8, 16):
        for elems in (1, 127, 128, 10 * 2 ** 20 + 3):
            for wire in ("fp8", "bf16", "f32"):
                for mode in ("zero1", "none"):
                    assert grad_comm.wire_grad_bytes(elems, n, wire, mode) \
                        == jgc.wire_grad_bytes(elems, n, wire, mode)
            assert grad_comm.wire_param_bytes(elems, n) == \
                jgc.wire_param_bytes(elems, n)
    b, c = [5.0, 3.0, 7.5, 1.0], [2.0, 9.0, 1.0, 0.5]
    assert grad_comm.stream_exposed_us(b, c) == jgc.stream_exposed_us(b, c)
    n = 10 * 2 ** 20
    assert grad_comm.wire_grad_bytes(n, 8, "bf16", "none") / \
        grad_comm.wire_grad_bytes(n, 8, "fp8") >= 3.0


def test_stream_schedule_needs_the_layered_layout():
    """schedule='stream' takes the layered layout by default and raises
    ValueError without it, as the reference's DistPlan does; the layered
    layout also runs post hoc (the controlled baseline)."""
    assert plan.DistPlan(schedule="stream").layered
    assert plan.DistPlan(layered=True).schedule == "posthoc"
    with pytest.raises(ValueError, match="layer-aligned"):
        plan.DistPlan(schedule="stream", layered=False)
    with pytest.raises(ValueError, match="layer-aligned"):
        jplan.DistPlan(schedule="stream", layered=False)


def test_wire_message_is_the_references_bytes():
    """pack_bucket / unpack_bucket on the same payload and exponents, and
    quantize_bucket (one replica) on the same bucket: the same uint8
    message byte for byte.  On rows whose amax sits exactly at 448 * 2**e
    the reference's ceil(log2(.)) can miss the exact po2 scale the port
    takes (ROADMAP.md, Queue 3): both counts are reported, and every port
    scale is the smallest power of two that fits."""
    r = np.random.default_rng(0)
    pay = r.integers(0, 256, (64, TILE), dtype=np.uint8)
    pay[(pay & 0x7F) == 0x7F] = 0
    exp = r.integers(-50, 50, (64, 1)).astype(np.int8)
    msg = grad_comm.pack_bucket(f8(pay), torch.from_numpy(exp))
    jmsg = jgc.pack_bucket(jnp.asarray(pay).view(jnp.float8_e4m3fn),
                           jnp.asarray(exp))
    assert msg.dtype == torch.uint8 and msg.shape == (64, TILE + 1)
    assert np.array_equal(msg.numpy(), np.asarray(jmsg))
    p2, e2 = grad_comm.unpack_bucket(msg)
    assert np.array_equal(p2.view(torch.uint8).numpy(), pay)
    assert np.array_equal(e2.numpy(), exp)

    g = (r.normal(size=(256, TILE)) * 10.0 ** r.integers(-6, 4, (256, 1))
         ).astype(np.float32)
    with casts.ledger() as led:
        pay, exp = grad_comm.quantize_bucket(torch.from_numpy(g), None)
    assert led.by_tag() == {("fused_quantize", "dp_wire"): 1}
    jpay, jexp = jgc.quantize_bucket(jnp.asarray(g), None)
    port = grad_comm.pack_bucket(pay, exp).numpy()
    assert np.array_equal(port, np.asarray(jgc.pack_bucket(jpay, jexp)))

    # amax exactly 448 * 2**e, and one ulp either side
    e = r.integers(-30, 30, 192)
    amax = np.float32(448.0) * np.exp2(e).astype(np.float32)
    amax = np.concatenate([amax, np.nextafter(amax[:64], np.float32(np.inf)),
                           np.nextafter(amax[64:128], np.float32(0))])
    b = (r.uniform(-1, 1, (amax.size, TILE)) * amax[:, None]).astype(
        np.float32)
    b[:, 0] = amax
    _, pexp = grad_comm.quantize_bucket(torch.from_numpy(b), None)
    _, rexp = jgc.quantize_bucket(jnp.asarray(b), None)
    ps = scale_sync.exp_i8_to_scale(pexp).numpy()[:, 0]
    assert (amax / ps <= 448.0).all() and (amax / (ps / 2) > 448.0).all()
    differ = int((pexp.numpy() != np.asarray(rexp)).sum())
    print(f"boundary rows: {amax.size}, reference exponents that differ "
          f"from the exact po2: {differ}")


@pytest.fixture(scope="module")
def wire_runs(tmp_path_factory):
    """The port's replicas (gloo) and the reference's devices at n = 2
    and 4 on the same per-replica buckets."""
    tmp = str(tmp_path_factory.mktemp("wire"))
    r = np.random.default_rng(1)
    grads = {n: r.normal(size=(n, 8 * n * 4, TILE)).astype(np.float32)
             for n in (2, 4)}
    wires = ("fp8", "bf16", "f32")
    port = {n: run_ranks(ranks.wire_rank, n, tmp, args=(grads[n], wires))
            for n in (2, 4)}
    ref = run_reference("reduce_scatter", 4, tmp,
                        **{f"g_{w}_{n}": grads[n] for n in (2, 4)
                           for w in wires})
    ref.update(run_reference("compressed_psum", 4, tmp,
                             **{f"x_{n}": grads[n] for n in (2, 4)}))
    return grads, port, ref


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("wire", ["fp8", "bf16", "f32"])
def test_reduce_scatter_matches_the_reference(wire_runs, wire, n):
    """The owned rows of every replica, stitched, against the mean at the
    reference test's bounds (tests/test_dist.py:139-161) and against the
    reference's reduce-scatter; one all-to-all a bucket (and for fp8 one
    all-reduce of the row amax), whose bytes are the wire model's."""
    grads, port, ref = wire_runs
    g = grads[n]
    got = np.concatenate([p[wire] for p in port[n]])
    want = g.mean(axis=0)
    jgot = ref[f"rs_{wire}_{n}"]
    if wire == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got, jgot, rtol=1e-6, atol=1e-7)
    else:
        res = 2 ** -3 if wire == "fp8" else 2 ** -8
        amax = np.abs(g).max(axis=0).max(-1, keepdims=True)
        tol = res * amax * 1.01
        assert (np.abs(got - want) <= tol).all()
        # the same quantized values (agreed po2 scales), summed in another
        # order: within an f32 rounding of the row amax
        assert (np.abs(got - jgot) <= 2 ** -20 * amax).all()
    coll = port[n][0][f"coll_{wire}"]
    rows = g.shape[1]
    assert coll["all-to-all"]["calls"] == 1
    width = {"fp8": TILE + 1, "bf16": 2 * TILE, "f32": 4 * TILE}[wire]
    assert coll["all-to-all"]["bytes"] == rows * width
    from repro_torch.dist.comm import wire_factor
    sent = sum(wire_factor(k, n) * v["bytes"] for k, v in coll.items())
    assert sent == pytest.approx(grad_comm.wire_grad_bytes(rows * TILE, n,
                                                           wire))


@pytest.mark.parametrize("n", [2, 4])
def test_compressed_psum_matches_the_reference(wire_runs, n):
    """compressed_psum at n replicas: every replica gets the same sum,
    within the two po2 quantizations' bound of the true sum and of the
    reference's."""
    grads, port, ref = wire_runs
    g = grads[n]
    outs = [p["psum"] for p in port[n]]
    for o in outs[1:]:
        assert np.array_equal(o, outs[0])
    want = g.sum(axis=0)
    amax = np.abs(g).sum(axis=0).max(-1, keepdims=True)
    assert (np.abs(outs[0] - want) <= 2 * 2 ** -3 * amax).all()
    jgot = ref[f"psum_{n}"][0]
    assert (np.abs(outs[0] - jgot) <= 2 ** -3 * amax).all()
    assert np.mean(outs[0] == jgot) > 0.99


def test_compress_decompress_is_the_references():
    r = np.random.default_rng(3)
    x = (r.normal(size=(37, 100)) * 3.0).astype(np.float32)
    with casts.ledger() as led:
        got = compression.compress_decompress(torch.from_numpy(x)).numpy()
    assert led.by_tag() == {("fused_quantize", "grad_compress"): 1}
    want = np.asarray(jcomp.compress_decompress(jnp.asarray(x)))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("pol", ["split", "f32"])
@pytest.mark.parametrize("master", [True, False])
def test_flat_bucket_update_matches_the_reference(pol, master):
    """One owned (rows, TILE) shard updated by flat_bucket_update (the
    adamw_update kernel's twin on the CPU) against the reference's
    flat_bucket_update from the same state: the new params within one
    bf16 ulp, m and v bit for bit where their scales agree (all but rows
    whose amax lands on 448 * 2**e), the new master within f16 rounding."""
    r = np.random.default_rng(4)
    rows = 64
    policy = opt_state.StatePolicy() if pol == "split" else \
        opt_state.StatePolicy(m="f32", v="f32", master="f32")
    jpolicy = jost.StatePolicy() if pol == "split" else \
        jost.StatePolicy(m="f32", v="f32", master="f32")
    p0 = (r.normal(size=(rows, TILE)) * 0.02).astype(np.float32)
    p_bf = torch.from_numpy(p0).to(torch.bfloat16)
    g = (r.normal(size=(rows, TILE)) * 1e-3).astype(np.float32)
    m0 = (r.normal(size=(rows, TILE)) * 1e-4).astype(np.float32)
    v0 = (r.random((rows, TILE)) * 1e-6).astype(np.float32)
    opt = AdamWConfig(lr=1e-3, master_weights=master)
    jopt = JAdamW(lr=1e-3, master_weights=master)
    # copies: an f32 state is updated in place, and jax may alias numpy
    st = {"m": opt_state.encode(policy.m, torch.tensor(m0)),
          "v": opt_state.encode(policy.v, torch.tensor(v0))}
    jst = {"m": jost.encode(jpolicy.m, jnp.array(m0)),
           "v": jost.encode(jpolicy.v, jnp.array(v0))}
    if master:
        st["master"] = opt_state.encode(policy.master, p_bf.float())
        jst["master"] = jost.encode(jpolicy.master,
                                    jnp.asarray(p_bf.float().numpy()))
    clip = torch.tensor(0.5)
    b1c, b2c = 0.1, 0.05
    p_shard = p_bf.reshape(-1).clone()
    opt_state.flat_bucket_update(opt, st, torch.from_numpy(g), clip, 1e-3,
                                 b1c, b2c, p_shard)
    jp, jnew = jost.flat_bucket_update(
        jopt, jpolicy, jst, jnp.asarray(g), jnp.float32(0.5), 1e-3,
        jnp.float32(b1c), jnp.float32(b2c),
        None if master else jnp.asarray(p_bf.float().numpy()))
    got = p_shard.float().numpy().reshape(rows, TILE)
    want = np.asarray(jp, np.float32)
    ulp = np.abs(want) * 2 ** -7 + 1e-30
    assert (np.abs(got - want) <= ulp).all()
    assert np.mean(got == want) > 0.99

    def dec(enc):
        return opt_state.decode(enc, (rows, TILE), rows * TILE).numpy()

    def jdec(enc):
        return np.asarray(jost.decode(enc, (rows, TILE), rows * TILE))

    for k in st:
        a, b = dec(st[k]), jdec(jnew[k])
        np.testing.assert_allclose(a, b, rtol=2 ** -2, atol=1e-30)
        assert np.mean(a == b) > 0.98, k


@pytest.mark.parametrize("master", [True, False])
def test_f32_bucket_shard_is_the_reference_before_its_bf16_round(master):
    """A ZeRO-1 bucket that holds an f32 leaf (a stacked norm scale):
    the port updates and gathers its shard in f32, the reference returns
    bf16 for every bucket (repro/dist/opt_state.py flat_bucket_update,
    gathered by repro/train/train_step.py:464-482), so it rounds such a
    leaf to bf16 every step (ROADMAP.md, Queue 3).  The port's f32 shard,
    rounded to bf16, is the reference's within one bf16 ulp (as the bf16
    twin above), and it keeps bits the bf16 round drops."""
    r = np.random.default_rng(5)
    rows = 64
    p0 = (1.0 + r.normal(size=(rows, TILE)) * 0.02).astype(np.float32)
    g = (r.normal(size=(rows, TILE)) * 1e-3).astype(np.float32)
    policy = opt_state.StatePolicy(m="f32", v="f32", master="f32")
    jpolicy = jost.StatePolicy(m="f32", v="f32", master="f32")
    opt = AdamWConfig(lr=1e-3, master_weights=master)
    jopt = JAdamW(lr=1e-3, master_weights=master)
    zero = np.zeros((rows, TILE), np.float32)
    st = {"m": opt_state.encode("f32", torch.tensor(zero)),
          "v": opt_state.encode("f32", torch.tensor(zero))}
    jst = {"m": jost.encode("f32", jnp.array(zero)),
           "v": jost.encode("f32", jnp.array(zero))}
    if master:
        st["master"] = opt_state.encode(policy.master, torch.tensor(p0))
        jst["master"] = jost.encode(jpolicy.master, jnp.array(p0))
    p_shard = torch.tensor(p0).reshape(-1)
    opt_state.flat_bucket_update(opt, st, torch.from_numpy(g),
                                 torch.tensor(1.0), 1e-3, 0.1, 0.05, p_shard)
    jp, _ = jost.flat_bucket_update(
        jopt, jpolicy, jst, jnp.asarray(g), jnp.float32(1.0), 1e-3,
        jnp.float32(0.1), jnp.float32(0.05),
        None if master else jnp.asarray(p0))
    assert p_shard.dtype == torch.float32 and jp.dtype == jnp.bfloat16
    got = p_shard.to(torch.bfloat16).float().numpy().reshape(rows, TILE)
    want = np.asarray(jp, np.float32)
    assert (np.abs(got - want) <= np.abs(want) * 2 ** -7).all()
    assert np.mean(got == want) > 0.99
    f32 = p_shard.numpy().reshape(rows, TILE)
    assert np.mean(f32 != got) > 0.9


def test_tally_counts_what_the_collectives_send(tmp_path):
    """roofline.analysis.tally() records every collective wrapper's call
    and buffer bytes by kind, the same numbers as dist/comm.COUNTS; its
    collective term is 0 at one rank and the ring factors of the
    reference's wire model at a modelled world: the fp8 bucket's
    reduce-scatter gives wire_grad_bytes exactly (one rank of a gloo
    group here: every collective launches, a copy)."""
    from repro_torch.dist import comm
    from repro_torch.launch.mesh import close_mesh, init_mesh
    from repro_torch.roofline import analysis as roofline
    mesh = init_mesh(1, 1, device="cpu", store=str(tmp_path / "store"),
                     timeout_s=60)
    try:
        g = torch.randn((256, TILE))
        comm.reset_counts()
        with roofline.tally() as t:
            grad_comm.reduce_scatter_bucket(g, mesh.data_group, 1, "fp8")
        want = comm.counts()
        assert {k: {"calls": c, "bytes": b} for k, (c, b) in t.coll.items()} \
            == {k: v for k, v in want.items() if v["calls"]}
        assert t.coll["all-to-all"] == [1, 256 * (TILE + 1)]
        assert t.coll["all-reduce"] == [1, 256 * 4]        # the row amax
        assert t.coll_buffer_bytes == 256 * (TILE + 1) + 256 * 4
        roof = roofline.analyze_tally(t, model_flops_global=1.0)
        assert roof.coll_bytes == 0.0 and roof.t_collective == 0.0
        for n in (2, 8, 16):
            assert t.coll_bytes(n) == pytest.approx(
                grad_comm.wire_grad_bytes(256 * TILE, n, "fp8"))
        assert roofline.analyze_tally(
            t, model_flops_global=1.0, n_chips=16).coll_by_kind == \
            {"all-to-all": 256 * (TILE + 1), "all-reduce": 256 * 4}
    finally:
        close_mesh()
