"""The chunked (overlapped) MoE dispatch pipeline of the port at EP = 1
against the reference's (``repro.core.moe``): ``DispatchPlan``'s chunk
counts, the packed uint8 messages byte for byte, ``moe_block_overlapped``
and ``moe_block_decode_overlapped`` on the same inputs, and the port's own
invariants where the reference cannot run under jax 0.9 (its bf16 and
naive_fp8 overlap tests fail there): every recipe's chunked block against
the port's monolithic ``moe_block``, 2 activation casts for fp8_flow at
any chunk count, and the model forward with ``moe_overlap`` set.

The reference runs as tests/test_overlap.py runs it: inside ``shard_map``
over a 1x1 mesh (``tests.conftest.make_mesh11``), jitted, its inputs from
one numpy seed, one reference run per case shared by its checks.  The
mesh's replication check is off (``check_vma=False``): under jax 0.9 it
refuses the reference's own drop-fraction output (its overlap tests fail
on it in some environments), and one rank has nothing to check."""
import torch_threads  # noqa: F401  (first: one intra-op thread)
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.compat import shard_map
from repro.core import moe as jmoe
from repro.core.recipes import get_recipe as jget_recipe
from repro_torch.configs import get_arch
from repro_torch.core import casts, moe
from repro_torch.core.moe import (DispatchPlan, MoEConfig, moe_block,
                                  moe_block_decode,
                                  moe_block_decode_overlapped,
                                  moe_block_overlapped)
from repro_torch.core.quant import quantize_blockwise
from repro_torch.core.recipes import get_recipe
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.models import lm
from repro_torch.optim.adamw import tree_leaves
from tests.conftest import make_mesh11

COSINE = 0.999        # the bar of tests/test_torch_recipes.py


def cos(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-300))


def np32(t):
    return t.detach().to(torch.float32).numpy()


def toy(seed=1, T=256, D=256, F=128, E=4, topk=2, cf=4.0):
    """tests/test_overlap.py's block (ample capacity: no drops), as numpy
    arrays: x (T, D) bf16-rounded, the router, f32 w13 and w2."""
    r = np.random.default_rng(seed)
    x = r.normal(size=(T, D)).astype(np.float32)
    x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    wr = (r.normal(size=(D, E)) * 0.02).astype(np.float32)
    w13 = (r.normal(size=(E, D, 2 * F)) * 0.05).astype(np.float32)
    w2 = (r.normal(size=(E, F, D)) * 0.05).astype(np.float32)
    return dict(E=E, topk=topk, D=D, F=F, cf=cf), (x, wr, w13, w2)


def configs(spec):
    kw = dict(n_experts=spec["E"], top_k=spec["topk"], d_model=spec["D"],
              d_ff=spec["F"], capacity_factor=spec["cf"])
    return jmoe.MoEConfig(**kw), MoEConfig(**kw)


def torch_args(args, requires_grad=False):
    x, wr, w13, w2 = args
    out = [torch.tensor(x).to(torch.bfloat16), torch.tensor(wr),
           torch.tensor(w13), torch.tensor(w2)]
    return [t.requires_grad_(requires_grad) for t in out]


# ---------------------------------------------------------------------------
# The plan and the messages.
# ---------------------------------------------------------------------------
def test_dispatch_plan_chunk_counts_equal_the_reference():
    for n in (1, 2, 3, 4, 8):
        for mt in (1, 8, 64):
            a = DispatchPlan(n_chunks=n, min_chunk_tokens=mt,
                             decode_chunks=n, min_decode_tokens=mt)
            b = jmoe.DispatchPlan(n_chunks=n, min_chunk_tokens=mt,
                                  decode_chunks=n, min_decode_tokens=mt)
            for T in (1, 7, 8, 63, 64, 96, 128, 255, 256, 2048):
                assert a.chunks_for(T) == b.chunks_for(T), (n, mt, T)
                assert a.decode_chunks_for(T) == b.decode_chunks_for(T)


def test_packed_messages_are_the_references_bytes():
    r = np.random.default_rng(0)
    R, D = 40, 256
    d = r.integers(0, 256, (R, D), dtype=np.uint8)
    d[d == 0x7F] = 0                       # no NaN codes needed here
    s = np.exp2(r.integers(-20, 5, (R, D // 128))).astype(np.float32)
    se = r.integers(-1, 4, R).astype(np.int32)
    pf = r.random(R).astype(np.float32)
    gp = r.normal(size=R).astype(np.float32)
    dt = torch.from_numpy(d).view(torch.float8_e4m3fn)
    st, set_, pft, gpt = (torch.from_numpy(a) for a in (s, se, pf, gp))
    jd = jnp.asarray(d).view(jnp.float8_e4m3fn)
    fwd = moe._pack_dispatch_msg(dt, st, set_, pft)
    jfwd = jmoe._pack_dispatch_msg(jd, jnp.asarray(s), jnp.asarray(se),
                                   jnp.asarray(pf))
    assert fwd.dtype == torch.uint8
    assert np.array_equal(fwd.numpy(), np.asarray(jfwd))
    bwd = moe._pack_bwd_msg(dt, st, gpt)
    jbwd = jmoe._pack_bwd_msg(jd, jnp.asarray(s), jnp.asarray(gp))
    assert np.array_equal(bwd.numpy(), np.asarray(jbwd))
    # and each unpacks to the same bits
    d2, s2, se2, pf2 = moe._unpack_dispatch_msg(fwd, D)
    assert np.array_equal(d2.view(torch.uint8).numpy(), d)
    assert np.array_equal(s2.numpy(), s) and np.array_equal(se2.numpy(), se)
    assert np.array_equal(pf2.numpy(), pf)
    gd, gs, gp2 = moe._unpack_bwd_msg(bwd, D)
    assert np.array_equal(gd.view(torch.uint8).numpy(), d)
    assert np.array_equal(gs.numpy(), s) and np.array_equal(gp2.numpy(), gp)


def test_expert_parallel_a2a_waits_for_multi_gpu(tmp_path):
    """The all-to-all is the identity with no group (it launches nothing)
    and, since the expert-parallel slice, a collective on a group: on a
    one-rank gloo group (an FP8 message as its bytes) it returns a copy
    with every byte, synchronous or in flight.  Its EP > 1 behaviour is
    tests/test_torch_ep.py's."""
    from repro_torch.dist import comm
    from repro_torch.launch.mesh import close_mesh, init_mesh
    x = torch.ones(4, 8)
    assert comm.all_to_all(x, None) is x
    assert comm.all_to_all(x, None, async_op=True).wait() is x
    mesh = init_mesh(1, 1, device="cpu", store=str(tmp_path / "store"),
                     timeout_s=60)
    try:
        comm.reset_counts()
        q = torch.arange(256, dtype=torch.uint8).reshape(4, 64).view(
            torch.float8_e4m3fn)
        got = comm.all_to_all(q, mesh.model_group)
        assert got is not q and got.dtype == torch.float8_e4m3fn
        assert torch.equal(got.view(torch.uint8), q.view(torch.uint8))
        back = comm.all_to_all(x, mesh.model_group, async_op=True).wait()
        assert torch.equal(back, x)
        assert comm.counts()["all-to-all"] == {"calls": 2,
                                               "bytes": 256 + 4 * 8 * 4}
    finally:
        close_mesh()


# ---------------------------------------------------------------------------
# moe_block_overlapped.
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def reference_block(recipe_name, n_chunks):
    """The reference's moe_block_overlapped (n_chunks) or moe_block (0) on
    toy(): output, drop_frac and the gradients of sum(y**2) by x, w13,
    w2 (numpy)."""
    spec, args = toy()
    jcfg, _ = configs(spec)
    recipe = jget_recipe(recipe_name)
    mesh = make_mesh11()
    kw = {} if n_chunks == 0 else dict(n_chunks=n_chunks)
    block = jmoe.moe_block if n_chunks == 0 else jmoe.moe_block_overlapped

    def body(x, wr, w13, w2):
        y, m = block(recipe, jcfg, x, wr, w13, w2, **kw)
        return y, m["drop_frac"]

    f = shard_map(body, mesh=mesh,
                  in_specs=(P(("data", "model"), None), P(None, None),
                            P("model", None, None), P("model", None, None)),
                  out_specs=(P(("data", "model"), None), P()),
                  check_vma=False)

    def loss(*a):
        y, drop = f(*a)
        return jnp.sum(y.astype(jnp.float32) ** 2), (y, drop)

    jargs = [jnp.asarray(args[0]).astype(jnp.bfloat16)] + \
        [jnp.asarray(a) for a in args[1:]]
    (_, (y, drop)), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 2, 3), has_aux=True))(*jargs)
    return (np.asarray(y, np.float32), float(drop),
            [np.asarray(g, np.float32) for g in grads])


def port_block(recipe, n_chunks, args=None):
    """The port's moe_block_overlapped (n_chunks) or moe_block (0): output,
    drop_frac, the gradients by x, w13, w2 (and the router), the ledger."""
    spec, a = toy() if args is None else args
    _, cfg = configs(spec)
    x, wr, w13, w2 = torch_args(a, requires_grad=True)
    with casts.ledger() as led:
        if n_chunks == 0:
            y, m = moe_block(recipe, cfg, x, wr, w13, w2)
        else:
            y, m = moe_block_overlapped(recipe, cfg, x, wr, w13, w2,
                                        n_chunks=n_chunks)
        (y.to(torch.float32) ** 2).sum().backward()
    return (np32(y), float(m["drop_frac"]),
            [np32(x.grad), np32(w13.grad), np32(w2.grad), np32(wr.grad)],
            led)


@pytest.mark.parametrize("n_chunks", [2, 4])
def test_fp8_flow_overlapped_block_matches_the_reference(n_chunks):
    """Output and the gradients by x, w13 and w2 at cosine >= 0.999
    against the reference's overlapped block (which runs under jax 0.9 for
    fp8_flow), no drops on either side, 2 activation casts."""
    y_r, d_r, g_r = reference_block("fp8_flow", n_chunks)
    y, d, g, led = port_block(get_recipe("fp8_flow"), n_chunks)
    assert d == d_r == 0.0
    assert cos(y, y_r) >= COSINE
    for name, a, b in zip(("x", "w13", "w2"), g, g_r):
        assert cos(a, b) >= COSINE, (name, cos(a, b))
    assert led.activation_casts() == 2, led.summary()
    assert not [e for e in led.events if e.kind == "dequantize"]


@pytest.mark.parametrize("name", ["bf16", "blockwise", "naive_fp8",
                                  "masked"])
@pytest.mark.parametrize("n_chunks", [2, 4])
def test_overlapped_block_matches_the_ports_monolithic_block(name,
                                                             n_chunks):
    """Where the reference's own overlap test fails under jax 0.9 (bf16,
    naive_fp8), and for blockwise and the masked fp8_flow recipe: the
    chunked block against the port's moe_block, every output and gradient
    (the router's too) at cosine >= 0.999, no drops."""
    recipe = get_recipe("fp8_flow", masked_experts=True,
                        swiglu_epilogue=True) if name == "masked" \
        else get_recipe(name)
    y0, d0, g0, _ = port_block(recipe, 0)
    y1, d1, g1, _ = port_block(recipe, n_chunks)
    assert d0 == d1 == 0.0
    assert cos(y0, y1) >= COSINE
    for leaf, a, b in zip(("x", "w13", "w2", "w_router"), g0, g1):
        assert cos(a, b) >= COSINE, (leaf, cos(a, b))


@pytest.mark.parametrize("recipe", ["padded", "masked"])
def test_fp8_flow_keeps_two_casts_at_any_chunk_count(recipe):
    """One entry quantize and one hoisted island quantize: 2 activation
    casts at n = 1, 2 and 4, no explicit dequantize, and the masked
    recipe's outputs and gradients bit for bit the padded ones."""
    kw = dict(masked_experts=True, swiglu_epilogue=True) \
        if recipe == "masked" else {}
    for n in (1, 2, 4):
        y, _, g, led = port_block(get_recipe("fp8_flow", **kw), n)
        assert led.activation_casts() == 2, (n, led.summary())
        assert not [e for e in led.events if e.kind == "dequantize"]
        if recipe == "masked":
            yp, _, gp, _ = port_block(get_recipe("fp8_flow"), n)
            assert np.array_equal(y, yp)
            assert all(np.array_equal(a, b) for a, b in zip(g, gp))


def test_overlapped_block_reports_per_chunk_drops():
    """At capacity factor 0.5 the send drops (at EP = 1 it drops nothing at
    a factor >= 1), and the chunks drop by their own capacities: the
    block's drop fraction is the mean of the chunks' plans' (computed here
    from the router's ids), and it is reported beside the monolithic
    block's."""
    spec, args = toy(cf=0.5, T=256)
    _, cfg = configs(spec)
    y0, d0, _, _ = port_block(get_recipe("bf16"), 0, (spec, args))
    y1, d1, _, _ = port_block(get_recipe("bf16"), 4, (spec, args))
    x, wr, _, _ = torch_args(args)
    _, ids, _ = moe.router_topk(x, wr, cfg.top_k)
    Tc, C_send, _, _ = moe._chunk_geometry(get_recipe("bf16"), cfg, 256, 4,
                                           1, cfg.n_experts)
    want = np.mean([float(moe._dispatch_plan(
        ids[c * Tc:(c + 1) * Tc], cfg.top_k, 1, cfg.n_experts,
        C_send)[3]) for c in range(4)])
    assert d1 == pytest.approx(want, abs=1e-7) and d1 > 0.0
    print(f"drop_frac monolithic {d0:.4f}, 4 chunks {d1:.4f}")


def test_w8_weights_run_the_overlapped_forward():
    """W8-resident (QTensor) experts go through the overlapped prefill as
    through moe_block: the same output at n = 1, close at n = 2."""
    spec, args = toy(T=64)
    _, cfg = configs(spec)
    x, wr, w13, w2 = torch_args(args)
    q13 = quantize_blockwise(w13.to(torch.bfloat16))
    q2 = quantize_blockwise(w2.to(torch.bfloat16))
    rc = get_recipe("fp8_flow")
    with torch.inference_mode():
        y0, _ = moe_block(rc, cfg, x, wr, q13, q2)
        y1, _ = moe_block_overlapped(rc, cfg, x, wr, q13, q2, n_chunks=1)
        y2, m = moe_block_overlapped(rc, cfg, x, wr, q13, q2, n_chunks=2)
    assert torch.equal(y0, y1)
    assert float(m["drop_frac"]) == 0.0 and cos(np32(y0), np32(y2)) >= COSINE


# ---------------------------------------------------------------------------
# moe_block_decode_overlapped.
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def reference_decode(recipe_name, n_chunks):
    spec, args = toy(T=64)
    jcfg, _ = configs(spec)
    recipe = jget_recipe(recipe_name)
    mesh = make_mesh11()
    block = jmoe.moe_block_decode if n_chunks == 0 else \
        functools.partial(jmoe.moe_block_decode_overlapped,
                          n_chunks=n_chunks)

    def body(x, wr, w13, w2):
        y, m = block(recipe, jcfg, x, wr, w13, w2)
        return y, jax.lax.pmean(m["aux_loss"], "model"), m["drop_frac"]

    f = jax.jit(shard_map(body, mesh=mesh,
                          in_specs=(P(None, None), P(None, None),
                                    P("model", None, None),
                                    P("model", None, None)),
                          out_specs=(P(None, None), P(), P()),
                          check_vma=False))
    jargs = [jnp.asarray(args[0]).astype(jnp.bfloat16)] + \
        [jnp.asarray(a) for a in args[1:]]
    y, aux, drop = f(*jargs)
    return np.asarray(y, np.float32), float(aux), float(drop)


@pytest.mark.parametrize("name", ["fp8_flow", "bf16"])
@pytest.mark.parametrize("n_chunks", [2, 4])
def test_decode_overlap_matches_the_reference_and_the_ports_block(
        name, n_chunks):
    spec, args = toy(T=64)
    _, cfg = configs(spec)
    x, wr, w13, w2 = torch_args(args)
    rc = get_recipe(name)
    with torch.inference_mode():
        y0, m0 = moe_block_decode(rc, cfg, x, wr, w13, w2)
        y1, m1 = moe_block_decode_overlapped(rc, cfg, x, wr, w13, w2,
                                             n_chunks=n_chunks)
    y_r, aux_r, d_r = reference_decode(name, n_chunks)
    assert float(m1["drop_frac"]) == d_r == 0.0
    assert cos(np32(y1), y_r) >= COSINE
    assert cos(np32(y1), np32(y0)) >= COSINE
    # the router runs over the whole batch: aux is depth-independent
    assert torch.equal(m0["aux_loss"], m1["aux_loss"])
    assert abs(float(m1["aux_loss"]) - aux_r) <= 1e-5 * abs(aux_r)


# ---------------------------------------------------------------------------
# moe_overlap through the model.
# ---------------------------------------------------------------------------
def _qwen3_forward(cfg, params, batch, moe_overlap):
    drops = []
    orig = lm.moe_block_overlapped

    def spy(*a, **kw):
        y, m = orig(*a, **kw)
        drops.append(float(m["drop_frac"]))
        return y, m

    lm.moe_block_overlapped = spy
    try:
        with casts.ledger() as led:
            loss, _ = lm.forward(cfg, get_recipe("fp8_flow"), params, batch,
                                 plan=lm.ParallelPlan(moe_overlap=moe_overlap))
            loss.backward()
    finally:
        lm.moe_block_overlapped = orig
    grads = {i: np32(p.grad) for i, p in enumerate(tree_leaves(params))}
    for p in tree_leaves(params):
        p.grad = None
    return float(loss.detach()), grads, drops, led.activation_casts()


def test_forward_with_moe_overlap_tracks_the_monolithic_forward():
    """Reduced qwen3 (2 MoE layers, 2 x 64 tokens): the loss within 1e-3
    of the monolithic forward's and every gradient at cosine >= 0.999,
    with DispatchPlan() chunking each MoE layer in two; the casts stay 2 a
    MoE layer."""
    cfg = dataclasses.replace(get_arch("qwen3_moe_235b").reduced(),
                              remat_policy="none")
    params = lm.init_params(cfg, seed=0, device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_()
    batch = make_batch(DataConfig(vocab=cfg.vocab, seq_len=64,
                                  global_batch=2), 0, device="cpu")
    plan = DispatchPlan()
    assert plan.chunks_for(128) == 2
    l0, g0, _, c0 = _qwen3_forward(cfg, params, batch, None)
    l1, g1, drops, c1 = _qwen3_forward(cfg, params, batch, plan)
    print(f"moe_overlap drop_frac by layer {drops}")
    assert len(drops) == cfg.n_layers
    assert abs(l1 - l0) <= 1e-3, (l0, l1)
    assert c0 == c1 == 2 * cfg.n_layers
    for i in g0:
        assert cos(g0[i], g1[i]) >= COSINE, (i, cos(g0[i], g1[i]))
