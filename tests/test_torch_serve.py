"""The port's serving slice against the JAX reference on
qwen3_moe_235b.reduced(), with the reference's init_params(key(0)) carried
across bit for bit.

Two reference routes run on the CPU (the reference's Pallas kernels cannot
run inside the engine's shard_map on this jax; ROADMAP.md, Queue 3):
  A  the engine's own path: 1x1 mesh, W8 weights, XLA ops;
  B  the local path: no mesh, bf16 weights, the Pallas kernels in
     interpret mode.
A and B agree to logits cosine ~0.99995 (max abs ~0.01); the port's
SwiGLU follows the Pallas kernel (no bf16 round before the quantize), so
against A the match is a tolerance, not bits.  Bar: cosine >= 0.999 and
the same argmax at every teacher-forced step, against both."""
import torch_threads  # noqa: F401  (first: one intra-op thread)
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core import casts as jcasts
from repro.core.recipes import get_recipe as jget_recipe
from repro.models.lm import NO_PLAN, ParallelPlan
from repro.models.lm import init_params as jinit_params
from repro.models.lm import paged_decode_step as jpaged_decode_step
from repro.models.lm import paged_prefill as jpaged_prefill
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.paged_kv import init_paged_cache as jinit_paged_cache
from repro.serve.scheduler import Request as JRequest
from repro.serve.w8 import quantize_params_for_serving as jquantize_w8
from repro_torch.configs import get_arch
from repro_torch.core import casts, moe
from repro_torch.core.quant import QTensor
from repro_torch.core.recipes import get_recipe
from repro_torch.models.lm import paged_decode_step, paged_prefill
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.serve.paged_kv import init_paged_cache
from repro_torch.serve.scheduler import Request
from repro_torch.serve.w8 import quantize_params_for_serving
from repro_torch.weights import params_from_numpy
from tests.conftest import make_mesh11

PS, MP, BUCKET = 8, 8, 16
PROMPT, STEPS = 9, 3
PAGES = [1, 2]                     # rows 0..11 of one request
# A router near-tie: a live token whose top_k-th and next router
# probabilities are closer than this.  The bf16 rounding of torch and XLA
# differs, so such a token may go to another expert in the two packages.
# Over token seeds 1-4 every step whose smallest gap was >= 6.2e-4 matched
# the reference; the one that did not had a gap of 1.5e-4.
NEAR_TIE = 3e-4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _cos(a, b):
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


def _ref_teacher_forced(cfg, recipe, plan, params, ctx, toks):
    """One paged prefill of the 9-token prompt, then 3 decode steps fed the
    next tokens; returns (per-step last-position logits, prefill ledger)."""
    pools = jinit_paged_cache(cfg, 32, PS, fp8_kv=True)
    ptrow = np.zeros((MP,), np.int32)
    ptrow[:len(PAGES)] = PAGES
    tk = np.zeros((1, BUCKET), np.int32)
    tk[0, :PROMPT] = toks[:PROMPT]
    out = []
    with ctx, jcasts.ledger() as led:
        lg, pools = jpaged_prefill(cfg, recipe, plan, params, pools,
                                   jnp.asarray(ptrow), jnp.asarray(tk),
                                   jnp.int32(PROMPT))
    out.append(np.asarray(lg[0, -1], np.float32))
    pt = np.zeros((2, MP), np.int32)        # slot 1 stays inactive
    pt[0, :len(PAGES)] = PAGES
    with ctx:
        for t in range(STEPS):
            lg, pools = jpaged_decode_step(
                cfg, recipe, plan, params, pools, jnp.asarray(pt),
                jnp.asarray([[toks[PROMPT + t]], [0]], jnp.int32),
                jnp.asarray([PROMPT + t, 0], jnp.int32),
                jnp.asarray([True, False]))
            out.append(np.asarray(lg[0, -1], np.float32))
    return out, led.by_tag()


def _port_teacher_forced(cfg, params, toks, recipe=None):
    """Per-step last-position logits, prefill ledger, and per step the
    smallest router gap (top_k-th minus next probability) over the live
    tokens of every MoE layer (inf for a model without one)."""
    recipe = recipe or get_recipe("fp8_flow")
    port_router_topk, gaps = moe.router_topk, []

    def router_topk(x, w_router, top_k):
        probs = torch.softmax(x.float() @ w_router.float(), dim=-1)
        top = torch.topk(probs, top_k + 1, dim=-1).values
        gaps.append(top[:, top_k - 1] - top[:, top_k])
        return port_router_topk(x, w_router, top_k)

    pools = init_paged_cache(cfg, 32, PS, fp8_kv=True, device="cpu")
    ptrow = torch.zeros((MP,), dtype=torch.int64)
    ptrow[:len(PAGES)] = torch.tensor(PAGES)
    tk = torch.zeros((1, BUCKET), dtype=torch.int64)
    tk[0, :PROMPT] = torch.tensor(toks[:PROMPT])
    out, step_gaps = [], []
    with torch.inference_mode(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(moe, "router_topk", router_topk)
        with casts.ledger() as led:
            lg = paged_prefill(cfg, recipe, params, pools, ptrow, tk, PROMPT)
        out.append(lg[0, -1].float().numpy())
        step_gaps.append(min((float(g[:PROMPT].min()) for g in gaps),
                             default=float("inf")))
        pt = torch.zeros((2, MP), dtype=torch.int64)
        pt[0, :len(PAGES)] = torch.tensor(PAGES)
        for t in range(STEPS):
            gaps.clear()
            lg = paged_decode_step(
                cfg, recipe, params, pools, pt,
                torch.tensor([[toks[PROMPT + t]], [0]]),
                torch.tensor([PROMPT + t, 0]), torch.tensor([True, False]))
            out.append(lg[0, -1].float().numpy())
            step_gaps.append(min((float(g[0]) for g in gaps),
                                 default=float("inf")))
    assert len(gaps) == (cfg.n_layers - cfg.n_dense_layers if cfg.moe else 0)
    return out, led.by_tag(), step_gaps


def _teacher_forced_three_ways(s, token_seed):
    """Route A, route B and the port on the same tokens."""
    toks = [int(t) for t in np.random.default_rng(token_seed).integers(
        1, s["cfg"].vocab, PROMPT + STEPS)]
    mesh = s["mesh"]
    route_a = _ref_teacher_forced(
        s["jcfg"], jget_recipe("fp8_flow"),
        ParallelPlan(mesh=mesh, dp_axes=("data",)), s["jw8"], mesh, toks)
    route_b = _ref_teacher_forced(
        s["jcfg"], jget_recipe("fp8_flow", use_pallas=True), NO_PLAN,
        s["jparams"], contextlib.nullcontext(), toks)
    port = _port_teacher_forced(
        s["cfg"], quantize_params_for_serving(s["params"]), toks)
    return dict(A=route_a, B=route_b, port=port)


@pytest.fixture(scope="module")
def setup():
    jcfg = jget_arch("qwen3_moe_235b").reduced()
    cfg = get_arch("qwen3_moe_235b").reduced()
    jparams = jinit_params(jcfg, jax.random.key(0))
    jw8 = jquantize_w8(jparams)
    params = params_from_numpy(_np_tree(jparams), device="cpu")
    s = dict(jcfg=jcfg, cfg=cfg, jparams=jparams, jw8=jw8, params=params,
             mesh=make_mesh11())
    # token seed 2 has no router near-tie at any step
    s.update(_teacher_forced_three_ways(s, 2))
    return s


@pytest.fixture(scope="module")
def near_tie(setup):
    """Token seed 1: layer 1's router at the second decode step has a
    near-tie (gap 1.5e-4)."""
    return _teacher_forced_three_ways(setup, 1)


def test_params_and_w8_weights_carry_across_bitwise(setup):
    """The port's own W8 quantize of the carried bf16 params is bit-equal
    to the reference's quantize_params_for_serving."""
    mine = quantize_params_for_serving(setup["params"])["layers"]
    ref = params_from_numpy(_np_tree(setup["jw8"]), device="cpu")["layers"]
    for name in ("we13", "we2"):
        assert isinstance(mine[name], QTensor)
        assert mine[name].tile == ref[name].tile
        assert torch.equal(mine[name].data.view(torch.uint8),
                           ref[name].data.view(torch.uint8))
        assert torch.equal(mine[name].scale, ref[name].scale)


@pytest.mark.parametrize("route", ["A", "B"])
def test_teacher_forced_logits_match_reference(setup, route):
    ref, _ = setup[route]
    port, _, gaps = setup["port"]
    assert min(gaps) >= NEAR_TIE, gaps
    for step, (a, b) in enumerate(zip(port, ref)):
        assert _cos(a, b) >= 0.999, (route, step, _cos(a, b))
        assert int(a.argmax()) == int(b.argmax()), (route, step)


@pytest.mark.parametrize("route", ["A", "B"])
def test_teacher_forced_diverges_only_at_router_near_tie(near_tie, route):
    """Every step without a router near-tie matches the reference, the
    steps before the tie and after it; the one step that departs (cosine
    ~0.995 against both routes, which agree with each other) is the step
    whose router has the near-tie, so a routing fault of the port's own
    cannot hide behind the choice of token seed."""
    ref, _ = near_tie[route]
    port, _, gaps = near_tie["port"]
    tied = [g < NEAR_TIE for g in gaps]
    assert tied == [False, False, True, False], gaps
    for step, (a, b) in enumerate(zip(port, ref)):
        match = _cos(a, b) >= 0.999 and int(a.argmax()) == int(b.argmax())
        assert match != tied[step], (route, step, _cos(a, b), gaps[step])


def test_prefill_cast_ledger_matches_reference(setup):
    """Same (kind, tag) events as the engine's reference route.  The
    reference scans the stack, so its trace-time ledger sees one layer;
    the port's eager loop records every layer.  The reference's XLA route
    also records the unfused inner quantize of its SwiGLU
    ('fused_quantize_inner'); the port runs it fused in one kernel, as the
    Pallas route does."""
    _, ref = setup["A"]
    _, port, _ = setup["port"]
    L = setup["cfg"].n_layers
    ref = {k: v * L for k, v in ref.items() if not k[0].endswith("_inner")}
    assert port == ref
    assert sum(n for (kind, _), n in port.items() if kind == "quantize") == L


def _trace(vocab, seed, n, lo, hi, new_lo, new_hi, cls):
    r = np.random.default_rng(seed)
    return [cls(prompt=[int(t) for t in r.integers(1, vocab,
                                                   int(r.integers(lo, hi)))],
                max_new_tokens=int(r.integers(new_lo, new_hi)))
            for _ in range(n)]


def test_engine_admission_eviction_and_pages(setup):
    """Mirror of tests/test_serve_engine.py's end-to-end engine run: a pool
    too small for three full-length requests forces eviction; everyone
    finishes with max_new_tokens and every page comes back."""
    cfg = setup["cfg"]
    ecfg = ServeConfig(max_batch=3, page_size=4, n_pages=7,
                       max_pages_per_req=5, token_budget=64,
                       prefill_buckets=(16,), fp8_kv=True, w8_weights=True)
    eng = ServeEngine(cfg, get_recipe("fp8_flow"), setup["params"], ecfg,
                      device="cpu")
    reqs = _trace(cfg.vocab, 4, 8, 4, 9, 6, 11, Request)
    results = eng.run(reqs, realtime=False)
    assert len(results) == len(reqs)
    assert eng.max_concurrent <= ecfg.max_batch < len(reqs)
    assert eng.sched.n_evictions >= 1
    assert sum(v["n_evictions"] for v in results.values()) == \
        eng.sched.n_evictions
    for req in reqs:
        assert len(results[req.rid]["tokens"]) == req.max_new_tokens
    assert eng.alloc.free_pages == ecfg.n_pages - 1


def test_engine_first_tokens_match_reference_engine(setup):
    """Greedy first tokens of every request equal the reference engine's on
    the same trace (W8 weights, FP8 pages)."""
    kw = dict(max_batch=4, page_size=8, n_pages=32, max_pages_per_req=4,
              token_budget=128, prefill_buckets=(16,), fp8_kv=True,
              w8_weights=True)
    cfg = setup["cfg"]
    jreqs = _trace(cfg.vocab, 5, 5, 4, 12, 2, 3, JRequest)
    reqs = _trace(cfg.vocab, 5, 5, 4, 12, 2, 3, Request)
    jeng = JServeEngine(setup["jcfg"], jget_recipe("fp8_flow"),
                        ParallelPlan(mesh=setup["mesh"], dp_axes=("data",)),
                        setup["jparams"], JServeConfig(**kw))
    jres = jeng.run(jreqs, realtime=False)
    eng = ServeEngine(cfg, get_recipe("fp8_flow"), setup["params"],
                      ServeConfig(**kw), device="cpu")
    res = eng.run(reqs, realtime=False)
    first_ref = [jres[r.rid]["tokens"][0] for r in jreqs]
    first = [res[r.rid]["tokens"][0] for r in reqs]
    assert first == first_ref
    assert all(len(res[r.rid]["tokens"]) == r.max_new_tokens for r in reqs)


def test_bf16_teacher_forced_logits_match_reference(setup):
    """The bf16 recipe (bf16 expert weights, no W8; FP8 paged KV) against
    the reference engine's route A on token seed 2: logits cosine >= 0.999
    and the same argmax at every step, and the same prefill ledger (no
    activation cast; the KV page quantizes)."""
    toks = [int(t) for t in np.random.default_rng(2).integers(
        1, setup["cfg"].vocab, PROMPT + STEPS)]
    mesh = setup["mesh"]
    ref, jled = _ref_teacher_forced(
        setup["jcfg"], jget_recipe("bf16"),
        ParallelPlan(mesh=mesh, dp_axes=("data",)), setup["jparams"], mesh,
        toks)
    port, led, gaps = _port_teacher_forced(setup["cfg"], setup["params"],
                                           toks, recipe=get_recipe("bf16"))
    assert min(gaps) >= NEAR_TIE, gaps
    for step, (a, b) in enumerate(zip(port, ref)):
        assert _cos(a, b) >= 0.999, (step, _cos(a, b))
        assert int(a.argmax()) == int(b.argmax()), step
    L = setup["cfg"].n_layers
    assert led == {k: v * L for k, v in jled.items()}
    assert not any(kind in ("quantize", "dequantize") for kind, _ in led)


@pytest.mark.parametrize("name", ["blockwise", "naive_fp8"])
def test_engine_refuses_recipes_the_reference_cannot_decode(setup, name):
    with pytest.raises(NotImplementedError, match="moe.py:433-438"):
        ServeEngine(setup["cfg"], get_recipe(name), setup["params"],
                    ServeConfig(), device="cpu")
