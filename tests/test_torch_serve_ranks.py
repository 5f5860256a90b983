"""Serving across ranks, on gloo CPU ranks (``torch_dist_harness``).

- The serving cut (``launch.sharding.serving_cut``): each rank keeps its
  E / tp experts (EP) or every expert's F-slice (TP) of the world-1 tree;
  cutting then quantizing to W8 gives the bits of quantizing then
  cutting, and a cut that does not divide, or leaves an F-slice that is
  not a multiple of 128, raises.
- The decode MoE stage on W8 experts at (1, 2) against the reference's
  ``_moe_stage(decode=True)`` on a (1, 2) mesh of forced host devices
  (reduced grok1_314b, ``d_ff_expert`` 256 so that the reference's bf16
  TP block can cut F at TP = 2): TP decode against the reference's
  bf16-weight TP block at TP = 2 and its W8 block at TP = 1; EP decode
  against its W8 EP stage.  Held divergence (ROADMAP.md, Queue 3): the
  reference gives W8 expert leaves the spec ``P(None, ...)`` in TP mode
  (``repro/models/lm.py:408-419``), so every device holds every expert's
  whole F and the combine adds TP whole copies: its W8 output at TP = 2
  is exactly twice its TP = 1 output.  The port keeps the world-1
  arithmetic.
- The engine (EP: reduced qwen3_moe_235b; TP: reduced grok1_314b at
  ``d_ff_expert`` 256) at (data, model) = (1, 2) and (2, 2) against the
  port's world-1 engine on the same trace: the same tokens (token seeds
  without router near-ties, as tests/test_torch_serve.py picks them),
  logits at cosine >= 0.999, every rank the same tokens; a rank whose
  sampled tokens differ raises on every rank; a 1 + 1 DisaggRouter fleet
  at (1, 2) gives the mixed engine's tokens; ``serve_step`` with
  ``plan=`` at (1, 2) gives the world-1 tokens.
- The reference's own engine runs on a (1, 2) mesh of forced host
  devices (jax 0.9 takes it): the port's engine at (1, 2) on the
  reference's init_params tree gives its first token of every request,
  as tests/test_torch_serve.py holds the two engines at 1 x 1.
"""
import torch_threads  # noqa: F401  (first: one intra-op thread)
from concurrent.futures import ThreadPoolExecutor

import ml_dtypes
import numpy as np
import pytest

import torch_dist_ranks as ranks
from torch_dist_harness import run_ranks, run_reference

COSINE = 0.999        # tests/test_torch_tp.py's grouped-GEMM bar
D_FF = 256            # a 128-aligned F-slice at TP = 2
GROK = dict(d_ff_expert=D_FF)


def cos(a, b):
    a = np.concatenate([np.asarray(x, np.float64).ravel() for x in a])
    b = np.concatenate([np.asarray(x, np.float64).ravel() for x in b])
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-300))


# ---------------------------------------------------------------------------
# The serving cut and the decode stage against the reference's.
# ---------------------------------------------------------------------------
REF_CASES = ["tp|bf16|1", "tp|bf16|2", "tp|w8|1", "tp|w8|2", "ep|w8|2"]
PORT_CASES = ["tp|w8", "ep|w8", "tp|bf16"]


def decode_inputs(seed=3, T=8, D=256, E=8):
    r = np.random.default_rng(seed)
    x = r.normal(size=(T, D)).astype(np.float32)
    wr = (r.normal(size=(D, E)) * 0.02).astype(np.float32)
    w13 = (r.normal(size=(E, D, 2, D_FF)) * 0.02).astype(np.float32)
    w2 = (r.normal(size=(E, D_FF, D)) * 0.02).astype(np.float32)
    return x, wr, w13, w2


@pytest.fixture(scope="module")
def decode_stage(tmp_path_factory):
    """The reference's stage over REF_CASES (one process) and the port's
    at (1, 2) over PORT_CASES, run side by side: ({case: y}, ranks)."""
    tmp = str(tmp_path_factory.mktemp("decode_stage"))
    x, wr, w13, w2 = arrays = decode_inputs()
    with ThreadPoolExecutor(1) as pool:
        pending = pool.submit(
            run_reference, "moe_stage_decode", 2, tmp, x_decode=x, wr=wr,
            w13=w13, w2=w2, d_ff=np.array(D_FF), cases=np.array(REF_CASES))
        port = run_ranks(ranks.moe_stage_decode, 2, tmp, ep=2,
                         args=(D_FF, arrays, PORT_CASES))
        ref = pending.result()
    return {c: ref[f"y_{i}"] for i, c in enumerate(REF_CASES)}, port


@pytest.mark.parametrize("case", PORT_CASES)
def test_serving_cut_quantizes_as_the_whole_tree(decode_stage, case):
    """Each rank holds its cut (EP: 4 of 8 experts; TP: every expert's
    128-wide F-slice); for W8, cutting then quantizing gives the bits of
    quantizing the world-1 tree and then cutting it."""
    _, port = decode_stage
    mode, weights = case.split("|")
    want = {"ep": {"we13": (4, 256, 2, D_FF), "we2": (4, D_FF, 256)},
            "tp": {"we13": (8, 256, 2, D_FF // 2),
                   "we2": (8, D_FF // 2, 256)}}[mode]
    i = PORT_CASES.index(case)
    for r in port:
        assert r[i]["shapes"] == want
        assert r[i]["cut_then_quantize"]


@pytest.mark.parametrize("kw, match", [
    (dict(moe_mode="tp", d_ff=128), "not a multiple of 128"),
    (dict(moe_mode="tp", d_ff=384), "not a multiple of 128"),
    (dict(moe_mode="ep", n_experts=6, tp=4), "do not split"),
], ids=["tp_slice_64", "tp_slice_192", "ep_uneven"])
def test_serving_cut_refuses_what_does_not_divide(kw, match):
    """A TP cut that leaves an F-slice off the 128 grid, and an EP cut of
    E that does not divide, raise with a message (no silent bf16 leaf)."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.sharding import serving_cut
    from repro_torch.models.lm import ParallelPlan, init_params
    tp = kw.get("tp", 2)
    cfg = dataclasses.replace(get_arch("grok1_314b").reduced(),
                              d_ff_expert=kw.get("d_ff", 256),
                              n_experts=kw.get("n_experts", 8), n_layers=1)
    plan = ParallelPlan(mesh=Mesh(dp=1, ep=tp, rank=1, device="cpu"),
                        moe_mode=kw["moe_mode"])
    with pytest.raises(ValueError, match=match):
        serving_cut(init_params(cfg, device="cpu"), cfg, plan)


def test_w8_tp_decode_matches_the_reference_bf16_tp_block(decode_stage):
    """The port's TP decode on W8 F-slices at TP = 2 against the
    reference's bf16-weight TP stage at TP = 2 and its W8 stage at TP = 1
    (cosine >= 0.999), the same on both ranks; the port's bf16 TP decode
    likewise; EP decode on each rank's W8 experts against the reference's
    W8 EP stage at EP = 2."""
    ref, port = decode_stage
    for case, want in (("tp|w8", "tp|bf16|2"), ("tp|w8", "tp|w8|1"),
                       ("tp|bf16", "tp|bf16|2"), ("ep|w8", "ep|w8|2")):
        i = PORT_CASES.index(case)
        assert np.array_equal(port[0][i]["y"], port[1][i]["y"]), case
        assert cos([port[0][i]["y"]], [ref[want]]) >= COSINE, (case, want)


def test_reference_w8_tp_decode_adds_tp_whole_copies(decode_stage):
    """The held divergence: the reference's W8 TP stage at TP = 2 is
    exactly twice its TP = 1 stage (every device holds every expert's
    whole F, and the combine sums two copies), where its bf16 TP stage
    at TP = 2 keeps the TP = 1 norm (it cuts F)."""
    ref, _ = decode_stage
    assert np.array_equal(ref["tp|w8|2"], 2 * ref["tp|w8|1"])
    ratio = np.linalg.norm(ref["tp|bf16|2"]) / np.linalg.norm(
        ref["tp|bf16|1"])
    assert abs(ratio - 1.0) < 1e-3, ratio


# ---------------------------------------------------------------------------
# The engine, the fleet and serve_step across ranks.
# ---------------------------------------------------------------------------
def _job(arch, seed, plan_kw=None, **kw):
    return dict(arch=arch, seed=seed, cfg_kw=GROK if arch == "grok1_314b"
                else None, plan_kw=plan_kw, **kw)


EP, TP = dict(moe_mode="ep"), dict(moe_mode="tp")
# world 1: the plan-less engine (the port's single-card path)
WORLD1 = {"qwen3": _job("qwen3_moe_235b", 1),
          "grok": _job("grok1_314b", 2),
          "qwen3_step": _job("qwen3_moe_235b", 1, kind="serve_step")}
RANK_JOBS = {
    "1x2": {"qwen3": _job("qwen3_moe_235b", 1, EP),
            "grok": _job("grok1_314b", 2, TP),
            "qwen3_fleet": _job("qwen3_moe_235b", 1, EP, kind="fleet"),
            "qwen3_step": _job("qwen3_moe_235b", 1, EP, kind="serve_step"),
            "qwen3_realtime": _job("qwen3_moe_235b", 1, EP, spacing=0.05),
            "skew": _job("qwen3_moe_235b", 1, EP, skew_rank=1)},
    "2x2": {"qwen3": _job("qwen3_moe_235b", 1, EP),
            "grok": _job("grok1_314b", 2, dict(
                TP, moe_tp_combine="reduce_scatter"))},
}
LAYOUTS = {"1x2": (2, 2), "2x2": (4, 2)}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """{'1': {job: world-1 result}, layout: {job: the ranks' results}}."""
    from repro_torch.launch.mesh import make_test_mesh
    tmp = str(tmp_path_factory.mktemp("served"))
    out = {"1": dict(zip(WORLD1, ranks.serve(make_test_mesh(),
                                             list(WORLD1.values()))))}
    for layout, (world, tp) in LAYOUTS.items():
        jobs = RANK_JOBS[layout]
        res = run_ranks(ranks.serve, world, tmp, ep=tp,
                        args=(list(jobs.values()),))
        out[layout] = {n: [r[i] for r in res] for i, n in enumerate(jobs)}
    return out


@pytest.mark.parametrize("layout, job", [("1x2", "qwen3"), ("1x2", "grok"),
                                         ("2x2", "qwen3"), ("2x2", "grok")])
def test_engine_across_ranks_serves_as_at_world_1(served, layout, job):
    """EP (qwen3) and TP experts (grok, the local_first combine at (1, 2),
    reduce_scatter at (2, 2)): every rank the world-1 engine's tokens,
    the logits of every tick at cosine >= 0.999 and the same on every
    rank (the decode rows cut over data at (2, 2)); the collectives of
    the mode: EP all-to-alls (prefill) and combine all-reduces (decode),
    TP none of the first; one token all-gather a tick at least."""
    got, one = served[layout][job], served["1"][job]
    for r in got:
        assert r["error"] is None, r["error"]
        assert r["tokens"] == one["tokens"]
        assert cos(r["logits"], one["logits"]) >= COSINE
        for a, b in zip(r["logits"], got[0]["logits"]):
            assert np.array_equal(a, b)
    coll = got[0]["coll"]
    assert (coll["all-to-all"]["calls"] > 0) == (job == "qwen3")
    assert coll["all-gather"]["calls"] >= got[0]["stats"]["ticks"]


def test_a_rank_that_samples_differently_raises(served):
    """Rank 1 moves its sampled tokens by one: the tick's token
    all-gather finds it, and every rank raises (no broadcast of rank 0's
    tokens hides it)."""
    for r in served["1x2"]["skew"]:
        assert r["error"] is not None
        assert "ranks [1] sampled other tokens than rank 0" in r["error"]


def test_realtime_arrivals_are_agreed_across_ranks(served):
    """Requests arriving 50 ms apart against each rank's own clock: the
    ranks admit what every rank has seen arrive (a MIN all-reduce while
    requests are pending), so their schedulers stay in step and every
    rank gives the closed-loop world-1 tokens (no decode drop at this
    batch, so the tokens do not depend on which requests share it)."""
    closed = served["1x2"]["qwen3"][0]["coll"]["all-reduce"]["calls"]
    for r in served["1x2"]["qwen3_realtime"]:
        assert r["error"] is None, r["error"]
        assert r["tokens"] == served["1"]["qwen3"]["tokens"]
        assert r["coll"]["all-reduce"]["calls"] > closed


def test_fleet_across_ranks_gives_the_mixed_engine_tokens(served):
    """A 1 + 1 DisaggRouter fleet at (1, 2), both engines on one plan and
    mesh (each rank migrates pages from its own pool), gives the world-1
    mixed engine's tokens on every rank."""
    for r in served["1x2"]["qwen3_fleet"]:
        assert r["error"] is None, r["error"]
        assert r["tokens"] == served["1"]["qwen3"]["tokens"]
        assert r["stats"]["ticks"] > 0


def test_serve_step_with_plan_serves_as_at_world_1(served):
    """make_serve_step(plan=) at (1, 2) on each rank's serving cut (W8):
    the world-1 fixed-batch tokens on every rank."""
    one = served["1"]["qwen3_step"]["tokens"]
    assert one and all(len(t) == 4 for t in one)
    for r in served["1x2"]["qwen3_step"]:
        assert r["error"] is None, r["error"]
        assert r["tokens"] == one


# ---------------------------------------------------------------------------
# The reference's engine across two devices.
# ---------------------------------------------------------------------------
REF_ECFG = dict(max_batch=4, page_size=8, n_pages=48, max_pages_per_req=4,
                token_budget=256, prefill_buckets=(32,))


def _tree(ref):
    """The reference engine task's 'p:<path>:<dtype>' leaves as a nested
    numpy tree (bf16 leaves as ml_dtypes views, as jax hands them out)."""
    out = {}
    for key, a in ref.items():
        if not key.startswith("p:"):
            continue
        _, path, dt = key.split(":")
        node = out
        *parents, leaf = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = a.view(getattr(ml_dtypes, dt)) if dt == "bfloat16" \
            else a
    return out


def test_engine_at_1x2_gives_the_reference_engines_first_tokens(tmp_path):
    """The reference's ServeEngine on a (1, 2) mesh (EP: its 8 experts 4
    a device, W8, FP8 pages) and the port's at (1, 2) on gloo, both from
    the reference's init_params(key(0)) tree: every request's first
    token equal, every port rank the same tokens."""
    reqs = ranks.serve_trace(512, 1)
    P = max(len(q.prompt) for q in reqs)
    prompts = np.zeros((len(reqs), P), np.int64)
    for i, q in enumerate(reqs):
        prompts[i, :len(q.prompt)] = q.prompt
    e = REF_ECFG
    ref = run_reference(
        "engine", 2, tmp_path, prompts=prompts,
        lens=np.array([len(q.prompt) for q in reqs]), new=np.array(4),
        n=np.array(2), ecfg=np.array([e["max_batch"], e["page_size"],
                                      e["n_pages"], e["max_pages_per_req"],
                                      e["token_budget"],
                                      e["prefill_buckets"][0]]))
    job = _job("qwen3_moe_235b", 1, EP, params_np=_tree(ref),
               ecfg_kw=REF_ECFG)
    got = run_ranks(ranks.serve, 2, tmp_path, ep=2, args=([job],))
    first_ref = [int(t[0]) for t in ref["tokens"]]
    for r in got:
        assert r[0]["error"] is None, r[0]["error"]
        assert r[0]["tokens"] == got[0][0]["tokens"]
        assert [t[0] for t in r[0]["tokens"]] == first_ref
