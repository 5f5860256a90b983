"""The reference's production plan (``make_plan``), the TP-sharded expert
block, the TP dense MLP and the FSDP weight gathers, on gloo ranks.

- ``launch.sharding.make_plan`` picks the reference's levers for all
  twelve configs on stand-in meshes (it reads only the shape and the axis
  names; the reference reads its two keywords from the environment), and
  its weight cuts at (16, 16) are the reference's ``param_specs`` but for
  the FSDP cuts held out in ROADMAP.md, Queue 3 (``HELD_WHOLE``).
- ``moe_block_tp`` on 2 and 4 CPU ranks (every rank the whole x and
  router, its F-slice of every expert; ``torch_dist_harness.run_ranks``)
  against the reference's in a jitted ``check_vma=False`` ``shard_map``
  over a (1, TP) mesh, at tests/test_torch_ep.py's cosine bar, no drop on
  either side: the output and the w13 / w2 / router gradients against
  the reference's at the same TP, the input gradient against the
  reference's at TP = 1.  Held divergence (ROADMAP.md, Queue 3): at TP >
  1 the reference's ``check_vma=False`` transpose sums every device's
  cotangent of the replicated x, whose FFN part its ``gx_axes`` psum has
  already summed, so its input gradient is about TP times the single
  device's; the port's is the single device's.
- Reduced qwen3 and grok (TP experts, FSDP) and qwen15 / deepseek_v2_lite
  (the TP MLP, FSDP) train at (data, model) = (1, 2) and (2, 2) against
  the port's world-1 step on the same global batches, no assignment
  dropped or past an expert's capacity.
- A checkpoint saved at (2, 2) with TP experts and FSDP holds the world-1
  tree and restores at world 1 and at (4, 1) bit for bit.
"""
import torch_threads  # noqa: F401  (first: one intra-op thread)

import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from repro_torch.configs import ARCH_IDS, get_arch
from torch_dist_harness import run_ranks, run_reference

COSINE = 0.999        # tests/test_torch_ep.py's bar
LOSS_RTOL = 1e-3      # the router's aux loss is each model group's


def cos(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-300))


class _StandInMesh:
    """What make_plan reads of a mesh: its axis names and shape."""

    def __init__(self, shape):
        self.shape = dict(zip(("data", "model"), shape))
        self.axis_names = ("data", "model")


@pytest.mark.parametrize("arch", sorted(ARCH_IDS))
def test_make_plan_is_the_references(arch, monkeypatch):
    """The port's make_plan against the reference's, at the reference's
    (16, 16) production shape and at (2, 2) and (4, 1): moe_mode (EP iff
    E splits over the model axis), fsdp_axis ('data' iff cfg.fsdp),
    dp_axes, and the combine and the MLP's TP mode (keywords in the port,
    the environment in the reference)."""
    from repro.configs import get_arch as jget_arch
    from repro.launch.sharding import make_plan as jmake_plan
    from repro_torch.launch.sharding import make_plan
    for shape in ((16, 16), (2, 2), (4, 1)):
        for combine, mlp_tp in (("local_first", False),
                                ("reduce_scatter", True)):
            monkeypatch.setenv("REPRO_MOE_TP_COMBINE", combine)
            monkeypatch.setenv("REPRO_MLP_TP", "1" if mlp_tp else "0")
            mesh = _StandInMesh(shape)
            ref = jmake_plan(jget_arch(arch), mesh)
            got = make_plan(get_arch(arch), mesh, moe_tp_combine=combine,
                            mlp_tp=mlp_tp)
            for f in ("moe_mode", "fsdp_axis", "dp_axes", "tp_axis",
                      "moe_tp_combine", "mlp_tp"):
                assert getattr(got, f) == getattr(ref, f), (shape, f)
            assert got.mesh is mesh


# The leaves whose FSDP cut the port leaves out at the reference's (16, 16)
# shape (ROADMAP.md, Queue 3): the cut would leave a d_model slice that is
# not a multiple of 128 (7168 / 16 = 448, 3584 / 16 = 224, 2560 / 16 = 160,
# 1024 / 16 = 64), whose (rows, 128) split-state encodings would straddle
# the blocks; each rank keeps the leaf whole on that axis instead.
HELD_WHOLE = {"deepseek_v3_671b": ("we2", "w2", "ws2"),
              "gemma2_9b": ("w2",), "gemma3_4b": ("w2",),
              "llava_next_34b": ("w2",), "seamless_m4t_v2": ("w2",)}


@pytest.mark.parametrize("arch", sorted(ARCH_IDS))
def test_weight_cuts_are_the_references_at_16x16(arch):
    """The port's cuts of the expert, dense-MLP and shared-expert leaves
    under make_plan at (16, 16) against the reference's param_specs with
    tree_specs' rule (a cut only where it divides the stacked leaf): the
    same, but for HELD_WHOLE's leaves, which lack just the 'data' cut."""
    from repro.configs import get_arch as jget_arch
    from repro.launch.sharding import param_specs
    from repro_torch.launch.sharding import make_plan
    from repro_torch.models.lm import layer_weight_shape
    mesh = _StandInMesh((16, 16))
    cfg = get_arch(arch)
    plan = make_plan(cfg, mesh)
    spec_of = param_specs(jget_arch(arch), mesh)
    held = []
    for name in ("we13", "we2", "w13", "w2", "ws13", "ws2"):
        shape = layer_weight_shape(cfg, name)
        if shape is None:
            continue
        full = (cfg.n_layers, *shape)
        spec = tuple(spec_of(f"layers.{name}", len(full)))
        ref = {(ax, m) for ax, (n, m) in enumerate(zip(full, spec))
               if m is not None and n % mesh.shape[m] == 0}
        got = {(ax + 1, m) for ax, m in plan.weight_cuts(name, shape)}
        if got != ref:
            assert ref - got == {(len(full) - 1, "data")} and got < ref, \
                (name, ref, got)
            assert (shape[-1] // 16) % 128, (name, shape)
            held.append(name)
    assert tuple(held) == HELD_WHOLE.get(arch, ())


# ---------------------------------------------------------------------------
# moe_block_tp against the reference's.
# ---------------------------------------------------------------------------
CASES = {2: ["bf16|2|local_first", "fp8_flow|2|psum_first",
             "fp8_flow|2|local_first", "masked|2|reduce_scatter"],
         4: ["fp8_flow|4|reduce_scatter", "bf16|4|psum_first",
             "masked|4|local_first"]}


def toy(seed=1, T=256, D=256, F=512, E=4, topk=2, cf=4.0):
    """Ample capacity; F = 512 keeps a 128-aligned slice at TP = 4."""
    r = np.random.default_rng(seed)
    x = r.normal(size=(T, D)).astype(np.float32)
    x = torch.tensor(x).to(torch.bfloat16).to(torch.float32).numpy()
    wr = (r.normal(size=(D, E)) * 0.02).astype(np.float32)
    w13 = (r.normal(size=(E, D, 2, F)) * 0.05).astype(np.float32)
    w2 = (r.normal(size=(E, F, D)) * 0.05).astype(np.float32)
    return (E, topk, cf), (x, wr, w13, w2)


@pytest.fixture(scope="module")
def tp_results(tmp_path_factory):
    """The port's ranks at TP = 2 and 4, and one reference run over every
    case and its TP = 1 twin: {case: (port ranks, reference, TP = 1)}."""
    from concurrent.futures import ThreadPoolExecutor
    tmp = str(tmp_path_factory.mktemp("tp"))
    spec, arrays = toy()
    x, wr, w13, w2 = arrays
    cases = [c for tp in CASES for c in CASES[tp]]
    ones = sorted({c.split("|")[0] + "|1|" + c.split("|")[2] for c in cases})
    allc = cases + ones
    # the reference's process runs while the port's ranks do
    with ThreadPoolExecutor(1) as pool:
        pending = pool.submit(
            run_reference, "tp_blocks", 4, tmp, x=x, wr=wr, w13=w13, w2=w2,
            spec=np.array(spec, np.float64), cases=np.array(allc))
        port = {tp: run_ranks(ranks.tp_block, tp, tmp, ep=tp,
                              args=(spec, arrays, CASES[tp]))
                for tp in CASES}
        ref = pending.result()

    def of(case):
        j = allc.index(case)
        return {k.rsplit("_", 1)[0]: v for k, v in ref.items()
                if k.endswith(f"_{j}")}
    out = {}
    for tp, cs in CASES.items():
        for i, case in enumerate(cs):
            name, _, combine = case.split("|")
            out[case] = ([r[i] for r in port[tp]], of(case),
                         of(f"{name}|1|{combine}"))
    return out


@pytest.mark.parametrize("case", [c for tp in CASES for c in CASES[tp]])
def test_tp_block_matches_the_reference(tp_results, case):
    """Output, router, w13 and w2 gradients at cosine >= 0.999 against the
    reference's block at the same TP (the F-slices stitched), the input
    gradient against its TP = 1 block's, no drop on either side; every
    rank holds the same input and router gradients; fp8_flow and the
    masked recipe keep 2 activation casts, and their Dgrad-1 records the
    'dgrad_epilogue' quantize after the all-reduce (#3 then #1)."""
    got, ref, one = tp_results[case]
    name, tp, combine = case.split("|")
    tp = int(tp)
    assert all(g["drop"] == 0.0 for g in got)
    assert float(np.max(ref["drop"])) == 0.0
    y = np.concatenate([g["y"] for g in got]) \
        if combine == "reduce_scatter" else got[0]["y"]
    assert cos(y, ref["y"]) >= COSINE
    gw13 = np.concatenate([g["gw13"] for g in got], axis=-1)
    gw2 = np.concatenate([g["gw2"] for g in got], axis=1)
    for k, a in (("w13", gw13), ("w2", gw2), ("wr", got[0]["gwr"])):
        assert cos(a, ref[f"g{k}"]) >= COSINE, (case, k)
    assert cos(got[0]["gx"], one["gx"]) >= COSINE
    for g in got[1:]:
        assert np.array_equal(g["gx"], got[0]["gx"])
        assert np.array_equal(g["gwr"], got[0]["gwr"])
    if name != "bf16":
        assert all(g["casts"] == 2 for g in got)
        assert all("fused_quantize:dgrad_epilogue" in g["tags"]
                   and "fused_quantize_inner:dgrad_out" in g["tags"]
                   for g in got)
    # the held divergence: the reference's input gradient at TP > 1 is
    # about TP times the single device's (the port's)
    ratio = np.linalg.norm(ref["gx"]) / np.linalg.norm(got[0]["gx"])
    assert 0.8 * tp < ratio < 1.2 * tp, ratio


def test_tp_block_collectives(tp_results):
    """No all-to-all; the forward's combine and the backward's input-
    gradient partial sum: psum_first and local_first all-reduce (plus the
    probabilities' cotangent under local_first), reduce_scatter one
    reduce-scatter forward and one all-gather backward."""
    want = {"psum_first": (2, 0, 0), "local_first": (3, 0, 0),
            "reduce_scatter": (2, 1, 1)}
    for case, (got, _, _) in tp_results.items():
        c = got[0]["coll"]
        assert c["all-to-all"]["calls"] == 0
        ar, rs, ag = want[case.split("|")[2]]
        assert (c["all-reduce"]["calls"], c["reduce-scatter"]["calls"],
                c["all-gather"]["calls"]) == (ar, rs, ag), (case, c)


# ---------------------------------------------------------------------------
# Training steps on (data, model) = (1, 2) and (2, 2).
# ---------------------------------------------------------------------------
KW = dict(ep_cf=4.0, n_total=400)
WIDE = dict(d_ff_expert=256)          # a 128-aligned F-slice at TP = 2
JOBS = {
    "qwen3_tp_fsdp": ("qwen3_moe_235b", "bf16", WIDE,
                      dict(moe_mode="tp", fsdp_axis="data")),
    "qwen3_tp_rs": ("qwen3_moe_235b", "fp8_flow", WIDE,
                    dict(moe_mode="tp", fsdp_axis="data",
                         moe_tp_combine="reduce_scatter")),
    "grok_tp": ("grok1_314b", "bf16", WIDE,
                dict(moe_mode="tp", moe_tp_combine="psum_first",
                     fsdp_axis="data")),
    "qwen15_mlp_tp": ("qwen15_05b", "fp8_flow", None,
                      dict(mlp_tp=True, fsdp_axis="data")),
    "dsv2_mlp_tp": ("deepseek_v2_lite", "bf16", WIDE,
                    dict(mlp_tp=True, fsdp_axis="data", moe_mode="tp")),
}
LAYOUTS = {"1x2": (2, 2), "2x2": (4, 2)}


def _job(name, plan_kw=None):
    arch, recipe, cfg_kw, pkw = JOBS[name]
    return ((arch, recipe, None, 2),
            dict(KW, cfg_kw=cfg_kw, init_grads=True,
                 plan_kw=pkw if plan_kw is None else plan_kw))


@pytest.fixture(scope="module")
def tp_steps(tmp_path_factory):
    """Every job at world 1 (its plain step) and at both layouts, each
    world one spawn: {layout: {job: ranks' results}}."""
    tmp = str(tmp_path_factory.mktemp("tp_steps"))
    names = list(JOBS)
    out = {"1": dict(zip(names, run_ranks(
        ranks.train_many, 1, tmp, args=([_job(n, {}) for n in names],))[0]))}
    for layout, (world, tp) in LAYOUTS.items():
        res = run_ranks(ranks.train_many, world, tmp, ep=tp,
                        args=([_job(n) for n in names],))
        out[layout] = {n: [r[i] for r in res] for i, n in enumerate(names)}
    return out


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("job", list(JOBS))
def test_tp_and_fsdp_train_as_at_world_1(tp_steps, job, layout):
    """Two steps on the layout against the port's world-1 step on the same
    global batches: no assignment dropped or past an expert's capacity on
    either side; every rank keeps the same replicated parameters and
    losses; the losses within 1e-3 (the aux loss is each model group's
    mean, as the reference's); the first batch's reduced gradients of the
    cross-entropy (every cut leaf gathered) at cosine >= 0.999 leaf by
    leaf, but for fp8_flow's expert weights, whose gradients follow the
    padding layout (tests/test_torch_ep.py)."""
    got, one = tp_steps[layout][job], tp_steps["1"][job]
    for r in got + [one]:
        assert not r["drops"] or max(r["drops"]) == 0.0
        assert not r["overflow"] or max(r["overflow"]) == 0
    for r in got[1:]:
        assert r["losses"] == got[0]["losses"]
        for k in one["params"]:
            assert np.array_equal(r["params"][k], got[0]["params"][k]), k
    for a, b in zip(got[0]["losses"], one["losses"]):
        assert abs(a - b) <= LOSS_RTOL * abs(b), (got[0]["losses"],
                                                  one["losses"])
    fp8 = JOBS[job][1] != "bf16"
    for k, g in one["grads"].items():
        if fp8 and k in ("we13", "we2"):
            continue
        assert cos(got[0]["grads"][k], g) >= COSINE, \
            (k, cos(got[0]["grads"][k], g))


def test_tp_fsdp_checkpoint_restores_at_world_1_and_4x1(tmp_path):
    """The plain step's checkpoint at (2, 2) (reduced qwen3, fp8_flow, TP
    experts with FSDP, the FP8-split AdamW state, saved at step 2 of 3)
    holds the world-1 tree: every cut leaf (params, moments, master
    weights, the (rows, 128) encodings) gathered over both axes and
    written by rank 0 alone.  Restored at world 1 and at (4, 1) (FSDP over
    four data ranks), the gathered params and AdamW state are the saving
    run's byte for byte."""
    from repro_torch.dist.opt_state import StatePolicy
    d = str(tmp_path / "ckpt")
    args = ("qwen3_moe_235b", "fp8_flow", None, 3)
    kw = dict(KW, cfg_kw=WIDE, state_policy=StatePolicy(), ckpt_dir=d,
              ckpt_every=2, full_state=True)
    saved = run_ranks(ranks.train, 4, tmp_path, ep=2, args=args, kwargs=dict(
        kw, plan_kw=dict(moe_mode="tp", fsdp_axis="data")))
    assert any(k.endswith("we13.data") for k in saved[0]["opt"])
    back1 = run_ranks(ranks.train, 1, tmp_path, args=args, kwargs=kw)
    back4 = run_ranks(ranks.train, 4, tmp_path, ep=1, args=args,
                      kwargs=dict(kw, plan_kw=dict(fsdp_axis="data")))
    for back in (back1[0], back4[0]):
        assert back["losses"] == []             # restored past step 2
        for part in ("opt", "params"):
            for k, v in saved[0][part].items():
                assert np.array_equal(np.asarray(back[part][k]),
                                      np.asarray(v)), (part, k)


def test_stage_layers_runs_the_same_program():
    """ParallelPlan(stage_layers=True), the reference's switch to its
    unrolled staged program, selects the program the port always runs:
    two steps of reduced qwen3 (TP experts, group-less) with it on and off
    give the same losses and parameters bit for bit."""
    from repro_torch.core.recipes import get_recipe
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.lm import ParallelPlan
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.train_step import init_train_state, make_train_step
    import dataclasses
    cfg = dataclasses.replace(get_arch("qwen3_moe_235b").reduced(), **WIDE)
    opt = AdamWConfig(lr=1e-3)
    out = []
    for on in (False, True):
        plan = ParallelPlan(mesh=make_test_mesh(), moe_mode="tp",
                            stage_layers=on)
        state = init_train_state(cfg, opt, device="cpu", plan=plan)
        step = make_train_step(cfg, get_recipe("fp8_flow"), opt, plan=plan)
        losses = []
        for i in range(2):
            batch = make_batch(DataConfig(vocab=cfg.vocab, seq_len=32,
                                          global_batch=4), i, device="cpu")
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        out.append((losses, ranks.tree_np(state["params"])))
    assert out[0][0] == out[1][0]
    for k, v in out[0][1].items():
        assert np.array_equal(out[1][1][k], v), k
