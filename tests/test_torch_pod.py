"""The pod axis: the reference's (pod, data, model) mesh
(``repro/launch/mesh.py:12-18``) on gloo CPU ranks.

- The port's rank layout is ``make_mesh((pod, data, model), ...)``'s
  device order (the reference's own, on forced host devices), and its
  groups are the mesh's axes.
- ``make_plan`` gives the reference's ``dp_axes`` (('pod', 'data') on a
  pod mesh) and ``ParallelPlan`` takes them from the mesh.
- Training at (pod, data, model) = (2, 1, 2) (EP experts) and (2, 2, 1)
  (FSDP over data, the pod axis pure data parallelism) equals the port's
  world-1 step on the same global batches, as
  tests/test_torch_tp.py::test_tp_and_fsdp_train_as_at_world_1 holds the
  (data, model) layouts.
- ``--multi-pod`` trains on two ranks (pod = 2, data = world / (2 tp));
  a world that does not divide raises, and so does the DistPlan wire on
  a pod axis larger than one (the reference's wire needs a DP-only
  mesh).
"""
import torch_threads  # noqa: F401  (first: one intra-op thread)
import itertools

import numpy as np
import pytest

import torch_dist_ranks as ranks
from torch_dist_harness import run_ranks, run_reference

COSINE = 0.999
LOSS_RTOL = 1e-3      # the router's aux loss is each rank's


def cos(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-300))


@pytest.mark.parametrize("sizes", [(2, 2, 2), (4, 2)],
                         ids=["pod_data_model", "data_model"])
def test_rank_layout_is_make_mesh_order(sizes, tmp_path):
    """The rank at each (pod, data, model) coordinate is the device id
    the reference's make_mesh puts there; Mesh.index reads it back."""
    from repro_torch.launch.mesh import Mesh, rank_of
    shape = np.zeros((3,), np.int64)
    shape[-len(sizes):] = sizes
    ids = run_reference("mesh_layout", 8, tmp_path,
                        shapes=shape[None])["ids_0"]
    names = ("pod", "data", "model")[-len(sizes):]
    for coords in itertools.product(*(range(n) for n in sizes)):
        r = rank_of(coords, sizes)
        assert r == ids[coords], (coords, r, ids[coords])
        pod = sizes[0] if len(sizes) == 3 else None
        m = Mesh(dp=sizes[-2], ep=sizes[-1], rank=r, device="cpu", pod=pod)
        assert tuple(m.index(a) for a in names) == coords
        assert m.axis_names == names and m.world == 8


class _StandInMesh:
    """What make_plan reads of a mesh: its axis names and shape."""

    def __init__(self, shape, names):
        self.shape = dict(zip(names, shape))
        self.axis_names = names


@pytest.mark.parametrize("arch", ["qwen3_moe_235b", "grok1_314b",
                                  "qwen15_05b"])
def test_make_plan_dp_axes_are_the_references(arch):
    """On the reference's (2, 16, 16) multi-pod mesh and its (16, 16)
    mesh, the port's make_plan gives the reference's dp_axes, moe_mode
    and fsdp_axis; a ParallelPlan on a pod mesh defaults to ('pod',
    'data') and refuses ('data',)."""
    from repro.configs import get_arch as jget_arch
    from repro.launch.sharding import make_plan as jmake_plan
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.sharding import make_plan
    from repro_torch.models.lm import ParallelPlan
    for shape, names in (((2, 16, 16), ("pod", "data", "model")),
                         ((16, 16), ("data", "model"))):
        mesh = _StandInMesh(shape, names)
        ref, got = jmake_plan(jget_arch(arch), mesh), make_plan(
            get_arch(arch), mesh)
        for f in ("dp_axes", "moe_mode", "fsdp_axis", "tp_axis"):
            assert getattr(got, f) == getattr(ref, f), (shape, f)
    pod = Mesh(dp=2, ep=2, rank=0, device="cpu", pod=2)
    assert ParallelPlan(mesh=pod).dp_axes == ("pod", "data")
    with pytest.raises(ValueError, match="data-parallel axes"):
        ParallelPlan(mesh=pod, dp_axes=("data",))


KW = dict(ep_cf=4.0, n_total=400)
JOBS = {"qwen3_ep": ("qwen3_moe_235b", "fp8_flow", None, {}),
        "dsv2_fsdp": ("deepseek_v2_lite", "bf16", dict(d_ff_expert=256),
                      dict(fsdp_axis="data"))}
LAYOUTS = {"2x1x2": (2, 2), "2x2x1": (2, 1)}      # (pod, model)


def _job(name, world1=False):
    arch, recipe, cfg_kw, pkw = JOBS[name]
    return ((arch, recipe, None, 2),
            dict(KW, cfg_kw=cfg_kw, init_grads=True,
                 plan_kw={} if world1 else pkw))


@pytest.fixture(scope="module")
def pod_steps(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("pod_steps"))
    names = list(JOBS)
    out = {"1": dict(zip(names, run_ranks(
        ranks.train_many, 1, tmp,
        args=([_job(n, True) for n in names],))[0]))}
    for layout, (pod, tp) in LAYOUTS.items():
        res = run_ranks(ranks.train_many, 4, tmp, ep=tp, pod=pod,
                        args=([_job(n) for n in names],))
        out[layout] = {n: [r[i] for r in res] for i, n in enumerate(names)}
    return out


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("job", list(JOBS))
def test_pod_mesh_trains_as_at_world_1(pod_steps, job, layout):
    """Two steps on the pod layout against the world-1 step: no drop or
    overflow; every rank the same losses and replicated params; losses
    within 1e-3; the first batch's reduced cross-entropy gradients (cut
    leaves gathered) at cosine >= 0.999 leaf by leaf, but fp8_flow's
    expert weights (tests/test_torch_ep.py)."""
    got, one = pod_steps[layout][job], pod_steps["1"][job]
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
        assert cos(got[0]["grads"][k], g) >= COSINE, k


def test_multi_pod_launcher(tmp_path):
    """--multi-pod on two ranks builds the (2, 1, 1) mesh and trains; at
    world 1 it raises (2 pods do not divide one rank), and the DistPlan
    wire refuses a pod axis larger than one."""
    from repro_torch.configs import get_arch
    from repro_torch.core.recipes import get_recipe
    from repro_torch.dist.plan import DistPlan
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.train import main
    from repro_torch.models.lm import ParallelPlan
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.train_step import make_train_step
    argv = ["--reduced", "--device", "cpu", "--multi-pod", "--steps", "2",
            "--seq-len", "32", "--global-batch", "4"]
    got = run_ranks(ranks.launch_train, 2, tmp_path, args=(argv,))
    assert len(got[0]) == 2 and got[0] == got[1]
    assert all(np.isfinite(x) for x in got[0])
    with pytest.raises(ValueError, match="does not divide the world 1"):
        main(argv)
    plan = ParallelPlan(mesh=Mesh(dp=2, ep=1, rank=0, device="cpu", pod=2))
    with pytest.raises(ValueError, match="pod axis"):
        make_train_step(get_arch("qwen15_05b").reduced(),
                        get_recipe("fp8_flow"), AdamWConfig(),
                        dist=DistPlan(), plan=plan)
