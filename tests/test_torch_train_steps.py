"""20 training steps of qwen3_moe_235b.reduced() in the port against the
reference's jitted ``make_train_step`` on a 1x1 mesh, from the reference's
``init_train_state(key(0))`` parameters carried across bit for bit, on the
same ``make_batch`` batches, for each of the four recipes.

The whole-step reference can only take its XLA route (its Pallas route
fails inside shard_map on this jax; ROADMAP.md, Queue 3), which rounds the
SwiGLU product and the Dgrad-1 output through bf16 before quantizing, and
the linear scales of blockwise and naive_fp8 to bf16 inside its GEMMs; the
port follows the Pallas kernels.  So the bar is the loss, within 1% at
every step (the ROADMAP's bar), not bits.

Each case runs twice.  Routed by its own router (the "own" cases), the
port's first step must route as the reference's did but at router
near-ties (``ROUTE_TIE``, tests/test_torch_arch_train.py's rule); after
that its trajectory may fork
at such ties, and from step ~14, where the loss oscillates at lr 3e-3, the
fork decides the loss by about 1%.  The reference forks alike against
itself when a change computes the same function in other last bits: its
own remat policies 'none' and 'pair' against its config's 'full'
(XLA fuses and rounds the recompute otherwise) move its worst step by
0.67% and 1.08% (naive_fp8), 0.70% and 1.38% (blockwise).  So an
own-routed case is held to 1%, and where it leaves 1%, to 1.5x that
witness, the largest of those two spreads, which must stay under 3% for
the bar to keep its meaning (the witness runs only then).  Routed as the
reference routed at every step (the "routed as the reference" cases: its
expert ids recorded at each step and forced through chip_smoke.routed),
the fork is gone and the port is held to 1% alone (0.06-0.14% here).  The
cases of the new recipes fix the port's summation order with one thread
(``_one_thread``), so their verdict does not depend on the machine's core
count."""
import torch_threads  # noqa: F401  (first: one intra-op thread)
import contextlib
import dataclasses
import functools
import sys
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
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.train.train_step import init_train_state as jinit_train_state
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch.configs import get_arch
from repro_torch.core.recipes import get_recipe
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.train_step import init_train_state, make_train_step
from repro_torch.weights import params_from_numpy
from tests.conftest import make_mesh11

STEPS, LR, SEQ, BATCH = 20, 3e-3, 64, 8
ROOT = Path(__file__).resolve().parents[1]
# tests/test_torch_arch_train.py's near-tie bar on a router's gap
ROUTE_TIE = 1e-3
# the reference's remat policies whose trajectories witness its own spread
# against its config's 'full' ('fp8_resident' computes 'full''s bits)
WITNESS_POLICIES = ("none", "pair")


@contextlib.contextmanager
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@functools.cache
def _reference_losses(name, arch="qwen3_moe_235b", policy=None):
    """The reference's jitted train step on a 1x1 mesh for STEPS steps,
    under its config's remat policy or `policy`: (losses, its initial
    params as numpy, each step's router expert ids by MoE layer: the
    first calls of the step, its forward's)."""
    jcfg = jget_arch(arch).reduced()
    if policy is not None:
        jcfg = dataclasses.replace(jcfg, remat_policy=policy)
    mesh = make_mesh11()
    plan = ParallelPlan(mesh=mesh, dp_axes=("data",))
    jopt = JAdamWConfig(lr=LR)
    jstate = jinit_train_state(jcfg, jopt, jax.random.key(0))
    params_np = jax.tree.map(np.asarray, jstate["params"])
    router_topk, ids = jmoe.router_topk, []

    def recorded(x, w_router, top_k):
        out = router_topk(x, w_router, top_k)
        jax.debug.callback(lambda i: ids.append(np.asarray(i)), out[1])
        return out

    n_moe = jcfg.n_layers - jcfg.n_dense_layers if jcfg.moe else 0
    jdata = JDataConfig(vocab=jcfg.vocab, seq_len=SEQ, global_batch=BATCH)
    ref, ids_by_step = [], []
    with pytest.MonkeyPatch.context() as mp, mesh:
        mp.setattr(jmoe, "router_topk", recorded)
        jstep = jax.jit(jmake_train_step(jcfg, jget_recipe(name), plan,
                                         jopt, total_steps=400,
                                         warmup_steps=5))
        for i in range(STEPS):
            del ids[:]
            jstate, m = jstep(jstate, jmake_batch(jdata, i))
            ref.append(float(m["loss"]))
            jax.effects_barrier()
            ids_by_step.append(list(ids[:n_moe]))
    return np.array(ref), params_np, ids_by_step


def _port_losses(recipe, params_np, arch="qwen3_moe_235b",
                 threads=contextlib.nullcontext, ids_by_step=None):
    """The port's train step from the same params on the same batches:
    (losses, the first step's router calls as chip_smoke.routed records
    them); with `ids_by_step`, each step routed to those expert ids."""
    sys.path.insert(0, str(ROOT))
    from chip_smoke import routed
    cfg = get_arch(arch).reduced()
    opt = AdamWConfig(lr=LR)
    state = init_train_state(cfg, opt, device="cpu",
                             params=params_from_numpy(params_np, "cpu"))
    step = make_train_step(cfg, recipe, opt, total_steps=400, warmup_steps=5)
    data = DataConfig(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH)
    got, first = [], None
    with threads():
        for i in range(STEPS):
            forced = None if ids_by_step is None else [
                torch.from_numpy(np.asarray(a)).long()
                for a in ids_by_step[i]]
            with routed(forced) as calls:
                state, m = step(state, make_batch(data, i, device="cpu"))
            first = calls if first is None else first
            got.append(float(m["loss"]))
    assert isinstance(state["params"]["embed"], torch.Tensor)
    return got, first


def _track_the_reference_loss(name, route, threads=contextlib.nullcontext,
                              arch="qwen3_moe_235b"):
    """Returns (the port's losses, the initial params as numpy, the
    reference's expert ids by step), the port routed by its own router
    (`route` "own") or as the reference routed ("reference's")."""
    ref, params_np, ids_by_step = _reference_losses(name, arch)
    got, first = _port_losses(get_recipe(name), params_np, arch, threads,
                              ids_by_step if route == "reference's" else None)
    got = np.array(got)
    assert np.isfinite(got).all()
    rel = np.abs(got - ref) / np.abs(ref)
    bar = 0.01
    if route == "own":
        # the first step, from the same params: a token routed apart
        # from the reference sits at a near-tie of the port's router
        assert len(first) == len(ids_by_step[0])
        for (ids, gaps), rid in zip(first, ids_by_step[0]):
            moved = (np.sort(ids.numpy(), -1) != np.sort(rid, -1)).any(-1)
            assert (gaps.numpy()[moved] < ROUTE_TIE).all(), gaps[moved]
        if rel.max() >= bar:        # the witness: see the module's doc
            spread = max((np.abs(_reference_losses(name, arch, p)[0] - ref)
                          / np.abs(ref)).max() for p in WITNESS_POLICIES)
            assert spread < 0.03, spread
            bar = 1.5 * spread
    assert rel.max() < bar, (rel.max(), bar, got, ref)
    assert got[-5:].mean() < got[:3].mean() - 0.1          # it learns
    return list(got), params_np, ids_by_step


def test_twenty_steps_track_the_reference_loss():
    _track_the_reference_loss("fp8_flow", "own")


@pytest.mark.parametrize("name", ["bf16", "blockwise", "naive_fp8"])
def test_twenty_steps_track_the_reference_loss_per_recipe(name):
    _track_the_reference_loss(name, "own", _one_thread)


@pytest.mark.parametrize("name", ["fp8_flow", "bf16", "blockwise",
                                  "naive_fp8"])
def test_twenty_steps_routed_as_the_reference_track_its_loss(name):
    _track_the_reference_loss(
        name, "reference's",
        contextlib.nullcontext if name == "fp8_flow" else _one_thread)
