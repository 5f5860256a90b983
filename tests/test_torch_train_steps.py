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

That bar sits at the CPU's own noise: at lr 3e-3 the loss oscillates from
step ~14 on, and the port's loss alone moves by up to 0.95% (bf16) and
0.69% (naive_fp8) between one and eight intra-op threads (the summation
order of PyTorch's CPU reductions).  The cases of the new recipes fix
that order with one thread (``_one_thread``), so their verdict does not
depend on the machine's core count."""
import torch_threads  # noqa: F401  (first: one intra-op thread)
import contextlib

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
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


@contextlib.contextmanager
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _reference_losses(name, arch="qwen3_moe_235b"):
    """The reference's jitted train step on a 1x1 mesh for STEPS steps:
    (losses, its initial params as numpy)."""
    jcfg = jget_arch(arch).reduced()
    mesh = make_mesh11()
    plan = ParallelPlan(mesh=mesh, dp_axes=("data",))
    jopt = JAdamWConfig(lr=LR)
    jstate = jinit_train_state(jcfg, jopt, jax.random.key(0))
    params_np = jax.tree.map(np.asarray, jstate["params"])
    jstep = jax.jit(jmake_train_step(jcfg, jget_recipe(name), plan,
                                     jopt, total_steps=400, warmup_steps=5))
    jdata = JDataConfig(vocab=jcfg.vocab, seq_len=SEQ, global_batch=BATCH)
    ref = []
    with mesh:
        for i in range(STEPS):
            jstate, m = jstep(jstate, jmake_batch(jdata, i))
            ref.append(float(m["loss"]))
    return ref, params_np


def _port_losses(recipe, params_np, arch="qwen3_moe_235b",
                 threads=contextlib.nullcontext):
    """The port's train step from the same params on the same batches."""
    cfg = get_arch(arch).reduced()
    opt = AdamWConfig(lr=LR)
    state = init_train_state(cfg, opt, device="cpu",
                             params=params_from_numpy(params_np, "cpu"))
    step = make_train_step(cfg, recipe, opt, total_steps=400, warmup_steps=5)
    data = DataConfig(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH)
    got = []
    with threads():
        for i in range(STEPS):
            state, m = step(state, make_batch(data, i, device="cpu"))
            got.append(float(m["loss"]))
    assert isinstance(state["params"]["embed"], torch.Tensor)
    return got


def _track_the_reference_loss(name, threads=contextlib.nullcontext,
                              arch="qwen3_moe_235b"):
    """Returns (the port's losses, the initial params as numpy)."""
    ref, params_np = _reference_losses(name, arch)
    got = _port_losses(get_recipe(name), params_np, arch, threads)
    ref, got = np.array(ref), np.array(got)
    assert np.isfinite(got).all()
    rel = np.abs(got - ref) / np.abs(ref)
    assert rel.max() < 0.01, (rel.max(), got, ref)
    assert got[-5:].mean() < got[:3].mean() - 0.1          # it learns
    return list(got), params_np


def test_twenty_steps_track_the_reference_loss():
    _track_the_reference_loss("fp8_flow")


@pytest.mark.parametrize("name", ["bf16", "blockwise", "naive_fp8"])
def test_twenty_steps_track_the_reference_loss_per_recipe(name):
    _track_the_reference_loss(name, _one_thread)
