"""Stage tracing of the port (``repro_torch.obs.trace``) against the
reference's (``repro.obs.trace``): the stage names, the stage ranges a CPU
``torch.profiler`` run sees in a reduced qwen3_moe_235b forward and in one
paged decode step, and the rule that the ranges add nothing to the step:
a train step with the ranges open under a profiler and one with
``annotate`` patched to a null context give the same losses and updated
parameters bit for bit, the same aten ops (the host syncs,
``aten._local_scalar_dense``, among them) and the same cast ledger."""
import torch_threads  # noqa: F401  (first: one intra-op thread)
import contextlib
import dataclasses
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from repro.obs import trace as jtrace
from repro_torch import obs
from repro_torch.configs import get_arch
from repro_torch.core import casts
from repro_torch.core.moe import DispatchPlan
from repro_torch.core.recipes import get_recipe
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.models import lm
from repro_torch.obs import sink, trace
from repro_torch.optim.adamw import AdamWConfig, tree_leaves
from repro_torch.serve.paged_kv import init_paged_cache
from repro_torch.train.train_step import init_train_state, make_train_step

STAGE_KEYS = {f"stage/{s}" for s in trace.STAGES}


def test_stage_names_are_the_references():
    assert trace.STAGES == jtrace.STAGES
    assert obs.STAGES is trace.STAGES
    assert obs.Span is trace.Span is sink.Span


def test_ranges_open_only_under_a_profiler():
    """No profiler: one shared null context, whatever the name.  Under a
    profiler: a named range, the stage's and a Span's host/<name>."""
    assert trace.annotate("a") is trace.annotate("b")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.stage_annotation("expert"):
            torch.ones(4).sum()
        with obs.Span(None, "fetch") as sp:
            pass
    keys = {e.key for e in prof.key_averages()}
    assert {"stage/expert", "host/fetch"} <= keys
    assert sp.ms >= 0.0


def _reduced(**kw):
    return dataclasses.replace(get_arch("qwen3_moe_235b").reduced(), **kw)


def _keys(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return {e.key for e in prof.key_averages()}


@pytest.mark.parametrize("moe_overlap", [None, DispatchPlan()],
                         ids=["monolithic", "overlapped"])
def test_forward_shows_every_stage(moe_overlap):
    cfg = _reduced()
    params = lm.init_params(cfg, seed=0, device="cpu")
    batch = make_batch(DataConfig(vocab=cfg.vocab, seq_len=64,
                                  global_batch=2), 0, device="cpu")
    with torch.no_grad():
        keys = _keys(lambda: lm.forward(
            cfg, get_recipe("fp8_flow"), params, batch,
            plan=lm.ParallelPlan(moe_overlap=moe_overlap)))
    assert STAGE_KEYS <= keys, sorted(STAGE_KEYS - keys)
    assert "remat/full" in keys


def test_paged_decode_step_shows_every_stage():
    cfg = _reduced()
    params = lm.init_params(cfg, seed=0, device="cpu")
    pools = init_paged_cache(cfg, 8, 8, fp8_kv=True, device="cpu")
    pt = torch.zeros((2, 4), dtype=torch.int64)
    pt[0, 0] = 1
    with torch.inference_mode():
        keys = _keys(lambda: lm.paged_decode_step(
            cfg, get_recipe("fp8_flow"), params, pools, pt,
            torch.tensor([[5], [0]]), torch.tensor([0, 0]),
            torch.tensor([True, False])))
    assert STAGE_KEYS <= keys, sorted(STAGE_KEYS - keys)


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "aten":
            self.ops[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))


def _train_step(ranges: bool):
    """One reduced qwen3 train step (remat 'full', so a checkpoint's
    recompute runs too): the loss, the updated parameters, the aten op
    counts and the ledger; `ranges` opens every range under a CPU
    profiler, else annotate is a null context."""
    cfg = _reduced()
    opt = AdamWConfig(lr=1e-3)
    state = init_train_state(cfg, opt, seed=0, device="cpu")
    step = make_train_step(cfg, get_recipe("fp8_flow"), opt)
    batch = make_batch(DataConfig(vocab=cfg.vocab, seq_len=64,
                                  global_batch=2), 0, device="cpu")
    ctx = profile(activities=[ProfilerActivity.CPU]) if ranges \
        else pytest.MonkeyPatch.context()
    with ctx as c, casts.ledger() as led, _OpCount() as ops:
        if not ranges:
            c.setattr(trace, "annotate",
                      lambda name: contextlib.nullcontext())
        state, m = step(state, batch)
        loss = float(m["loss"])
    if ranges:
        assert STAGE_KEYS <= {e.key for e in c.key_averages()}
    params = [p.detach().clone() for p in tree_leaves(state["params"])]
    return loss, params, ops.ops, led.by_tag()


def test_annotated_train_step_changes_nothing():
    l0, p0, ops0, led0 = _train_step(ranges=False)
    l1, p1, ops1, led1 = _train_step(ranges=True)
    assert l0 == l1
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    assert ops0["aten._local_scalar_dense"] == \
        ops1["aten._local_scalar_dense"]
    assert ops0 == ops1
    assert led0 == led1
