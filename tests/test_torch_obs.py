"""Telemetry (``obs/metrics.py``, ``obs/sink.py``) and the loop's step
records against the reference on the CPU.

The registry's snapshot and Prometheus text, and the JSONL records of the
same events, steps and registry dumps under a fixed clock, equal the
reference's byte for byte.  The port's loop writes the reference loop's
record kinds, and its step records carry the reference's keys (reduced
qwen15_05b, fp8_flow, guard armed, two steps each)."""
import torch_threads  # noqa: F401  (first: one intra-op thread)
import jax
import numpy as np
import pytest

from repro.configs import get_arch as jget_arch
from repro.core.recipes import get_recipe as jget_recipe
from repro.data.pipeline import DataConfig as JDataConfig
from repro.models.lm import ParallelPlan
from repro.obs import metrics as jmetrics
from repro.obs import sink as jsink
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.train import guards as jguards
from repro.train.loop import run as jrun_loop
from repro.train.train_step import init_train_state as jinit_train_state
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch.configs import get_arch
from repro_torch.core import quant
from repro_torch.core.recipes import get_recipe
from repro_torch.data.pipeline import DataConfig
from repro_torch.obs import metrics, sink
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import guards
from repro_torch.train.loop import fetch_metrics
from repro_torch.train.loop import run as run_loop
from repro_torch.train.train_step import init_train_state, make_train_step


def _drive_registry(m):
    r = m.Registry()
    r.counter("steps_total").inc(3)
    r.counter("guard_events_total", labels={"event": "skip"}).inc()
    r.gauge("loss").set(2.5)
    r.gauge("quant_sat_frac", labels={"site": "q_entry_moe"}).set(0.125)
    h = r.histogram("span_ms", m.po2_buckets(0, 4), labels={"span": "dev"})
    for v in (0.5, 1.5, 3.0, 100.0, 7.25):
        h.observe(v)
    other = m.Histogram("span_ms", m.po2_buckets(0, 4))
    other.observe(2.0)
    h.merge(other)
    r.histogram("lat").observe(0.003)
    return r


def test_registry_and_prometheus_equal_the_reference():
    got, ref = _drive_registry(metrics), _drive_registry(jmetrics)
    assert got.snapshot() == ref.snapshot()
    assert got.to_prometheus() == ref.to_prometheus()
    assert metrics.MS_BUCKETS == jmetrics.MS_BUCKETS


def _drive_telemetry(s, path):
    tel = s.Telemetry(sinks=(s.JsonlSink(str(path)),), clock=lambda: 12.5)
    tel.event("guard", msg="[guard] step=4 event=skip", step=4,
              flags=int(np.uint32(3)))
    tel.record("cast_ledger", step=0, by_tag={"quantize:q_entry": 2})
    tel.per_step_counters["wire_grad_bytes_total"] = 64
    for step in range(3):
        tel.step(step, {"loss": 1.25 - step / 8, "grad_norm": 0.5},
                 spans={"device": 10.0 + step, "fetch": 1.0},
                 extra={"quant_sites": {"q_entry_mlp": {"sat": 0.0,
                                                        "flush": 0.25}}})
    tel.counter("ckpt_saves_total").inc()
    tel.emit_registry(run="a")
    tel.write_prometheus(str(path) + ".prom")
    tel.close()
    return path.read_text(), open(str(path) + ".prom").read()


def test_jsonl_records_equal_the_reference(tmp_path):
    got = _drive_telemetry(sink, tmp_path / "port.jsonl")
    ref = _drive_telemetry(jsink, tmp_path / "ref.jsonl")
    assert got == ref
    assert got[0].count("\n") == 6


def test_memory_sink_and_null_telemetry():
    ms = sink.MemorySink(capacity=2)
    tel = sink.Telemetry(sinks=(ms,))
    for i in range(3):
        tel.record("x", i=i)
    assert [r["i"] for r in ms.of_kind("x")] == [1, 2]
    lines = []
    null = sink.null_telemetry(lines.append)
    assert not null.enabled
    null.event("progress", msg="hello")
    assert lines == ["hello"]
    with null.span("device_step") as sp:
        pass
    assert sp.ms >= 0.0


def test_fetch_metrics_is_one_copy():
    import torch
    m = {"loss": torch.tensor(2.5), "guard_flags": torch.tensor(
        5, dtype=torch.int32), "quant_site_stats": torch.arange(
        6, dtype=torch.float32).reshape(3, 2), "lr": 1e-3}
    out = fetch_metrics(m)
    assert out == {"loss": 2.5, "guard_flags": 5.0, "lr": 1e-3,
                   "quant_site_stats": [[0.0, 1.0], [2.0, 3.0], [4.0, 5.0]]}


@pytest.fixture(scope="module")
def reference_records():
    jcfg = jget_arch("qwen15_05b").reduced()
    plan = ParallelPlan(mesh=None)
    jopt = JAdamWConfig(lr=1e-3)
    guard = jguards.GuardPlan()
    state = jinit_train_state(jcfg, jopt, jax.random.key(0), guard=guard)
    step = jax.jit(jmake_train_step(jcfg, jget_recipe("fp8_flow"), plan,
                                    jopt, total_steps=3, warmup_steps=1,
                                    guard=guard))
    data = JDataConfig(vocab=jcfg.vocab, seq_len=32, global_batch=2)
    ms = jsink.MemorySink()
    _, hist = jrun_loop(step, state, data, n_steps=2, log_every=1,
                        guard_policy=jguards.GuardPolicy(),
                        telemetry=jsink.Telemetry(sinks=(ms,)),
                        log_fn=lambda *a: None)
    return list(ms.records), hist


def test_loop_step_records_carry_the_reference_keys(reference_records):
    ref, ref_hist = reference_records
    cfg = get_arch("qwen15_05b").reduced()
    opt = AdamWConfig(lr=1e-3)
    guard = guards.GuardPlan()
    state = init_train_state(cfg, opt, seed=0, device="cpu", guard=guard)
    step = make_train_step(cfg, get_recipe("fp8_flow"), opt, total_steps=3,
                           warmup_steps=1, guard=guard)
    data = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=2)
    ms = sink.MemorySink()
    lines = []
    tel = sink.Telemetry(sinks=(ms,))
    _, hist = run_loop(step, state, data, n_steps=2, log_every=1,
                       guard_policy=guards.GuardPolicy(), telemetry=tel,
                       log_fn=lines.append)
    got = list(ms.records)
    assert [r["kind"] for r in got] == [r["kind"] for r in ref]
    for a, b in zip(got, ref):
        assert set(a) == set(b), (a["kind"], set(a) ^ set(b))
    steps = [r for r in got if r["kind"] == "step"]
    assert set(steps[0]["quant_sites"]) == set(quant.STAT_SITES)
    for h, rh in zip(hist, ref_hist):
        assert set(h) == set(rh)
        assert (h["device_ms"] + h["fetch_ms"]) <= h["dt"] * 1e3 + 1.0
    # the snapshot of the step's real call: 2 casts a dense MLP (the
    # reference's abstract trace counts its scanned layer body once)
    ledger = [r for r in got if r["kind"] == "cast_ledger"]
    assert len(ledger) == 1
    assert ledger[0]["activation_casts"] == 2 * cfg.n_layers
    assert any(line.startswith("[loop] step=") for line in lines)
    assert "train_loss" in tel.registry.snapshot()["gauges"]
