"""Structured event + metric sinks, and the Telemetry facade the train
loop and the launchers talk to.

A copy of ``repro.obs.sink``.  ``Span``, the host wall-clock span, lives
in ``obs/trace.py`` as in the reference and is re-exported here, so
``from repro_torch.obs.sink import Span`` keeps working.

Every record is one flat JSON-able dict with at least {"t": wall-clock
seconds, "kind": <event kind>}.  Three sinks:

  JsonlSink     one JSON line per record, append-only — the run artifact
                the reference's `python -m repro.obs.report` reads.
  MemorySink    bounded in-memory ring (tests, and the reporter's live use).
  NullSink      swallows everything (telemetry off).

The Telemetry facade binds a Registry + sinks + the legacy human log_fn:
typed events replace the loop's former unstructured f-strings — each
`tel.event(kind, msg=..., **fields)` writes the structured record to the
sinks AND renders the human line through log_fn, so `--obs` changes what is
*kept*, not what is printed.
"""
from __future__ import annotations

import json
import time
from collections import deque
from typing import Dict, Iterable, List, Optional

from repro_torch.obs.metrics import MS_BUCKETS, Registry
from repro_torch.obs.trace import Span  # noqa: F401  (re-exported)


class NullSink:
    def emit(self, record: dict) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class JsonlSink(NullSink):
    """Append-only JSONL file sink (one record per line)."""

    def __init__(self, path: str):
        self.path = str(path)
        self._f = open(self.path, "a", buffering=1)

    def emit(self, record: dict) -> None:
        self._f.write(json.dumps(record, default=_json_default,
                                 sort_keys=True) + "\n")

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class MemorySink(NullSink):
    """Bounded in-memory ring, for tests and live inspection."""

    def __init__(self, capacity: int = 65536):
        self.records: deque = deque(maxlen=capacity)

    def emit(self, record: dict) -> None:
        self.records.append(record)

    def of_kind(self, kind: str) -> List[dict]:
        return [r for r in self.records if r.get("kind") == kind]


class MultiSink(NullSink):
    def __init__(self, *sinks):
        self.sinks = sinks

    def emit(self, record: dict) -> None:
        for s in self.sinks:
            s.emit(record)

    def flush(self) -> None:
        for s in self.sinks:
            s.flush()

    def close(self) -> None:
        for s in self.sinks:
            s.close()


def _json_default(o):
    """numpy scalars/arrays and other array-likes -> plain python."""
    if hasattr(o, "item") and getattr(o, "ndim", 1) == 0:
        return o.item()
    if hasattr(o, "tolist"):
        return o.tolist()
    return str(o)


class Telemetry:
    """Registry + sinks + human log, one handle.

    `enabled` is False only for the shared `null_telemetry` fallback — call
    sites stay unconditional and pay a no-op when telemetry is off.
    """

    def __init__(self, sinks: Iterable = (), registry: Optional[Registry]
                 = None, log_fn=None, clock=time.time):
        sinks = tuple(sinks)
        self.sink = (NullSink() if not sinks else sinks[0]
                     if len(sinks) == 1 else MultiSink(*sinks))
        self.registry = registry if registry is not None else Registry()
        self.log_fn = log_fn
        self.clock = clock
        self.enabled = True
        # static per-step counter increments (e.g. the modelled DP-wire
        # bytes/step a launcher registers once from the GradLayout)
        self.per_step_counters: Dict[str, float] = {}

    # -- events ------------------------------------------------------------
    def event(self, kind: str, msg: Optional[str] = None, **fields) -> dict:
        """Emit one typed event.  `msg` is the human rendering (kept
        verbatim for log_fn); the sinks get the structured fields."""
        rec = {"t": self.clock(), "kind": kind, **fields}
        if msg is not None:
            rec["msg"] = msg
        self.sink.emit(rec)
        if self.log_fn is not None:
            self.log_fn(msg if msg is not None else _render(kind, fields))
        return rec

    def record(self, kind: str, **fields) -> dict:
        """Emit a structured record WITHOUT a human line (high-rate data:
        per-step samples, per-tick serve records)."""
        rec = {"t": self.clock(), "kind": kind, **fields}
        self.sink.emit(rec)
        return rec

    # -- metrics -----------------------------------------------------------
    def counter(self, name, labels=None):
        return self.registry.counter(name, labels)

    def gauge(self, name, labels=None):
        return self.registry.gauge(name, labels)

    def histogram(self, name, edges=MS_BUCKETS, labels=None):
        return self.registry.histogram(name, edges, labels)

    def span(self, name: str):
        return Span(self, name)

    def step(self, step: int, values: Dict[str, float],
             spans: Optional[Dict[str, float]] = None,
             extra: Optional[dict] = None) -> None:
        """One training-step sample: gauge every scalar, observe the span
        histograms, and write a single 'step' record.  `values` must
        already be host-side (the loop's existing per-step fetch); `extra`
        carries structured non-scalar payloads (e.g. the per-site quant
        stats dict) into the record without touching the registry."""
        for k, v in values.items():
            self.gauge(f"train_{k}").set(v)
        spans = spans or {}
        for k, ms in spans.items():
            self.histogram("train_span_ms", labels={"span": k}).observe(ms)
        for k, n in self.per_step_counters.items():
            self.counter(k).inc(n)
        self.record("step", step=step, **values,
                    **{f"{k}_ms": v for k, v in spans.items()},
                    **(extra or {}))

    # -- export ------------------------------------------------------------
    def emit_registry(self, **fields) -> None:
        self.record("registry", snapshot=self.registry.snapshot(), **fields)

    def write_prometheus(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.registry.to_prometheus())

    def flush(self) -> None:
        self.sink.flush()

    def close(self) -> None:
        self.sink.close()


def _render(kind: str, fields: dict) -> str:
    body = " ".join(f"{k}={v}" for k, v in fields.items())
    return f"[obs] {kind}{(' ' + body) if body else ''}"


class _NullTelemetry(Telemetry):
    def __init__(self):
        super().__init__(sinks=(NullSink(),))
        self.enabled = False


def on_rank(tel: Telemetry, mesh) -> Telemetry:
    """`tel` on the world's rank 0 (or without a mesh); on any other rank
    a telemetry over the same registry whose records reach no sink, so
    only rank 0 writes."""
    if mesh is None or mesh.rank == 0 or not tel.enabled:
        return tel
    return Telemetry(registry=tel.registry, clock=tel.clock)


def null_telemetry(log_fn=None) -> Telemetry:
    """A telemetry handle that keeps registry bookkeeping (cheap, host-side)
    but sinks nothing; with log_fn set, events still render human lines, so
    the loop's behavior with telemetry off is unchanged."""
    t = _NullTelemetry()
    t.log_fn = log_fn
    return t
