"""Telemetry: the zero-sync metrics registry and the structured sinks
shared by the train loop and the launchers.

Counterpart of ``repro.obs`` without ``trace`` (ROADMAP.md, Queue 1,
item 9): copies of its ``metrics``, ``sink`` and ``report`` modules.  Every
value worth observing inside a step is already in the metrics the train
step returns; the loop fetches them once a step and the registry and
sinks consume that fetch, so telemetry adds no device-to-host transfer.
"""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, Registry,
                                     po2_buckets)
from repro_torch.obs.sink import (JsonlSink, MemorySink, MultiSink, NullSink,
                                  Span, Telemetry, null_telemetry)

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "po2_buckets",
    "JsonlSink", "MemorySink", "MultiSink", "NullSink", "Span", "Telemetry",
    "null_telemetry",
]
