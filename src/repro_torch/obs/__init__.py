"""Telemetry: the zero-sync metrics registry, the structured sinks and the
stage-level tracing shared by the train loop, the serving engine and the
launchers.

Counterpart of ``repro.obs``: copies of its ``metrics``, ``sink``,
``report`` and ``trace`` modules.  Every value worth observing inside a
step is already in the metrics the train step returns; the loop fetches
them once a step and the registry and sinks consume that fetch, so
telemetry adds no device-to-host transfer.  The stage ranges of
``obs/trace.py`` (attn -> router -> dispatch -> expert -> combine, and the
MemoryPlan's remat blocks) are profiler ranges opened only while a
profiler runs: they add no device work and no host sync.
"""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, Registry,
                                     po2_buckets)
from repro_torch.obs.sink import (JsonlSink, MemorySink, MultiSink, NullSink,
                                  Telemetry, null_telemetry)
from repro_torch.obs.trace import STAGES, Span, annotate, stage_annotation

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "po2_buckets",
    "JsonlSink", "MemorySink", "MultiSink", "NullSink", "Telemetry",
    "null_telemetry", "STAGES", "Span", "annotate", "stage_annotation",
]
