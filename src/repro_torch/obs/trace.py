"""Stage-level tracing: named profiler ranges on the device path and
host-side spans.

Counterpart of ``repro.obs.trace``.  Two clocks, two tools:

  annotate(name)   a ``torch.profiler.record_function`` range over a region
                   of the step, so a ``torch.profiler`` trace shows the
                   staged layer program's attn / router / dispatch /
                   expert / combine stages and the MemoryPlan's remat
                   blocks by name, with the device time of the kernels
                   launched inside each (``chip_profile.py`` reads it).
                   It launches nothing and reads nothing back from the
                   device.  ``record_function`` costs ~15 us of host time
                   a range even with no profiler running (it dispatches an
                   op), and the serve tick is host-bound, so ``annotate``
                   opens it only while a profiler is active
                   (``torch._C._autograd._profiler_enabled()``, one C
                   call); otherwise it returns a shared null context.
                   The ranges wrap forward-side work (in a train step also
                   the checkpoint blocks' recompute); autograd's backward
                   runs outside them, as XLA's backward of a named scope
                   carries its own names in the reference.

  Span(tel, name)  host wall clock: measures a with-block in ms, feeds the
                   telemetry's ``span_ms`` histogram, and while a profiler
                   is active brackets the block in a ``host/<name>`` range
                   (the reference's ``TraceAnnotation``), so host phases
                   line up with device rows on the trace.  ``train/loop.py``
                   splits a step's time into ``device_step`` and
                   ``host_fetch`` with it.
"""
from __future__ import annotations

import contextlib
import time

import torch

STAGES = ("attn", "router", "dispatch", "expert", "combine")

_NULL = contextlib.nullcontext()


def _profiling() -> bool:
    return torch._C._autograd._profiler_enabled()


def annotate(name: str):
    """A named profiler range while a profiler runs, else a null context
    (no device work, no host sync either way)."""
    if _profiling():
        return torch.profiler.record_function(name)
    return _NULL


def stage_annotation(stage: str):
    """The range of one stage of the staged layer program."""
    return annotate(f"stage/{stage}")


class Span:
    """Host-side wall-clock span; records into telemetry on exit.

    Usage::

        with tel.span("device_step") as sp:
            ...work...
        print(sp.ms)
    """

    __slots__ = ("tel", "name", "t0", "ms", "_prof")

    def __init__(self, tel, name: str):
        self.tel, self.name = tel, name
        self.t0 = 0.0
        self.ms = 0.0
        self._prof = None

    def __enter__(self):
        self._prof = annotate(f"host/{self.name}")
        self._prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.ms = (time.perf_counter() - self.t0) * 1e3
        self._prof.__exit__(*exc)
        self._prof = None
        if self.tel is not None:
            self.tel.histogram("span_ms", labels={"span": self.name}) \
                .observe(self.ms)
        return False
