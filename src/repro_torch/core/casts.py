"""Cast-operation accounting (paper Fig. 2: 12 casts -> 2).

Counterpart of ``repro.core.casts``.  A *cast* is an explicit,
memory-materialized quantize or dequantize of an activation-path tensor.
PyTorch runs eagerly, so the ledger records every call as it runs: a
Python loop over L layers records L times what the reference's scanned
stack records once at trace time.

Weight quantization is tagged separately (``q_w*``) and excluded from
``activation_casts()``; fused casts (``fused_*`` kinds, folded into a
surrounding kernel) are counted by ``fused_casts()``.

The active ledger is a ``ContextVar``.  PyTorch runs a CUDA backward on a
per-device autograd thread, which does not see the caller's context, so
every ``autograd.Function`` of the FP8 path captures the ledger in its
forward (``current()``) and re-enters it in its backward (``use``): the
backward's casts land in the ledger of the step that built the graph, on
the CPU and on the card alike.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import List, Optional

_LEDGER: contextvars.ContextVar[Optional["CastLedger"]] = contextvars.ContextVar(
    "cast_ledger", default=None)


@dataclasses.dataclass
class CastEvent:
    kind: str   # 'quantize' | 'dequantize' | 'fused_*'
    tag: str
    numel: int


class CastLedger:
    def __init__(self):
        self.events: List[CastEvent] = []

    def activation_casts(self) -> int:
        """Explicit Q/DQ ops on the activation path (the Fig. 2 tally)."""
        return sum(1 for e in self.events
                   if e.kind in ("quantize", "dequantize")
                   and not e.tag.startswith("q_w"))

    def fused_casts(self) -> int:
        return sum(1 for e in self.events if e.kind.startswith("fused_"))

    def total(self) -> int:
        return len(self.events)

    def by_tag(self):
        out = {}
        for e in self.events:
            key = (e.kind, e.tag)
            out[key] = out.get(key, 0) + 1
        return out

    def summary(self) -> str:
        lines = [f"  {kind:<10s} {tag:<18s} x{n}"
                 for (kind, tag), n in sorted(self.by_tag().items())]
        return "\n".join(lines) or "  (none)"


def record(kind: str, tag: str, numel: int) -> None:
    led = _LEDGER.get()
    if led is not None:
        led.events.append(CastEvent(kind, tag, int(numel)))


def current() -> Optional[CastLedger]:
    """The active ledger (None outside ``ledger()``)."""
    return _LEDGER.get()


@contextlib.contextmanager
def use(led: Optional[CastLedger]):
    """Make `led` the active ledger in this thread for the block."""
    tok = _LEDGER.set(led)
    try:
        yield led
    finally:
        _LEDGER.reset(tok)


@contextlib.contextmanager
def ledger():
    with use(CastLedger()) as led:
        yield led
