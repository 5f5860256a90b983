"""The metrics registry: counters, gauges, and histograms with explicit
power-of-two bucket edges.

A copy of ``repro.obs.metrics`` (pure host-side bookkeeping: nothing here
touches torch).  Values that originate on the device (loss, grad_norm,
the guard bitmask, the per-site FP8 sat/flush matrix) become registry
samples only after the train loop's one metrics fetch a step, so arming
the registry never adds a host sync.

po2 buckets: every latency/size histogram uses power-of-two edges by
default.  Two reasons: (a) merges are trivial — two histograms with the
same exponent range add countwise, no rebinning; (b) they match the
repo's po2-scale worldview, so a bucket index IS an exponent and the
reporter can print `2^k` labels without float noise.
"""
from __future__ import annotations

import bisect
import threading
from typing import Dict, Optional, Sequence, Tuple


def po2_buckets(lo_exp: int, hi_exp: int) -> Tuple[float, ...]:
    """Bucket edges 2^lo_exp .. 2^hi_exp inclusive (exact floats)."""
    if hi_exp < lo_exp:
        raise ValueError(f"empty bucket range [{lo_exp}, {hi_exp}]")
    return tuple(float(2.0 ** e) for e in range(lo_exp, hi_exp + 1))


# default edges for millisecond latencies: 2^-6 ms (~16us) .. 2^14 ms (~16s)
MS_BUCKETS = po2_buckets(-6, 14)
# token/byte-ish counts: 1 .. 2^24
COUNT_BUCKETS = po2_buckets(0, 24)
# fractions in [0, 1]: 2^-20 .. 2^0
FRAC_BUCKETS = po2_buckets(-20, 0)


class Counter:
    """Monotonic counter."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels=None):
        self.name, self.labels = name, labels or {}
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease ({n})")
        self.value += n


class Gauge:
    """Last-write-wins sample."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels=None):
        self.name, self.labels = name, labels or {}
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed-edge histogram (cumulative-le semantics at render time).

    counts[i] is the number of observations in (edges[i-1], edges[i]];
    counts[0] covers (-inf, edges[0]], counts[-1] covers (edges[-1], +inf).
    """

    __slots__ = ("name", "labels", "edges", "counts", "sum", "count")

    def __init__(self, name: str, edges: Sequence[float] = MS_BUCKETS,
                 labels=None):
        edges = tuple(float(e) for e in edges)
        if list(edges) != sorted(set(edges)):
            raise ValueError(f"histogram {name}: edges must be strictly "
                             f"increasing, got {edges}")
        self.name, self.labels = name, labels or {}
        self.edges = edges
        self.counts = [0] * (len(edges) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect.bisect_left(self.edges, v)] += 1
        self.sum += v
        self.count += 1

    def merge(self, other: "Histogram") -> None:
        """Countwise add (same edges required — trivially true for po2)."""
        if other.edges != self.edges:
            raise ValueError(f"cannot merge {self.name}: edge mismatch")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.sum += other.sum
        self.count += other.count

    def quantile(self, q: float) -> float:
        """Bucket-resolution quantile (upper edge of the bucket holding
        the q-th observation; conservative, like Prometheus)."""
        if self.count == 0:
            return 0.0
        target = q * self.count
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= target and c:
                return self.edges[i] if i < len(self.edges) \
                    else self.edges[-1]
        return self.edges[-1]

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0


def _key(name: str, labels: Optional[dict]):
    return (name, tuple(sorted((labels or {}).items())))


class Registry:
    """Name+labels-keyed get-or-create registry, thread-safe (the serving
    engine and a trace driver may observe from different threads)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[tuple, object] = {}

    def _get(self, cls, name, labels, *args):
        k = _key(name, labels)
        with self._lock:
            m = self._metrics.get(k)
            if m is None:
                m = cls(name, *args, labels=dict(k[1]))
                self._metrics[k] = m
            elif not isinstance(m, cls):
                raise TypeError(f"{name} already registered as "
                                f"{type(m).__name__}")
            return m

    def counter(self, name: str, labels: Optional[dict] = None) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, labels: Optional[dict] = None) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, edges: Sequence[float] = MS_BUCKETS,
                  labels: Optional[dict] = None) -> Histogram:
        return self._get(Histogram, name, labels, edges)

    def __iter__(self):
        with self._lock:
            return iter(list(self._metrics.values()))

    # -- export ------------------------------------------------------------
    def snapshot(self) -> dict:
        """Plain-dict snapshot (JSONL-safe)."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for m in self:
            name = _flat_name(m)
            if isinstance(m, Counter):
                out["counters"][name] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][name] = m.value
            else:
                out["histograms"][name] = {
                    "edges": list(m.edges), "counts": list(m.counts),
                    "sum": m.sum, "count": m.count}
        return out

    def to_prometheus(self) -> str:
        """Prometheus text-exposition-format snapshot (0.0.4)."""
        by_name: Dict[str, list] = {}
        for m in self:
            by_name.setdefault(m.name, []).append(m)
        lines = []
        for name in sorted(by_name):
            ms = by_name[name]
            kind = ("counter" if isinstance(ms[0], Counter) else
                    "gauge" if isinstance(ms[0], Gauge) else "histogram")
            lines.append(f"# TYPE {name} {kind}")
            for m in sorted(ms, key=lambda m: sorted(m.labels.items())):
                if isinstance(m, (Counter, Gauge)):
                    lines.append(f"{name}{_label_str(m.labels)} "
                                 f"{_fmt(m.value)}")
                    continue
                acc = 0
                for edge, c in zip(m.edges, m.counts):
                    acc += c
                    lines.append(
                        f"{name}_bucket"
                        f"{_label_str(m.labels, le=_fmt(edge))} {acc}")
                lines.append(f"{name}_bucket"
                             f"{_label_str(m.labels, le='+Inf')} {m.count}")
                lines.append(f"{name}_sum{_label_str(m.labels)} "
                             f"{_fmt(m.sum)}")
                lines.append(f"{name}_count{_label_str(m.labels)} "
                             f"{m.count}")
        return "\n".join(lines) + "\n"


def _flat_name(m) -> str:
    if not m.labels:
        return m.name
    lbl = ",".join(f"{k}={v}" for k, v in sorted(m.labels.items()))
    return f"{m.name}{{{lbl}}}"


def _label_str(labels: dict, **extra) -> str:
    items = {**labels, **extra}
    if not items:
        return ""
    body = ",".join(f'{k}="{v}"' for k, v in sorted(items.items()))
    return "{" + body + "}"


def _fmt(v: float) -> str:
    return repr(float(v)) if v != int(v) else str(int(v))
