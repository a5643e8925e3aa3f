"""Process-wide metrics registry: counters, gauges, log2-bucket histograms
(port of `elasticsearch_tpu/telemetry/metrics.py`).

The one in-tree home for live latency distributions: subsystems record
durations they already measure (no new clock reads on the device, no
device syncs), and `_nodes/stats/telemetry` renders p50/p90/p99/p999 from
the histograms on demand.

Histograms use FIXED log2 buckets over nanoseconds (bucket i covers
(2^(i-1), 2^i]); 64 buckets span sub-nanosecond to ~584 years, so there
is no configuration and no rescaling, and a record is one bit_length and
one add under a per-histogram lock. Percentiles interpolate linearly
inside the winning bucket, which bounds the error to one bucket width.

Process-wide like the launch counters (`ops/dispatch.LAUNCHES`): one
registry serves every node in the process.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Sequence

N_BUCKETS = 64


def bucket_index(value_ns: int) -> int:
    """Bucket for a nanosecond duration: bucket i (i >= 1) covers
    (2^(i-1), 2^i] — exact powers of two land in their own bucket's
    upper edge, not one higher; bucket 0 holds <= 1 ns (zero/negative
    clock noise must not throw)."""
    v = int(value_ns)
    if v <= 1:
        return 0
    return min((v - 1).bit_length(), N_BUCKETS - 1)


def bucket_upper_ns(i: int) -> int:
    """Inclusive upper bound of bucket i."""
    return 1 if i <= 0 else 1 << i


def percentile_from_counts(counts: Sequence[int], q: float) -> float:
    """Percentile (ns) from a bucket-count vector: find the bucket where
    the cumulative count crosses q, interpolate linearly inside it. The
    answer is within one log2 bucket of the true value by construction."""
    total = sum(counts)
    if total <= 0:
        return 0.0
    target = q * total
    cum = 0.0
    for i, c in enumerate(counts):
        if c <= 0:
            continue
        if cum + c >= target:
            lo = float(0 if i == 0 else 1 << max(i - 1, 0))
            hi = float(bucket_upper_ns(i))
            frac = (target - cum) / c
            return lo + frac * (hi - lo)
        cum += c
    return float(bucket_upper_ns(N_BUCKETS - 1))


class Counter:
    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n


class Gauge:
    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self.value = v

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n

    def dec(self, n: float = 1.0) -> None:
        with self._lock:
            self.value -= n


class Histogram:
    """Fixed log2-bucket latency histogram over nanoseconds."""

    __slots__ = ("name", "counts", "count", "sum_ns", "max_ns", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.counts: List[int] = [0] * N_BUCKETS
        self.count = 0
        self.sum_ns = 0
        self.max_ns = 0
        self._lock = threading.Lock()

    def record(self, value_ns: int) -> None:
        v = int(value_ns)
        i = bucket_index(v)
        with self._lock:
            self.counts[i] += 1
            self.count += 1
            self.sum_ns += max(v, 0)
            if v > self.max_ns:
                self.max_ns = v

    def percentile(self, q: float) -> float:
        with self._lock:
            counts = list(self.counts)
        return percentile_from_counts(counts, q)

    def snapshot(self, raw: bool = False) -> dict:
        with self._lock:
            counts = list(self.counts)
            count, sum_ns, max_ns = self.count, self.sum_ns, self.max_ns
        out = {
            "count": count,
            "sum_nanos": sum_ns,
            "mean_nanos": (sum_ns / count) if count else 0.0,
            "max_nanos": max_ns,
            "p50_nanos": percentile_from_counts(counts, 0.50),
            "p90_nanos": percentile_from_counts(counts, 0.90),
            "p99_nanos": percentile_from_counts(counts, 0.99),
            "p999_nanos": percentile_from_counts(counts, 0.999),
        }
        if raw:
            out["counts"] = counts
        return out


class MetricsRegistry:
    """Named metric registry: get-or-create, thread-safe, snapshot-able.

    Metric creation takes the registry lock; recording takes only the
    metric's own lock, so the steady-state cost is one uncontended lock
    acquire per record."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter(name))
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge(name))
        return g

    def histogram(self, name: str) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(name, Histogram(name))
        return h

    def snapshot(self, raw: bool = False) -> dict:
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._histograms)
        return {
            "counters": {n: c.value for n, c in sorted(counters.items())},
            "gauges": {n: g.value for n, g in sorted(gauges.items())},
            "histograms": {n: h.snapshot(raw=raw)
                           for n, h in sorted(hists.items())},
        }

    def reset(self) -> None:
        """Drop every metric (tests/bench only)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


REGISTRY = MetricsRegistry()


def counter(name: str) -> Counter:
    return REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return REGISTRY.gauge(name)


def histogram(name: str) -> Histogram:
    return REGISTRY.histogram(name)


def record(name: str, value_ns: int) -> None:
    """One-call histogram record — the subsystem-facing entry."""
    REGISTRY.histogram(name).record(value_ns)


def snapshot(raw: bool = False) -> dict:
    return REGISTRY.snapshot(raw=raw)
