"""Metrics registry: named counters, gauges, and streaming histograms.

The service-level companion of :mod:`repro_torch.obs.trace`: where spans
answer *when*, metrics answer *how much* — bytes moved by the stream
engines, chunks prefetched, pairing rounds, plan-cache hits/evictions,
TopoService queue depth / batch sizes / per-request latency.

Histograms are **fixed-bucket log histograms**: geometric bucket
boundaries, one int64 count per bucket, no per-sample storage — so a
long-running service can observe millions of latencies in a few
hundred bytes and still answer p50/p95/p99 (log-interpolated within
the winning bucket, a bounded relative error set by the bucket growth
factor).  This mirrors how production servers (Prometheus, OpenCensus)
track latency distributions.

Thread-safety: counter/gauge updates are single ``+=``/``=`` byte-code
operations on ints/floats (atomic under the GIL); histogram observes
take a per-histogram lock (two array writes).  ``snapshot()`` returns
freshly-built plain dicts — callers can never mutate registry
internals through a snapshot.

One process-wide default registry (:func:`global_metrics`) collects
subsystem counters (plan cache, stream engines, pairing kernels);
objects with their own lifetime (``TopoService``) hold private
registries so their stats reset with them.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Optional

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "global_metrics"]


class Counter:
    """Monotonically increasing count (events, bytes, rounds)."""

    __slots__ = ("name", "_v")

    def __init__(self, name: str):
        self.name = name
        self._v = 0

    def inc(self, n: int = 1) -> None:
        self._v += n

    @property
    def value(self) -> int:
        return self._v

    def snapshot(self):
        return self._v


class Gauge:
    """Last-set value (queue depth, resident bytes)."""

    __slots__ = ("name", "_v")

    def __init__(self, name: str):
        self.name = name
        self._v = 0.0

    def set(self, v: float) -> None:
        self._v = v

    def inc(self, n: float = 1) -> None:
        self._v += n

    def dec(self, n: float = 1) -> None:
        self._v -= n

    @property
    def value(self) -> float:
        return self._v

    def snapshot(self):
        return self._v


class Histogram:
    """Streaming log-bucket histogram with percentile estimation.

    Buckets are geometric: bucket ``i`` holds values in
    ``[lo * factor**i, lo * factor**(i+1))``, plus an underflow bucket
    (everything ``< lo``, including zeros/negatives) and an overflow
    bucket.  Percentiles log-interpolate inside the winning bucket, so
    the relative error is bounded by ``factor`` (default 1.6 — ~27%
    worst-case on an individual quantile, far tighter in practice) at
    O(n_buckets) memory forever.
    """

    __slots__ = ("name", "lo", "factor", "_log_lo", "_log_f", "_counts",
                 "_count", "_sum", "_min", "_max", "_lock")

    def __init__(self, name: str, lo: float = 1e-6, hi: float = 1e4,
                 factor: float = 1.6):
        if not (lo > 0 and hi > lo and factor > 1):
            raise ValueError(
                f"need 0 < lo < hi and factor > 1, got lo={lo}, hi={hi}, "
                f"factor={factor}")
        self.name = name
        self.lo = lo
        self.factor = factor
        self._log_lo = math.log(lo)
        self._log_f = math.log(factor)
        n = int(math.ceil((math.log(hi) - self._log_lo) / self._log_f))
        # [underflow] + n log buckets + [overflow]
        self._counts = [0] * (n + 2)
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._lock = threading.Lock()

    def _bucket(self, v: float) -> int:
        if v < self.lo:
            return 0
        i = int((math.log(v) - self._log_lo) / self._log_f) + 1
        return min(i, len(self._counts) - 1)

    def observe(self, v: float) -> None:
        v = float(v)
        b = self._bucket(v)
        with self._lock:
            self._counts[b] += 1
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def _edges(self, i: int) -> tuple:
        """(lower, upper) value bounds of bucket ``i``."""
        if i == 0:
            return (0.0, self.lo)
        lo = math.exp(self._log_lo + (i - 1) * self._log_f)
        return (lo, lo * self.factor)

    def percentile(self, q: float) -> Optional[float]:
        """Estimated ``q``-quantile (``q`` in [0, 1]); None when empty."""
        if not 0 <= q <= 1:
            raise ValueError(f"q must be in [0, 1], got {q}")
        with self._lock:
            total = self._count
            counts = list(self._counts)
            vmin, vmax = self._min, self._max
        if total == 0:
            return None
        rank = q * total
        cum = 0.0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if cum + c >= rank:
                lo, hi = self._edges(i)
                # clamp to observed extremes, log-interpolate inside
                lo = max(lo, vmin) if vmin > 0 else lo
                hi = min(hi, vmax)
                if hi <= lo or lo <= 0:
                    return max(lo, min(hi, vmax))
                frac = (rank - cum) / c
                return math.exp(math.log(lo)
                                + frac * (math.log(hi) - math.log(lo)))
            cum += c
        return vmax

    def buckets(self) -> list:
        """Cumulative ``(upper_edge, count)`` pairs — Prometheus ``le``
        semantics: entry ``i`` counts every observation that landed at
        or below bucket ``i``'s upper edge, and the final entry is
        ``(inf, total)``.  The exposition layer
        (:mod:`repro_torch.obs.exposition`) renders these as the
        ``_bucket{le=...}`` series."""
        with self._lock:
            counts = list(self._counts)
            total = self._count
        out = []
        cum = 0
        for i, c in enumerate(counts[:-1]):
            cum += c
            out.append((self._edges(i)[1], cum))
        out.append((math.inf, total))
        return out

    def snapshot(self) -> dict:
        with self._lock:
            count, s = self._count, self._sum
            vmin, vmax = self._min, self._max
        out = {"count": count, "sum": s,
               "min": None if count == 0 else vmin,
               "max": None if count == 0 else vmax,
               "mean": None if count == 0 else s / count}
        for label, q in (("p50", .5), ("p95", .95), ("p99", .99)):
            out[label] = self.percentile(q)
        return out


class MetricsRegistry:
    """Named metric instruments, created on first use.

    ``counter(name)`` / ``gauge(name)`` / ``histogram(name)`` return
    the live instrument (get-or-create, kind-checked); ``snapshot()``
    returns a plain nested dict — a *copy*, never a view of registry
    state.

    ``alias=`` is the one naming-compatibility helper: it registers
    the **same instrument** under a second (legacy) name, so a metric
    renamed into the canonical dotted scheme (``service.queue_depth``)
    keeps answering under its historical key (``queue_depth``) in
    snapshots and exposition — one value, two names, updated through
    one instrument."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls, alias: Optional[str] = None, **kw):
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.get(name)
                if m is None:
                    m = cls(name, **kw)
                    self._metrics[name] = m
                    if alias and alias not in self._metrics:
                        self._metrics[alias] = m
        if not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(m).__name__}, not {cls.__name__}")
        return m

    def counter(self, name: str, *, alias: Optional[str] = None) -> Counter:
        return self._get(name, Counter, alias=alias)

    def gauge(self, name: str, *, alias: Optional[str] = None) -> Gauge:
        return self._get(name, Gauge, alias=alias)

    def histogram(self, name: str, *, lo: float = 1e-6, hi: float = 1e4,
                  factor: float = 1.6,
                  alias: Optional[str] = None) -> Histogram:
        return self._get(name, Histogram, alias=alias, lo=lo, hi=hi,
                         factor=factor)

    def instruments(self) -> Dict[str, object]:
        """name -> live instrument, aliases included (a fresh dict; the
        instruments themselves are the live objects — this is the
        exposition layer's typed access path)."""
        with self._lock:
            return dict(self._metrics)

    def snapshot(self) -> Dict[str, object]:
        """Fresh name -> value/summary dict (counters and gauges as
        scalars, histograms as their summary dicts); aliased names each
        carry the shared instrument's current value."""
        with self._lock:
            metrics = list(self._metrics.items())
        return {name: m.snapshot() for name, m in metrics}

    def reset(self) -> None:
        """Drop every instrument (tests / per-run isolation)."""
        with self._lock:
            self._metrics.clear()


_GLOBAL = MetricsRegistry()


def global_metrics() -> MetricsRegistry:
    """The process-wide default registry (subsystem counters: plan
    cache, stream engines, pairing kernels)."""
    return _GLOBAL
