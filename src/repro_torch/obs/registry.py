"""Metrics registry: named counters, gauges and fixed-bucket histograms.

The serving stack's run counters used to be loose ints on a dataclass;
:class:`MetricsRegistry` gives them one named home with a uniform
:meth:`~MetricsRegistry.snapshot` so launchers and benchmarks can dump the
whole metric surface as JSON without knowing each counter by hand.
:class:`repro_torch.serve.metrics.ServeMetrics` is a facade over one registry —
its attribute reads/writes route here, and its ``report()`` keys are
unchanged (registry-only additions are additive).

Everything is plain host-side Python: metrics are updated by the scheduler
between traced steps, never inside jit.  Histograms use FIXED bucket upper
edges (no per-observation allocation, deterministic percentile estimates):
``percentile(q)`` returns the smallest bucket edge covering quantile ``q``,
or the exact observed max beyond the last edge — step-clock quantities are
small ints, so pow2 edges resolve tails exactly enough to gate on.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

# pow2 step-clock edges: queue waits / TTFTs / e2e latencies are step counts
STEP_BUCKETS = tuple(2 ** i for i in range(13))          # 1 .. 4096
# small-count edges: accepted draft lengths, per-request decode steps
COUNT_BUCKETS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 128, 256, 512)


class Counter:
    """A monotonically-meant int (``.set`` exists so facades can assign)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def set(self, v) -> None:
        self.value = v


class Gauge:
    """A point-in-time float."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v) -> None:
        self.value = float(v)


class Histogram:
    """Fixed-bucket histogram with exact count/sum/min/max.

    ``buckets`` are inclusive upper edges in increasing order; observations
    past the last edge land in an overflow bucket.  ``percentile`` is the
    bucket-resolution quantile: the smallest edge whose cumulative count
    reaches ``q * count`` (overflow resolves to the exact observed max) —
    deterministic, allocation-free, and monotone in ``q``."""

    __slots__ = ("name", "buckets", "counts", "overflow", "count", "total",
                 "min", "max")

    def __init__(self, name: str, buckets: Sequence[float]):
        edges = tuple(float(b) for b in buckets)
        if not edges or any(b <= a for a, b in zip(edges, edges[1:])):
            raise ValueError(f"histogram {name!r} needs strictly increasing "
                             f"bucket edges, got {edges}")
        self.name = name
        self.buckets = edges
        self.counts = [0] * len(edges)
        self.overflow = 0
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, x) -> None:
        x = float(x)
        self.count += 1
        self.total += x
        self.min = x if self.min is None else min(self.min, x)
        self.max = x if self.max is None else max(self.max, x)
        for i, edge in enumerate(self.buckets):
            if x <= edge:
                self.counts[i] += 1
                return
        self.overflow += 1

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        if not self.count:
            return 0.0
        need = q * self.count
        seen = 0
        for edge, c in zip(self.buckets, self.counts):
            seen += c
            if seen >= need:
                # never report an edge below the true minimum (q=0 etc.)
                return max(edge, self.min) if self.min is not None else edge
        return float(self.max)                  # overflow: exact observed max

    def snapshot(self) -> Dict[str, object]:
        return {
            "count": self.count,
            "sum": self.total,
            "min": self.min if self.min is not None else 0.0,
            "max": self.max if self.max is not None else 0.0,
            "mean": self.mean,
            "p50": self.percentile(0.50),
            "p95": self.percentile(0.95),
            "buckets": {str(int(e) if float(e).is_integer() else e): c
                        for e, c in zip(self.buckets, self.counts)},
            "overflow": self.overflow,
        }


Metric = Union[Counter, Gauge, Histogram]


class MetricsRegistry:
    """Get-or-create registry of named metrics with one ``snapshot()``."""

    def __init__(self):
        self._metrics: Dict[str, Metric] = {}

    def _get(self, name: str, kind, *args) -> Metric:
        m = self._metrics.get(name)
        if m is None:
            m = kind(name, *args)
            self._metrics[name] = m
        elif not isinstance(m, kind):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(m).__name__}, not {kind.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  buckets: Sequence[float] = STEP_BUCKETS) -> Histogram:
        return self._get(name, Histogram, buckets)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def value(self, name: str):
        """Scalar value of a counter/gauge (KeyError on histograms)."""
        m = self._metrics[name]
        if isinstance(m, Histogram):
            raise KeyError(f"{name!r} is a histogram; use histogram().snapshot()")
        return m.value

    def set_value(self, name: str, v) -> None:
        m = self._metrics[name]
        if isinstance(m, Histogram):
            raise KeyError(f"{name!r} is a histogram; use observe()")
        m.set(v)

    def snapshot(self) -> Dict[str, object]:
        """{name: scalar | histogram-dict} over every registered metric."""
        out: Dict[str, object] = {}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            out[name] = m.snapshot() if isinstance(m, Histogram) else m.value
        return out
