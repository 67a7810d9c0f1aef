"""Metrics registry: counters, gauges (with min/max watermarks), and
histograms, host-side and jax-free.

The registry is always "on" — its instruments are plain Python ints and
float lists, cheap enough that the engine updates them unconditionally —
while *export* cost lives entirely in the sinks (`sinks.NULL_SINK` by
default, so a disabled engine pays no serialization). Instruments are
created on first use and survive `reset()` with zeroed state, so a
steady-state monitor can hold references across bench re-timings.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional


class Counter:
    """Monotonic event count (resettable between bench timings)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def reset(self) -> None:
        self.value = 0


class Gauge:
    """Last-set value plus min/max watermarks since the last reset —
    the min watermark is how the free-page low-water mark is kept
    without storing a sample per tick."""

    __slots__ = ("value", "min", "max")

    def __init__(self):
        self.value: Optional[float] = None
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def set(self, v) -> None:
        v = float(v)
        self.value = v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    def reset(self) -> None:
        self.value = self.min = self.max = None


class Histogram:
    """Sample store with percentile queries. Samples are kept raw (the
    engine's tick counts are bench-scale, thousands not billions); a
    ``maxlen`` bound drops the oldest half when exceeded so a long-lived
    engine cannot grow without limit."""

    __slots__ = ("samples", "count", "total", "maxlen")

    def __init__(self, maxlen: int = 1 << 16):
        self.samples: List[float] = []
        self.count = 0
        self.total = 0.0
        self.maxlen = maxlen

    def observe(self, v) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        self.samples.append(v)
        if len(self.samples) > self.maxlen:
            del self.samples[:len(self.samples) // 2]

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile over retained samples (0.0 if empty)."""
        if not self.samples:
            return 0.0
        xs = sorted(self.samples)
        rank = max(math.ceil(q / 100.0 * len(xs)) - 1, 0)
        return xs[min(rank, len(xs) - 1)]

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def reset(self) -> None:
        self.samples.clear()
        self.count = 0
        self.total = 0.0


class MetricsRegistry:
    """Name -> instrument maps with create-on-first-use accessors.

    Naming convention (dotted, grep-able): ``ticks.decode``,
    ``tokens.decode``, ``preemptions``, ``pool.free`` (min = low-water
    mark), ``pool.occupancy``, ``pool.fragmentation``, ``queue.depth``,
    ``jit.prefill.hits`` / ``.misses``, ``jit.pool_writer.hits`` /
    ``.misses``, ``jit.decode.cache_size``, ``tick.decode.measured_s``
    (histogram), ``tick.decode.rel_err`` (histogram), and the chunk /
    prefill twins of the tick instruments."""

    def __init__(self):
        self.counters: Dict[str, Counter] = {}
        self.gauges: Dict[str, Gauge] = {}
        self.histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge()
        return g

    def histogram(self, name: str) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram()
        return h

    def as_dict(self) -> Dict[str, Dict]:
        """JSON-ready snapshot (histograms as count/mean/p50/p99)."""
        return {
            "counters": {k: c.value for k, c in sorted(self.counters.items())},
            "gauges": {k: {"value": g.value, "min": g.min, "max": g.max}
                       for k, g in sorted(self.gauges.items())},
            "histograms": {k: {"count": h.count, "mean": h.mean,
                               "p50": h.percentile(50),
                               "p99": h.percentile(99)}
                           for k, h in sorted(self.histograms.items())},
        }

    def reset(self) -> None:
        """Zero every instrument in place (references stay valid)."""
        for c in self.counters.values():
            c.reset()
        for g in self.gauges.values():
            g.reset()
        for h in self.histograms.values():
            h.reset()
