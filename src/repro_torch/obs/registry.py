"""Process-local metrics registry: counters, gauges and histograms, the
port's copy of the JAX package's ``repro.obs.registry``.

The registry is the aggregate half of the telemetry handle (the event stream
in :mod:`repro_torch.obs.telemetry` is the timeline half). Instruments are
plain Python objects changed from host code only, never from inside a
captured CUDA graph or on a device value, so updating one never waits for
the card. ``snapshot()`` returns a JSON-ready dict and ``reset()`` zeroes
every instrument in place (handles stay valid), which the serving engine's
registry-backed ``stats`` rely on.

The single-writer hot paths (the engine's boundary code, the serving
dispatch) use bare ``+=`` on floats, which is enough for monitoring
counters and costs nothing; get-or-create and snapshots take the registry
lock.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]


class Counter:
    """Monotonically increasing value (resettable via the registry)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def snapshot(self) -> float:
        return self.value

    def reset(self) -> None:
        self.value = 0.0


class Gauge:
    """Last-write-wins scalar (e.g. current gap, current sigma)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value: Optional[float] = None

    def set(self, value: float) -> None:
        self.value = float(value)

    def snapshot(self) -> Optional[float]:
        return self.value

    def reset(self) -> None:
        self.value = None


# Bucket upper bounds in powers of two: 1us .. ~67s, plus +inf. Fixed
# log2 buckets mean observe() is a bit_length() call, not a bisect, and
# two histograms from different runs can always be merged bucket-wise.
_NUM_BUCKETS = 27


class Histogram:
    """Log2-bucketed histogram with count/sum/min/max summary stats.

    Bucket ``i`` counts observations in ``[2**(i-1), 2**i)`` (bucket 0 is
    ``[0, 1)``); the final bucket is the overflow. Intended unit is
    microseconds for latency series but any nonnegative value works.
    """

    __slots__ = ("name", "count", "total", "min", "max", "buckets")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self.buckets: List[int] = [0] * _NUM_BUCKETS

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.total += v
        if self.min is None or v < self.min:
            self.min = v
        if self.max is None or v > self.max:
            self.max = v
        idx = int(v).bit_length() if v >= 1.0 else 0
        self.buckets[min(idx, _NUM_BUCKETS - 1)] += 1

    @property
    def mean(self) -> Optional[float]:
        return self.total / self.count if self.count else None

    def snapshot(self) -> Dict[str, object]:
        return {
            "count": self.count,
            "sum": self.total,
            "min": self.min,
            "max": self.max,
            "mean": self.mean,
            # sparse {bucket_index: count}; upper bound of bucket i is 2**i
            "buckets": {str(i): c for i, c in enumerate(self.buckets) if c},
        }

    def reset(self) -> None:
        self.count = 0
        self.total = 0.0
        self.min = None
        self.max = None
        self.buckets = [0] * _NUM_BUCKETS


class MetricsRegistry:
    """Get-or-create registry of named instruments.

    ``counter``/``gauge``/``histogram`` return the same object for the
    same name, so call sites can resolve instruments once at setup time
    and hold the handle (the serving engine does exactly this for its
    ``stats`` counters).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            inst = self._counters.get(name)
            if inst is None:
                inst = self._counters[name] = Counter(name)
            return inst

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            inst = self._gauges.get(name)
            if inst is None:
                inst = self._gauges[name] = Gauge(name)
            return inst

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            inst = self._histograms.get(name)
            if inst is None:
                inst = self._histograms[name] = Histogram(name)
            return inst

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        """JSON-ready view: {"counters": {...}, "gauges": {...}, "histograms": {...}}."""
        with self._lock:
            return {
                "counters": {n: c.snapshot() for n, c in sorted(self._counters.items())},
                "gauges": {n: g.snapshot() for n, g in sorted(self._gauges.items())},
                "histograms": {n: h.snapshot() for n, h in sorted(self._histograms.items())},
            }

    def reset(self) -> None:
        """Zero every instrument in place; existing handles remain valid."""
        with self._lock:
            for c in self._counters.values():
                c.reset()
            for g in self._gauges.values():
                g.reset()
            for h in self._histograms.values():
                h.reset()
