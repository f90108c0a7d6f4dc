"""Process-wide metrics registry: counters, gauges, histograms.

The port's own copy of ``src/repro/obs/metrics.py`` (stdlib only, the same
names, semantics and ``snapshot()`` format).  Off by default: every
instrument method starts with an enabled check, so with the registry
disabled a call costs one attribute load and a branch.  The serving hot
path keeps its plain-int counters as the authoritative source for
``ServeReport`` and *mirrors* them into the registry when it is on.

Naming convention: dotted lowercase, ``serving.*`` for single-engine
scheduler metrics, ``serving.r{i}.*`` per replica, ``router.*`` for the
front end, ``kernels.*`` for the kernel profile's figures.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional


class Counter:
    """Monotonically increasing count."""

    __slots__ = ("name", "_reg", "value")

    def __init__(self, name: str, reg: "Registry"):
        self.name = name
        self._reg = reg
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if not self._reg.enabled:
            return
        self.value += n


class Gauge:
    """Point-in-time value; tracks min/max so low-water marks survive
    the snapshot."""

    __slots__ = ("name", "_reg", "value", "min", "max")

    def __init__(self, name: str, reg: "Registry"):
        self.name = name
        self._reg = reg
        self.value: Optional[float] = None
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def set(self, v: float) -> None:
        if not self._reg.enabled:
            return
        self.value = v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)


class Histogram:
    """Exponential-bucket histogram (base 2 from ``least``), plus exact
    count/sum/min/max."""

    __slots__ = ("name", "_reg", "least", "buckets", "count", "sum",
                 "min", "max")

    NUM_BUCKETS = 24

    def __init__(self, name: str, reg: "Registry", least: float = 1e-4):
        self.name = name
        self._reg = reg
        self.least = least
        self.buckets: List[int] = [0] * (self.NUM_BUCKETS + 1)
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, v: float) -> None:
        if not self._reg.enabled:
            return
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        if v < self.least:
            idx = 0
        else:
            idx = min(int(math.log2(v / self.least)) + 1, self.NUM_BUCKETS)
        self.buckets[idx] += 1

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def percentile(self, q: float) -> Optional[float]:
        """Estimated q-th percentile (0–100) from the exponential buckets.

        Walks the cumulative counts to the bucket holding the q-th sample
        and interpolates linearly inside it; bucket bounds are clamped to
        the exactly-tracked ``min``/``max``, so a single-value histogram
        reports that value exactly and no estimate ever leaves the
        observed range.
        """
        if not self.count:
            return None
        target = max(q / 100.0 * self.count, 1.0)
        cum = 0
        for i, n in enumerate(self.buckets):
            if not n:
                continue
            if cum + n >= target:
                lo = 0.0 if i == 0 else self.least * (2.0 ** (i - 1))
                hi = (self.least if i == 0
                      else self.least * (2.0 ** i))
                lo = max(lo, self.min)
                hi = self.max if i == self.NUM_BUCKETS else min(hi, self.max)
                if hi < lo:
                    hi = lo
                frac = (target - cum) / n
                return lo + frac * (hi - lo)
            cum += n
        return self.max


class Registry:
    """Get-or-create instrument store.

    Instruments can be created while disabled (they just no-op); flipping
    ``enabled`` arms every existing handle — callers never re-fetch.
    """

    def __init__(self):
        self.enabled = False
        self._instruments: Dict[str, Any] = {}

    def _get(self, name: str, cls, **kw):
        inst = self._instruments.get(name)
        if inst is None:
            inst = cls(name, self, **kw)
            self._instruments[name] = inst
        elif not isinstance(inst, cls):
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(inst).__name__}, not {cls.__name__}")
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, least: float = 1e-4) -> Histogram:
        return self._get(name, Histogram, least=least)

    def snapshot(self) -> Dict[str, Any]:
        """JSON-serializable dump of every instrument with data."""
        out: Dict[str, Any] = {}
        for name in sorted(self._instruments):
            inst = self._instruments[name]
            if isinstance(inst, Counter):
                if not inst.value:
                    continue
                out[name] = {"type": "counter", "value": inst.value}
            elif isinstance(inst, Gauge):
                if inst.value is None:
                    continue
                out[name] = {"type": "gauge", "value": inst.value,
                             "min": inst.min, "max": inst.max}
            else:
                if not inst.count:
                    continue
                out[name] = {"type": "histogram", "count": inst.count,
                             "sum": inst.sum, "mean": inst.mean,
                             "min": inst.min, "max": inst.max,
                             "p50": inst.percentile(50),
                             "p95": inst.percentile(95)}
        return out

    def reset(self) -> None:
        self._instruments.clear()


REGISTRY = Registry()


def enable() -> None:
    REGISTRY.enabled = True


def disable() -> None:
    REGISTRY.enabled = False


def enabled() -> bool:
    return REGISTRY.enabled


def counter(name: str) -> Counter:
    return REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return REGISTRY.gauge(name)


def histogram(name: str, least: float = 1e-4) -> Histogram:
    return REGISTRY.histogram(name, least)


def snapshot() -> Dict[str, Any]:
    return REGISTRY.snapshot()


def reset() -> None:
    REGISTRY.reset()
