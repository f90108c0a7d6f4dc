"""The process-wide clock seam (own copy of ``src/repro/obs/clock.py``).

Production code calls :func:`monotonic` / :func:`perf_counter` /
:func:`wall_time`; tests install a :class:`VirtualClock` via :func:`set_clock`
(or hand one to the scheduler) and advance it explicitly, so latency
assertions are exact.
"""
from __future__ import annotations

import time as _time


class Clock:
    """Interface: three time sources, mirroring the stdlib names."""

    def monotonic(self) -> float:
        raise NotImplementedError

    def perf_counter(self) -> float:
        raise NotImplementedError

    def wall_time(self) -> float:
        """Epoch seconds (``time.time`` equivalent)."""
        raise NotImplementedError


class SystemClock(Clock):
    """The real thing — thin pass-through to :mod:`time`."""

    def monotonic(self) -> float:
        return _time.monotonic()

    def perf_counter(self) -> float:
        return _time.perf_counter()

    def wall_time(self) -> float:
        return _time.time()


class VirtualClock(Clock):
    """Deterministic clock for tests: time moves only via :meth:`advance`."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"cannot advance a clock backwards (dt={dt})")
        self._now += dt
        return self._now

    def monotonic(self) -> float:
        return self._now

    def perf_counter(self) -> float:
        return self._now

    def wall_time(self) -> float:
        return self._now


_current: Clock = SystemClock()


def get() -> Clock:
    """The currently installed process-wide clock."""
    return _current


def set_clock(clock: Clock) -> Clock:
    """Install ``clock`` process-wide; returns the previous one so tests
    can restore it in a ``finally``."""
    global _current
    prev = _current
    _current = clock
    return prev


def monotonic() -> float:
    return _current.monotonic()


def perf_counter() -> float:
    return _current.perf_counter()


def wall_time() -> float:
    return _current.wall_time()
