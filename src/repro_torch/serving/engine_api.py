"""Engine layer: the narrow serving surface over ``ContinuousScheduler``.

Port of ``src/repro/serving/engine_api.py``: ``Engine`` owns one scheduler
(and through it the slot pool or the paged pool) behind ``submit / step /
drain / serve / stats``.  The replica router that drives several engines,
and the signals it reads (``load``, ``cache_probe``, ``starved``), are a
later slice.
"""
from __future__ import annotations

from typing import Iterable, Optional

from repro_torch.serving.scheduler import (ContinuousScheduler, Request,
                                           RequestResult, ServeReport)


class Engine:
    """One serving replica.  ``Engine(params, cfg, num_slots=...,
    slot_len=..., paged=True, device="cuda", ...)`` takes the scheduler's
    keyword arguments; ``paged=False`` serves from the slot pool."""

    def __init__(self, params, cfg, **scheduler_kwargs):
        self._sched = ContinuousScheduler(params, cfg, **scheduler_kwargs)
        self._t0: Optional[float] = None

    @property
    def scheduler(self) -> ContinuousScheduler:
        return self._sched

    def submit(self, req: Request) -> None:
        self._sched.submit(req)

    def begin(self) -> None:
        """(Re)start the wall clock."""
        self._t0 = self._sched.clock.monotonic()

    def step(self) -> bool:
        """Advance one scheduler tick.  Returns True while work remains."""
        if self._t0 is None:
            self.begin()
        self._sched.tick()
        return self._sched.busy

    def drain(self, *, max_ticks: int = 100_000) -> ServeReport:
        """Step until idle, then report."""
        if self._t0 is None:
            self.begin()
        s = self._sched
        while s.busy:
            if s.tick_count >= max_ticks:
                raise RuntimeError(f"scheduler wedged after {max_ticks} ticks")
            s.tick()
        return self.report()

    def serve(self, requests: Optional[Iterable[Request]] = None, *,
              max_ticks: int = 100_000) -> ServeReport:
        """Batch mode: submit everything, drain, report."""
        self.begin()
        for r in (requests or ()):
            self.submit(r)
        return self.drain(max_ticks=max_ticks)

    def report(self) -> ServeReport:
        s = self._sched
        now = s.clock.monotonic()
        started = self._t0 if self._t0 is not None else now
        occ = (s._occupancy_sum / s.decode_steps if s.decode_steps else 0.0)
        return ServeReport(results=s.finished, decode_steps=s.decode_steps,
                           prefill_chunks=s.prefill_chunks, occupancy=occ,
                           wall_time=now - started,
                           paged=s.pool.stats() if s.paged else None)

    def stats(self) -> dict:
        s = self._sched
        out = {"tick_count": s.tick_count,
               "decode_steps": s.decode_steps,
               "prefill_chunks": s.prefill_chunks,
               "queue_depth": len(s.queue),
               "active": len(s.active),
               "finished": len(s.finished),
               "free_slots": s.pool.free_slots}
        if s.paged:
            out.update(s.pool.stats())
        return out


__all__ = ["Engine", "Request", "RequestResult", "ServeReport"]
