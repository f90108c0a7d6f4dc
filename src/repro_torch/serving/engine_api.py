"""Engine layer: the narrow serving surface over ``ContinuousScheduler``.

Port of ``src/repro/serving/engine_api.py`` (``Engine``, lines 55-189):
``Engine`` owns one scheduler (and through it the slot pool or the paged
pool) behind ``submit / step / drain / serve / stats``, and exposes the
signals ``serving.router.ReplicaRouter`` routes on: ``load``,
``cache_probe`` and ``starved``.  ``ContinuousScheduler.run`` delegates to
``Engine.wrap(scheduler).serve``, so the CLI, the router and ``run`` drive
the same loop.  ``stats`` attaches the metrics registry's snapshot when
the registry is on, and ``kernel_profile`` returns what
``repro_torch.obs.kernels`` recorded, the queued step profiles run.
"""
from __future__ import annotations

from typing import Iterable, Optional

from repro_torch.obs import kernels as obs_kernels
from repro_torch.obs import metrics as obs_metrics
from repro_torch.serving.scheduler import (ContinuousScheduler, Request,
                                           RequestResult, ServeReport)


class Engine:
    """One serving replica.  ``Engine(params, cfg, num_slots=...,
    slot_len=..., device="cuda", ...)`` takes the scheduler's keyword
    arguments and, like it, serves from the slot pool unless ``paged=True``
    asks for the block pool.  ``Engine.wrap`` adopts a scheduler already
    built."""

    def __init__(self, params, cfg, **scheduler_kwargs):
        self._sched = ContinuousScheduler(params, cfg, **scheduler_kwargs)
        self._t0: Optional[float] = None

    @classmethod
    def wrap(cls, sched: ContinuousScheduler) -> "Engine":
        """An engine over an existing scheduler (no new pool)."""
        eng = cls.__new__(cls)
        eng._sched = sched
        eng._t0 = None
        return eng

    # -- introspection ------------------------------------------------------
    @property
    def scheduler(self) -> ContinuousScheduler:
        return self._sched

    @property
    def paged(self) -> bool:
        return self._sched.paged

    @property
    def num_slots(self) -> int:
        return self._sched.pool.num_slots

    @property
    def busy(self) -> bool:
        return self._sched.busy

    @property
    def load(self) -> int:
        """Requests held and not finished: queued + active + suspended +
        the prefill in flight (the router's least-loaded signal)."""
        s = self._sched
        return (len(s.queue) + len(s.active) + len(s._suspended)
                + (1 if s._prefill is not None else 0))

    # -- the narrow surface -------------------------------------------------
    def submit(self, req: Request) -> None:
        self._sched.submit(req)

    def begin(self) -> None:
        """(Re)start the wall clock; ``step``/``drain`` start it lazily,
        ``serve`` on every call."""
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
        """The scheduler's cumulative results, stamped with the serve
        loop's start and end on the scheduler's clock."""
        s = self._sched
        now = s.clock.monotonic()
        started = self._t0 if self._t0 is not None else now
        occ = (s._occupancy_sum / s.decode_steps if s.decode_steps else 0.0)
        return ServeReport(results=s.finished, decode_steps=s.decode_steps,
                           prefill_chunks=s.prefill_chunks, occupancy=occ,
                           wall_time=now - started,
                           paged=s.pool.stats() if s.paged else None,
                           preemptions=s.preemptions,
                           started_at=started, ended_at=now)

    def stats(self) -> dict:
        """Live counters for routing and monitoring (the pool's and the
        swap's merged in when paged; the metrics registry's snapshot under
        ``"metrics"`` when the registry is on)."""
        s = self._sched
        out = {"tick_count": s.tick_count,
               "decode_steps": s.decode_steps,
               "prefill_chunks": s.prefill_chunks,
               "queue_depth": len(s.queue),
               "active": len(s.active),
               "suspended": len(s._suspended),
               "finished": len(s.finished),
               "free_slots": s.pool.free_slots,
               "preemptions": s.preemptions}
        if s.paged:
            out.update(s.pool.stats())
        if obs_metrics.enabled():
            out["metrics"] = obs_metrics.snapshot()
        return out

    def kernel_profile(self) -> dict:
        """Dispatch paths, kernel plans and step costs that
        ``repro_torch.obs.kernels`` recorded, after running the step
        profiles queued while serving (on the card, one ``torch.profiler``
        session each: call it once the serve's numbers are taken)."""
        obs_kernels.run_pending()
        return obs_kernels.snapshot()

    def cache_probe(self, prompt) -> int:
        """Tokens of ``prompt`` the pool's prefix index would serve without
        prefilling (0 unpaged).  Read-only."""
        if not self._sched.paged:
            return 0
        return self._sched.pool.probe(prompt)

    def starved(self, prompt_len: int) -> bool:
        """Backpressure signal: the queue is at least a full pool deep and
        the pool cannot place ``prompt_len`` even by reclaiming every cold
        prefix-cache block."""
        s = self._sched
        if len(s.queue) < s.pool.num_slots:
            return False
        if not s.paged:
            return s.pool.free_slots == 0
        need = s.pool.family.blocks_for_prompt(prompt_len, s.pool.block_size)
        return s.pool.free_blocks + s.pool.cached_blocks < need


__all__ = ["Engine", "Request", "RequestResult", "ServeReport"]
