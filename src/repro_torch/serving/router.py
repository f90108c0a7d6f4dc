"""Router layer: spread Poisson traffic over N ``Engine`` replicas.

Port of ``src/repro/serving/router.py`` (``ReplicaRouter``, lines 50-199).
The router owns N engines and picks, per request, the replica whose pool
the prompt lands in:

* **Prefix affinity** (paged replicas, default on) — every replica is
  probed (``Engine.cache_probe``, read-only) and the request goes where the
  resident blocks already cover the most prompt tokens; without a live hit,
  to the replica the router's own history assigned the deepest chain key of
  the prompt (``PrefixIndex.chain_keys``, the keys admission matches
  under); failing both, the least loaded (``Engine.load``).
* **Round-robin** with ``affinity=False`` (or unpaged replicas).
* **Backpressure** (more than one replica) — when every replica is
  starved for the request (``Engine.starved``), ``submit`` rejects it
  (returns None) and counts the reject, instead of queueing it into a
  pool that cannot serve it.
* **Global accounting** — ``ServeReport.merge`` of the replicas' reports,
  with the router's own dict (assignments, per-replica counts, affinity
  routes, rejects).

Every replica is built from the same keyword arguments and shares the same
parameter tensors (one copy of the weights on the card), and a request's
noise is its own, so where a request lands never changes what it generates.
``tracer=`` shares one ``Tracer`` across the replicas, ``tracers=`` gives
replica i its own; either way replica i traces under pid i.  With the
metrics registry on, the router mirrors ``router.*`` metrics.
"""
from __future__ import annotations

from collections import deque
from typing import Iterable, Optional

from repro_torch.obs import metrics as obs_metrics
from repro_torch.serving.engine_api import Engine
from repro_torch.serving.paged import PrefixIndex
from repro_torch.serving.scheduler import Request, ServeReport


class ReplicaRouter:
    """N-replica front end with prefix-affinity routing and admission
    backpressure.  ``ReplicaRouter(params, cfg, replicas=2, num_slots=...,
    ...)`` builds N engines from the shared ``**engine_kwargs``.
    Backpressure is on for more than one replica and off for one, where
    rejecting would change the single-engine behaviour."""

    def __init__(self, params, cfg, *, replicas: int = 1,
                 affinity: bool = True, **engine_kwargs):
        if replicas < 1:
            raise ValueError(f"replicas must be ≥ 1 (got {replicas})")
        tracer = engine_kwargs.pop("tracer", None)
        tracers = engine_kwargs.pop("tracers", None)
        if tracers is not None:
            if tracer is not None:
                raise ValueError("pass tracer= or tracers=, not both")
            if len(tracers) != replicas:
                raise ValueError(f"tracers has {len(tracers)} entries for "
                                 f"{replicas} replicas")
        self.engines = [
            Engine(params, cfg,
                   tracer=tracers[i] if tracers is not None else tracer,
                   trace_pid=i, **engine_kwargs)
            for i in range(replicas)]
        self.block_size = int(engine_kwargs.get("block_size", 8))
        self.affinity = bool(affinity) and self.engines[0].paged
        self.backpressure = replicas > 1
        self._affinity_map: dict = {}      # chain key → replica index
        self._rr = 0                       # round-robin cursor
        self.assignments: dict[int, int] = {}   # rid → replica index
        self.rejected: list[int] = []      # rids refused by backpressure
        self.backpressure_rejects = 0
        self.affinity_routes = 0           # routed by a probe or history hit
        self.tick_count = 0

    @property
    def replicas(self) -> int:
        return len(self.engines)

    # -- routing ------------------------------------------------------------
    def route(self, req: Request) -> int:
        """The replica for ``req`` (nothing submitted): deepest live probe,
        then deepest remembered chain key, then least loaded; round-robin
        with affinity off."""
        n = len(self.engines)
        if not self.affinity:
            choice = self._rr % n
            self._rr += 1
            return choice
        keys = PrefixIndex.chain_keys(req.prompt, self.block_size)
        probes = [e.cache_probe(req.prompt) for e in self.engines]
        loads = [e.load for e in self.engines]
        best = max(range(n), key=lambda i: (probes[i], -loads[i], -i))
        if probes[best] > 0:
            choice = best
            self.affinity_routes += 1
        else:
            choice = None
            for key in reversed(keys):     # the deepest remembered prefix
                if key in self._affinity_map:
                    choice = self._affinity_map[key]
                    self.affinity_routes += 1
                    break
            if choice is None:
                choice = min(range(n), key=lambda i: (loads[i], i))
        for key in keys:                   # later same-prefix → same place
            self._affinity_map[key] = choice
        return choice

    # -- the narrow surface -------------------------------------------------
    def submit(self, req: Request) -> Optional[int]:
        """Route and enqueue ``req``; the replica index, or None when
        backpressure rejects it (every replica starved)."""
        if (self.backpressure
                and all(e.starved(len(req.prompt)) for e in self.engines)):
            self.rejected.append(req.rid)
            self.backpressure_rejects += 1
            if obs_metrics.enabled():
                obs_metrics.counter("router.backpressure_rejects").inc()
            return None
        choice = self.route(req)
        self.engines[choice].submit(req)
        self.assignments[req.rid] = choice
        return choice

    def step(self) -> bool:
        """Advance every replica one tick; True while any is busy."""
        self.tick_count += 1
        busy = False
        for e in self.engines:
            busy = e.step() or busy
        if obs_metrics.enabled():
            # mirrors only: the plain ints stay the report's inputs
            obs_metrics.gauge("router.affinity_routes").set(
                self.affinity_routes)
            for i, e in enumerate(self.engines):
                obs_metrics.gauge(f"router.r{i}.load").set(e.load)
        return busy

    def serve(self, requests: Optional[Iterable[Request]] = None, *,
              max_ticks: int = 100_000) -> ServeReport:
        """Serve the workload: each request is submitted at its
        ``arrival_tick`` (routing sees the replicas' state of that moment)
        and every replica ticks in lockstep until all are idle."""
        for e in self.engines:
            e.begin()
        pending = deque(sorted(list(requests or ()),
                               key=lambda r: r.arrival_tick))
        while pending or any(e.busy for e in self.engines):
            if self.tick_count >= max_ticks:
                raise RuntimeError(f"router wedged after {max_ticks} ticks")
            next_tick = self.tick_count + 1
            while pending and pending[0].arrival_tick <= next_tick:
                self.submit(pending.popleft())
            self.step()
        return self.report()

    def report(self) -> ServeReport:
        """The merged report, with the router's accounting."""
        per_replica = [0] * len(self.engines)
        for rep in self.assignments.values():
            per_replica[rep] += 1
        return ServeReport.merge(
            [e.report() for e in self.engines],
            router={"replicas": len(self.engines),
                    "affinity": self.affinity,
                    "assignments": dict(self.assignments),
                    "per_replica": per_replica,
                    "affinity_routes": self.affinity_routes,
                    "backpressure_rejects": self.backpressure_rejects,
                    "rejected": list(self.rejected)})

    def stats(self) -> list[dict]:
        return [e.stats() for e in self.engines]


__all__ = ["ReplicaRouter"]
