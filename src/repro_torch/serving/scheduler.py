"""Continuous-batching scheduler over the slot pool or the paged KV pool.

Port of ``src/repro/serving/scheduler.py`` for ``ContinuousScheduler``
with the token cache families (fp and int8 K/V) and the fixed-state family
(recurrent state rows), unpaged (``paged=False``, the slot pool) and
paged, and the enc-dec family, paged only (refused unpaged, as at line
521): ``Request`` (line 106), ``RequestResult`` (126),
``ServeReport`` (190, with ``merge`` at 249), ``SlotPool`` (410),
``poisson_workload`` (1238, the same numpy draws) and the scheduler's
admit → chunked prefill → pooled decode tick, with priorities, deadlines
and preempt-and-swap.

* **Admission** — by (priority, deadline slack, arrival tick, resume before
  admit, FIFO): slack is ``slo_ms`` minus the time already waited (+inf
  without a deadline), so tighter deadlines place first within a class; one
  class without deadlines is plain FIFO.  A request is admitted when it has
  arrived, no other prefill is in flight, and the pool can place it:
  unpaged, a free slot; paged, a batch row plus the blocks its unmatched
  prompt needs, after prefix matching and LRU reclaim.  Suspended requests
  compete under the same key and resume without a prefill.
* **Preempt-and-swap** (paged, ``preempt=True``) — a request that cannot be
  placed, even after the pool reclaimed its cold prefix-cache blocks, swaps
  out a strictly-lower-priority decode (deadline-free first, then the
  loosest slack, then the longest remaining) to host memory
  (``PagedPool.swap_out``); the same swap runs before the decode tick's
  out-of-blocks eviction.  A resumed row re-feeds its last token and, since
  a request's noise is its own, continues the stream of its never-preempted
  run.  While work is suspended, each decode tick stages the next resume's
  blocks back onto the device right after the step is issued
  (``PagedPool.prefetch_swap_in``).
* **Prefill** — chunked by ``engine.prefill_schedule`` and interleaved with
  decode: one chunk per tick while the pool is nearly full, more as slots
  sit idle, everything at once when nothing decodes.  A single-shot family
  (int8 K/V, recurrent state) prefills each prompt in one chunk.  Unpaged,
  chunks fill a batch-1 scratch cache of ``slot_len``, inserted into the
  slot acquired when the prefill finishes; paged, chunks write straight
  into the pool through the sequence's table row, except a fixed-state
  family's, which fills a scratch cache installed into its state row when
  the prefill finishes (``PagedPool.install_state``).  An enc-dec prompt
  (the whole audio) prefills in one shot: the frames are encoded, or on a
  whole-audio hit the shared cross blocks are gathered and the encoder
  skipped, and the decoder row primed at BOS is installed into the pool
  (``PagedPool.install_encdec``).
* **Decode** — one step over every slot per tick.  Unpaged, idle slots
  decode too (at length 0, writing garbage at position 0 that the next
  insert overwrites) and their lengths are reset to 0 after the step; paged,
  rows not decoding see the sentinel table, and a row the pool cannot back
  (and no swap can make room for) is evicted before the step; a
  fixed-state pool decodes each active slot's state row
  (``engine.decode_step_state``), the others reading the sentinel row and
  writing nothing; an enc-dec pool gathers each active row's cross blocks
  and self row and writes back the self rows
  (``engine.decode_step_encdec_paged``).
* **Sampling noise** — each request owns a ``torch.Generator`` seeded from
  ``(seed, rid)`` and draws its ``k`` Gumbels per token from it, so a
  request's stream does not depend on its neighbours, on arrival order, on
  how its prefill was chunked or on a preemption.  ``noise_fn(rid,
  token_index, k)`` overrides the generators (tests feed the reference's
  noise through it).  ``temperature`` divides the logits before the fused
  softmax+top-k unless it is 1.0.
* **Retirement** — a request retires when it has its ``max_new_tokens``,
  when it samples ``eos_id`` (the token is kept, as in the reference;
  traced as cause ``eos``), or when its slot is full (``evicted``).

* **Observability** — ``tracer`` (a ``repro_torch.obs.trace.Tracer``)
  records the reference's events: per request a track ``rid + 1`` of
  ``queued`` / ``prefill`` / ``decode`` / ``suspended`` phase spans,
  ``prefill_chunk`` spans and ``token`` / ``preempt`` / ``retire``
  instants; on track 0 a ``tick`` span holding ``admit`` / ``prefill`` /
  ``decode`` spans (each only when it has work) and the ``sched`` /
  ``blocks`` counters.  With the metrics registry on, the plain counters
  are mirrored into ``serving.*`` (``serving.r{i}.*`` for replica i).  With
  kernel profiling armed, the first decode step's cost is recorded and, on
  the card, a replay of it on private copies of its inputs is queued for
  ``obs.kernels.run_pending`` (``Engine.kernel_profile``), so no profiler
  session runs while the scheduler serves.  Without a tracer, with the
  registry off and profiling disarmed, the hot path does none of this.

``run`` serves through ``engine_api.Engine``, the loop every front end
drives.
"""
from __future__ import annotations

import contextlib
from collections import Counter, deque
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.topk_fusion import gumbel_noise
from repro_torch.obs import clock as obs_clock
from repro_torch.obs import kernels as obs_kernels
from repro_torch.obs import metrics as obs_metrics
from repro_torch.serving import cache_family, engine
from repro_torch.serving.paged import PagedPool


# ---------------------------------------------------------------------------
# Requests and results.
# ---------------------------------------------------------------------------
@dataclass(eq=False)
class Request:
    """One generation request.  ``arrival_tick``: the scheduler tick at
    which it becomes visible (0 = already waiting); ``priority``: its class,
    smaller is more urgent; ``slo_ms``: an optional completion deadline from
    arrival, which orders admission within a class and which
    ``ServeReport.slo_attainment`` scores."""
    rid: int
    prompt: np.ndarray                  # [T] token ids
    max_new_tokens: int
    arrival_tick: int = 0
    priority: int = 0                   # smaller = more urgent
    slo_ms: Optional[float] = None      # completion deadline from arrival


@dataclass
class RequestResult:
    rid: int
    prompt_len: int
    tokens: list = field(default_factory=list)
    arrival_time: float = 0.0           # clock when first seen arrived
    admitted_time: Optional[float] = None   # queue wait ends (prefill starts)
    first_token_time: Optional[float] = None
    finish_time: float = 0.0
    evicted: bool = False               # retired by a capacity backstop
    priority: int = 0                   # copied from the request
    slo_ms: Optional[float] = None      # copied from the request
    preempted: int = 0                  # times this request was swapped out
    dropped_latencies: int = 0          # per-token samples beyond the cap
    dropped_sum: float = 0.0
    _latencies: list = field(default_factory=list)

    # per-token samples kept per request; beyond the cap only their count
    # and sum are kept, so a long stream does not grow without bound
    MAX_RECORDED_LATENCIES = 8192

    def record_latency(self, latency: float) -> None:
        if len(self._latencies) < self.MAX_RECORDED_LATENCIES:
            self._latencies.append(latency)
        else:
            self.dropped_latencies += 1
            self.dropped_sum += latency

    @property
    def latencies(self) -> list:
        """Per-token latency: the first from arrival, the rest inter-token
        (capped — see ``record_latency``)."""
        return self._latencies

    @property
    def queued_ms(self) -> Optional[float]:
        """Queue wait: arrival → admission (prefill start)."""
        if self.admitted_time is None:
            return None
        return (self.admitted_time - self.arrival_time) * 1e3

    @property
    def prefill_ms(self) -> Optional[float]:
        """Prefill: admission → first token."""
        if self.admitted_time is None or self.first_token_time is None:
            return None
        return (self.first_token_time - self.admitted_time) * 1e3

    @property
    def decode_ms(self) -> Optional[float]:
        """Decode: first token → finish (suspended time included)."""
        if self.first_token_time is None:
            return None
        return (self.finish_time - self.first_token_time) * 1e3

    @property
    def slo_met(self) -> Optional[bool]:
        """Whether the request finished inside its deadline (None: none)."""
        if self.slo_ms is None:
            return None
        return (self.finish_time - self.arrival_time) * 1e3 <= self.slo_ms


@dataclass
class ServeReport:
    results: list                       # RequestResult, by completion order
    decode_steps: int
    prefill_chunks: int
    occupancy: float                    # mean active-slot fraction per step
    wall_time: float
    paged: Optional[dict] = None        # PagedPool.stats(); None unpaged
    preemptions: int = 0                # swap-outs the scheduler performed
    router: Optional[dict] = None       # ReplicaRouter's accounting (merged)
    started_at: Optional[float] = None  # serve loop start (engine clock)
    ended_at: Optional[float] = None    # serve loop end

    @property
    def total_tokens(self) -> int:
        return sum(len(r.tokens) for r in self.results)

    @property
    def tokens_per_s(self) -> float:
        return self.total_tokens / max(self.wall_time, 1e-9)

    def latency_percentiles(self, qs=(50, 95)) -> dict:
        lats = [l for r in self.results for l in r.latencies]
        if not lats:
            return {f"p{q}": 0.0 for q in qs}
        return {f"p{q}": float(np.percentile(lats, q)) for q in qs}

    def latency_percentiles_by_class(self, qs=(50, 95)) -> dict:
        """Per-token latency percentiles keyed by priority class."""
        out = {}
        for pr in sorted({r.priority for r in self.results}):
            lats = [l for r in self.results if r.priority == pr
                    for l in r.latencies]
            out[pr] = {f"p{q}": (float(np.percentile(lats, q)) if lats
                                 else 0.0) for q in qs}
        return out

    def slo_attainment(self) -> Optional[float]:
        """Fraction of deadline-bearing requests that met their deadline
        (None when no request carried one)."""
        bearing = [r for r in self.results if r.slo_ms is not None]
        if not bearing:
            return None
        return sum(1 for r in bearing if r.slo_met) / len(bearing)

    def slo_counts_by_class(self) -> dict:
        """{priority: (met, bearing)} over deadline-bearing requests —
        counts, which merge across replicas by summation."""
        out: dict = {}
        for r in self.results:
            if r.slo_ms is None:
                continue
            met, bearing = out.get(r.priority, (0, 0))
            out[r.priority] = (met + (1 if r.slo_met else 0), bearing + 1)
        return out

    @classmethod
    def merge(cls, reports, *, router: Optional[dict] = None) -> "ServeReport":
        """One report from per-replica reports: results concatenate (so
        percentiles run over the union of raw latencies), counters and pool
        stats sum (``block_size`` is kept), occupancy weights each replica
        by its decode steps, and the wall time is the overlapped interval
        ``max(ended_at) - min(started_at)`` when every report is stamped,
        else the longest wall time."""
        reports = list(reports)
        if not reports:
            raise ValueError("merge needs at least one report")
        steps = sum(r.decode_steps for r in reports)
        occ = (reports[0].occupancy if len(reports) == 1
               else (sum(r.occupancy * r.decode_steps for r in reports)
                     / steps if steps else 0.0))
        paged_dicts = [r.paged for r in reports if r.paged is not None]
        paged = None
        if paged_dicts:
            paged = {k: (paged_dicts[0][k] if k == "block_size"
                         else sum(d[k] for d in paged_dicts))
                     for k in paged_dicts[0]}
        stamped = all(r.started_at is not None and r.ended_at is not None
                      for r in reports)
        started = min(r.started_at for r in reports) if stamped else None
        ended = max(r.ended_at for r in reports) if stamped else None
        wall = (ended - started if stamped
                else max(r.wall_time for r in reports))
        return cls(results=[res for r in reports for res in r.results],
                   decode_steps=steps,
                   prefill_chunks=sum(r.prefill_chunks for r in reports),
                   occupancy=occ, wall_time=wall, paged=paged,
                   preemptions=sum(r.preemptions for r in reports),
                   router=router, started_at=started, ended_at=ended)

    def baseline_occupancy(self, num_slots: int) -> float:
        """Drain-and-refill bound on this workload, in arrival order."""
        ordered = sorted(self.results, key=lambda r: (r.arrival_time, r.rid))
        return drain_and_refill_occupancy([len(r.tokens) for r in ordered],
                                          num_slots)


def drain_and_refill_occupancy(decode_lens, num_slots: int) -> float:
    """Slot-step occupancy of the lockstep baseline on the same workload."""
    decode_lens = list(decode_lens)
    if not decode_lens:
        return 0.0
    steps = 0
    for i in range(0, len(decode_lens), num_slots):
        steps += max(decode_lens[i:i + num_slots])
    return sum(decode_lens) / float(steps * num_slots)


def request_seed(seed: int, rid: int) -> int:
    """The sampling generator's seed for request ``rid``."""
    return int(np.random.SeedSequence([seed, rid]).generate_state(
        1, np.uint64)[0])


# ---------------------------------------------------------------------------
# Slot pool.
# ---------------------------------------------------------------------------
class SlotPool:
    """Fixed pool of per-sequence KV-cache slots with a [num_slots] length
    vector — what replaces the lockstep batch's shared scalar.  The caches
    live on ``device``; the lengths on the host (numpy), handed to the
    engine as a tensor each step."""

    def __init__(self, cfg: ModelConfig, num_slots: int, slot_len: int,
                 device="cuda"):
        self.cfg = cfg
        self.num_slots = num_slots
        self.slot_len = slot_len
        self.caches = engine.init_cache(cfg, num_slots, slot_len, device)
        self.lens = np.zeros((num_slots,), np.int32)
        self._free: deque[int] = deque(range(num_slots))

    @property
    def free_slots(self) -> int:
        return len(self._free)

    def acquire(self) -> Optional[int]:
        return self._free.popleft() if self._free else None

    def release(self, slot: int) -> None:
        self.lens[slot] = 0
        self._free.append(slot)

    def insert(self, slot: int, seq_caches: dict, length: int) -> None:
        """Overwrite ``slot`` with a prefilled batch-1 cache of ``length``
        (in place, ``engine.write_slot``)."""
        engine.write_slot(self.cfg, self.caches, seq_caches, slot)
        self.lens[slot] = length


# ---------------------------------------------------------------------------
# The scheduler.
# ---------------------------------------------------------------------------
@dataclass
class _InFlight:
    req: Request
    result: RequestResult
    slot: int = -1                      # unpaged: claimed when prefill ends
    produced: int = 0                   # tokens sampled so far
    remaining: int = 0
    last_token_time: float = 0.0
    span: object = None                 # open lifecycle span (tracing only)


@dataclass
class _Suspended:
    """A preempted request parked off the pool: the flight keeps its
    produced/remaining counters, and ``token`` is the last sampled token,
    re-fed to decode on resume."""
    flight: _InFlight
    token: int


NoiseFn = Callable[[int, int, int], object]


class ContinuousScheduler:
    """Drives the slot pool or the paged pool: admission → chunked prefill
    → pooled decode.

    Keyword arguments mirror the reference's: ``num_slots`` (decode batch
    rows), ``slot_len`` (per-sequence cache bound; paged, a multiple of
    ``block_size``), ``prefill_chunk``, ``top_k`` and ``temperature`` (the
    sampling), ``eos_id`` (a token that retires its sequence early; None:
    length only), ``paged`` (the block
    pool when True; the slot pool by default), ``block_size`` /
    ``num_blocks`` (paged geometry), ``preempt`` (paged: let a request
    that cannot be placed swap out a strictly-lower-priority decode; False
    leaves priorities ordering-only), ``clock`` (every latency and deadline
    stamp; tests inject a ``VirtualClock``) and ``tracer`` / ``trace_pid``
    (the trace's process id, the replica index; no tracer by default).
    New here: ``seed`` for the per-request generators, ``noise_fn`` to
    override them, and ``device`` — ``"cuda"`` by default, ``"cpu"`` only
    when asked.
    """

    def __init__(self, params, cfg: ModelConfig, *, num_slots: int,
                 slot_len: int, prefill_chunk: int = 32, top_k: int = 5,
                 temperature: float = 1.0, eos_id: Optional[int] = None,
                 seed: int = 0, paged: bool = False, block_size: int = 8,
                 num_blocks: Optional[int] = None, preempt: bool = True,
                 clock: Optional[obs_clock.Clock] = None,
                 noise_fn: Optional[NoiseFn] = None, device="cuda",
                 tracer=None, trace_pid: int = 0):
        self.params = params
        self.cfg = cfg
        self.family = cache_family.resolve(cfg)
        if self.family.requires_paged and not paged:
            raise ValueError(
                f"{cfg.name!r} serves only in paged mode: the encoder output "
                "pages as immutable shared blocks "
                f"(family={self.family.name!r})")
        self.device = torch.device(device)
        self.clock = clock or obs_clock.get()
        self.paged = paged
        self.preempt = preempt
        self.tracer = tracer
        self._pid = trace_pid
        self._queued_spans: dict[int, object] = {}  # rid → open queued span
        self._metrics = (self._build_metrics(trace_pid)
                         if obs_metrics.enabled() else None)
        self._profiled = False          # one kernel profile per scheduler
        self.pool = (PagedPool(cfg, num_slots, slot_len, block_size,
                               num_blocks, device=self.device) if paged
                     else SlotPool(cfg, num_slots, slot_len, self.device))
        self.prefill_chunk = max(1, prefill_chunk)
        self.top_k = top_k
        self.temperature = temperature
        self.eos_id = eos_id
        self.k = min(top_k, cfg.vocab_size)       # noise width per token
        self.seed = seed
        self.noise_fn = noise_fn
        self.queue: deque[Request] = deque()
        self.active: dict[int, _InFlight] = {}         # slot → in-flight
        self._suspended: dict[int, _Suspended] = {}    # rid → preempted
        self.preemptions = 0
        self._prefill: Optional[dict] = None
        self._arrival_times: dict[int, float] = {}
        self._seen_rids: set[int] = set()
        self._generators: dict[int, torch.Generator] = {}
        self.finished: list[RequestResult] = []
        self.tick_count = 0
        self.decode_steps = 0
        self.prefill_chunks = 0
        self.prefills_done = 0                  # prefills that sampled a token
        self.chunk_widths: Counter = Counter()  # prefill chunk width → count
        self._occupancy_sum = 0.0
        self.tokens = np.zeros((num_slots,), np.int64)

    # -- noise --------------------------------------------------------------
    def _noise(self, rid: int, token_index: int) -> torch.Tensor:
        """Gumbel noise [k] for token ``token_index`` of request ``rid``."""
        if self.noise_fn is not None:
            g = torch.as_tensor(np.asarray(
                self.noise_fn(rid, token_index, self.k)), dtype=torch.float32)
            if g.shape != (self.k,):
                raise ValueError(f"noise_fn gave shape {tuple(g.shape)}, "
                                 f"expected ({self.k},)")
            return g
        gen = self._generators.get(rid)
        if gen is None:
            gen = torch.Generator().manual_seed(request_seed(self.seed, rid))
            self._generators[rid] = gen
        return gumbel_noise((self.k,), gen)

    # -- observability ------------------------------------------------------
    # The plain counters stay the inputs of ServeReport, the same with the
    # registry on or off; the registry only mirrors them.
    def _build_metrics(self, pid: int) -> dict:
        prefix = f"serving.r{pid}" if pid else "serving"
        m = {
            "tokens": obs_metrics.counter(f"{prefix}.tokens"),
            "preemptions": obs_metrics.counter(f"{prefix}.preemptions"),
            "occupancy": obs_metrics.histogram(f"{prefix}.occupancy"),
            "tick_ms": obs_metrics.histogram(f"{prefix}.tick_ms"),
            "active": obs_metrics.gauge(f"{prefix}.active"),
            "queue_depth": obs_metrics.gauge(f"{prefix}.queue_depth"),
            "free_slots": obs_metrics.gauge(f"{prefix}.free_slots"),
        }
        if self.paged:
            # free_blocks is a Gauge, so its .min is the low-water mark
            for k in ("free_blocks", "cached_blocks", "prefix_cache_hits",
                      "swapped_bytes_out", "swapped_bytes_in"):
                m[k] = obs_metrics.gauge(f"{prefix}.{k}")
        return m

    def _update_metrics(self) -> None:
        m = self._metrics
        m["active"].set(len(self.active))
        m["queue_depth"].set(len(self.queue) + len(self._suspended))
        m["free_slots"].set(self.pool.free_slots)
        if self.paged:
            for k in ("free_blocks", "cached_blocks", "prefix_cache_hits",
                      "swapped_bytes_out", "swapped_bytes_in"):
                m[k].set(getattr(self.pool, k))

    @staticmethod
    def _tid(rid: int) -> int:
        """Trace track of a request (track 0 is the scheduler's)."""
        return rid + 1

    def _span(self, name: str, args=None):
        """A span on the scheduler's track; a no-op without a tracer."""
        if self.tracer is None:
            return contextlib.nullcontext()
        return self.tracer.span(name, tid=0, pid=self._pid, args=args)

    def _begin_phase(self, flight: _InFlight, name: str, args=None) -> None:
        """Close the flight's current lifecycle span and open ``name``."""
        if self.tracer is None:
            return
        if flight.span is not None:
            self.tracer.end(flight.span)
        flight.span = self.tracer.begin(
            name, tid=self._tid(flight.req.rid), pid=self._pid, args=args)

    def _end_phase(self, flight: _InFlight) -> None:
        if self.tracer is not None and flight.span is not None:
            self.tracer.end(flight.span)
            flight.span = None

    # -- API ----------------------------------------------------------------
    def submit(self, req: Request) -> None:
        if len(req.prompt) == 0:
            raise ValueError(f"request {req.rid}: empty prompt")
        if req.max_new_tokens < 1:
            raise ValueError(f"request {req.rid}: max_new_tokens must be ≥ 1 "
                             f"(got {req.max_new_tokens})")
        try:
            self.family.validate_prompt(len(req.prompt), self.pool.slot_len)
        except ValueError as e:
            raise ValueError(f"request {req.rid}: {e}") from None
        if self.paged and not self.pool.fits(len(req.prompt)):
            raise ValueError(
                f"request {req.rid}: prompt of {len(req.prompt)} can never "
                "be admitted — its block need exceeds the whole pool")
        if req.rid in self._seen_rids:
            raise ValueError(f"duplicate request id {req.rid}: rids key the "
                             "sample streams and result bookkeeping")
        self._seen_rids.add(req.rid)
        self.queue.append(req)

    def tick(self) -> None:
        self.tick_count += 1
        now = self.clock.monotonic()
        for r in self.queue:            # stamp arrivals before admission
            if (r.arrival_tick <= self.tick_count
                    and r.rid not in self._arrival_times):
                self._arrival_times[r.rid] = now
                if self.tracer is not None:
                    self.tracer.thread_name(self._tid(r.rid), f"req {r.rid}",
                                            pid=self._pid)
                    self._queued_spans[r.rid] = self.tracer.begin(
                        "queued", tid=self._tid(r.rid), pid=self._pid,
                        args={"rid": r.rid, "priority": r.priority})
        # section spans only when the section has work: idle sections are
        # trace noise
        with self._span("tick", args={"tick": self.tick_count}):
            if self.queue:
                with self._span("admit"):
                    self._admit()
            else:
                self._admit()
            if self._prefill is not None:
                with self._span("prefill"):
                    self._advance_prefill()
            if self.active:
                with self._span("decode"):
                    self._decode_tick()
        if self.tracer is not None:
            self.tracer.counter("sched", {
                "active": len(self.active), "queue": len(self.queue),
                "free_slots": self.pool.free_slots}, pid=self._pid)
            if self.paged:
                self.tracer.counter("blocks", {
                    "free": self.pool.free_blocks,
                    "cached": self.pool.cached_blocks}, pid=self._pid)
        if self._metrics is not None:
            self._update_metrics()
            self._metrics["tick_ms"].observe(
                (self.clock.monotonic() - now) * 1e3)

    @property
    def busy(self) -> bool:
        """Work remains: queued (future arrivals too), prefilling, decoding
        or suspended."""
        return bool(self.queue or self.active or self._prefill
                    or self._suspended)

    def run(self, requests=None, *, max_ticks: int = 100_000) -> ServeReport:
        """Serve ``requests`` to completion and report, through
        ``Engine.wrap(self).serve`` — the loop every front end drives."""
        from repro_torch.serving.engine_api import Engine  # import cycle
        return Engine.wrap(self).serve(requests, max_ticks=max_ticks)

    # -- admission ----------------------------------------------------------
    def _admit(self) -> None:
        """Place waiting work in ``_next_candidate`` order.  Any number of
        resumes per tick (they need no prefill), at most one new prefill,
        and the head never skips: when the best candidate cannot be placed —
        after the pool's LRU reclaim and, failing that, preemption of
        strictly-lower-priority decodes — admission stops for this tick."""
        while True:
            cand = self._next_candidate()
            if cand is None:
                return
            kind, obj = cand
            if kind == "resume":
                prio = self._suspended[obj].flight.req.priority
                if self._try_resume(obj) or self._make_room(
                        prio, lambda: self._try_resume(obj)):
                    continue
                return
            if self._prefill is None and not self._start_prefill(obj):
                self._make_room(obj.priority,
                                lambda: self._start_prefill(obj))
            return

    def _slack(self, req: Request, now: float) -> float:
        """Deadline headroom in ms: ``slo_ms`` minus the time waited since
        arrival (+inf without a deadline)."""
        if req.slo_ms is None:
            return float("inf")
        arrived = self._arrival_times.get(req.rid, now)
        return req.slo_ms - (now - arrived) * 1e3

    def _next_candidate(self):
        """Best waiting work item, ``("resume", rid)`` or ``("admit",
        req)``, by (priority, deadline slack, arrival tick,
        resume-before-admit, FIFO)."""
        now = self.clock.monotonic()
        best = self._best_suspended(now)
        if best is not None:
            best = (best[0], ("resume", best[1]))
        for i, r in enumerate(self.queue):
            if r.arrival_tick > self.tick_count:
                continue
            key = (r.priority, self._slack(r, now), r.arrival_tick, 1, i)
            if best is None or key < best[0]:
                best = (key, ("admit", r))
        return best[1] if best else None

    def _best_suspended(self, now: float):
        """The suspended request to resume first, as (key, rid), by
        (priority, deadline slack, arrival tick, FIFO); the key's 0 sorts a
        resume before an admit that ties with it.  None when nothing is
        suspended."""
        best = None
        for i, (rid, rec) in enumerate(self._suspended.items()):
            req = rec.flight.req
            key = (req.priority, self._slack(req, now), req.arrival_tick, 0, i)
            if best is None or key < best[0]:
                best = (key, rid)
        return best

    def _start_prefill(self, req: Request) -> bool:
        """Claim capacity for ``req`` and set up its prefill; False when the
        pool cannot place it (it stays queued)."""
        result = RequestResult(rid=req.rid, prompt_len=len(req.prompt),
                               priority=req.priority, slo_ms=req.slo_ms,
                               arrival_time=self._arrival_times[req.rid])
        flight = _InFlight(req=req, result=result,
                           remaining=req.max_new_tokens)
        if self.paged:
            seq = self.pool.admit(req.prompt)
            if seq is None:
                return False
            flight.slot = seq.slot
            # prefill resumes at the first unmatched token: adopted prefix
            # blocks already hold the same cache content
            start, caches = seq.matched, None
            if self.family.kind == "encdec":
                # one shot over the whole audio: encode it, or adopt the
                # shared cross blocks (``_advance_encdec_prefill``)
                start = 0
            elif self.family.kind == "state":
                # a batch-1 scratch cache, installed into the sequence's
                # state row when the prefill finishes
                caches = engine.init_cache(self.cfg, 1, self.pool.slot_len,
                                           self.device)
        else:
            if self.pool.free_slots == 0:
                return False
            # a batch-1 scratch cache; the slot is claimed when it is full
            seq, start = None, 0
            caches = engine.init_cache(self.cfg, 1, self.pool.slot_len,
                                       self.device)
        self.queue.remove(req)
        rest = len(req.prompt) - start
        self._prefill = {
            "flight": flight, "seq": seq, "caches": caches, "length": start,
            "pos": start, "last": None,
            # a single-shot family (int8 K/V, state) gets the whole rest
            # at once
            "sizes": deque([rest] if self.family.single_shot_prefill
                           else engine.prefill_schedule(rest,
                                                        self.prefill_chunk))}
        self._admitted(flight)
        return True

    def _admitted(self, flight: _InFlight) -> None:
        """The queue wait ends: stamp it, and turn the request's track from
        ``queued`` to ``prefill``."""
        flight.result.admitted_time = self.clock.monotonic()
        if self.tracer is not None:
            span = self._queued_spans.pop(flight.req.rid, None)
            if span is not None:
                self.tracer.end(span)
            flight.span = self.tracer.begin(
                "prefill", tid=self._tid(flight.req.rid), pid=self._pid,
                args={"prompt_len": flight.result.prompt_len})

    # -- preemption ---------------------------------------------------------
    def _make_room(self, priority: int, attempt) -> bool:
        """Swap out lower-priority victims one at a time, retrying
        ``attempt`` after each, until it succeeds, no victim remains, or a
        swap freed no block while a row already sat free (blocks bind, and
        further victims would be suspended for nothing).  Unpaged pools
        and ``preempt=False`` never preempt."""
        if not (self.paged and self.preempt):
            return False
        while True:
            blocks_before = self.pool.free_blocks
            if not self._preempt_one(priority):
                return False
            if attempt():
                return True
            if (self.pool.free_slots > 0
                    and self.pool.free_blocks <= blocks_before):
                return False

    def _preempt_one(self, priority: int) -> bool:
        """Swap out one active decode strictly below ``priority``: the
        lowest class first; within it deadline-free victims, then the
        loosest slack, then the longest remaining decode (then the larger
        rid).  False when preemption is off, unpaged, or no such decode
        runs — equal priority is never preempted."""
        if not (self.paged and self.preempt) or not self.active:
            return False
        victims = [f for f in self.active.values()
                   if f.req.priority > priority]
        if not victims:
            return False
        now = self.clock.monotonic()
        victim = max(victims, key=lambda f: (f.req.priority,
                                             f.req.slo_ms is None,
                                             self._slack(f.req, now),
                                             f.remaining, f.req.rid))
        self._swap_out(victim)
        return True

    def _swap_out(self, flight: _InFlight) -> None:
        del self.active[flight.slot]
        self.pool.swap_out(flight.slot, flight.req.rid)
        self._suspended[flight.req.rid] = _Suspended(
            flight=flight, token=flight.result.tokens[-1])
        flight.slot = -1
        flight.result.preempted += 1
        self.preemptions += 1
        if self._metrics is not None:
            self._metrics["preemptions"].inc()
        if self.tracer is not None:
            self.tracer.instant(
                "preempt", tid=self._tid(flight.req.rid), pid=self._pid,
                args={"cause": "priority", "produced": flight.produced})
        self._begin_phase(flight, "suspended")

    def _prefetch_swap_in(self) -> None:
        """Stage the blocks of the suspended request likeliest to resume
        next (``_next_candidate``'s order) while the decode step just issued
        runs."""
        best = self._best_suspended(self.clock.monotonic())
        if best is not None:
            self.pool.prefetch_swap_in(best[1])

    def _try_resume(self, rid: int) -> bool:
        """Reattach a suspended request: ``PagedPool.swap_in`` rebuilds its
        blocks, table and length, and its last sampled token is fed again."""
        rec = self._suspended[rid]
        seq = self.pool.swap_in(rid)
        if seq is None:
            return False
        rec.flight.slot = seq.slot
        self.tokens[seq.slot] = rec.token
        self.active[seq.slot] = rec.flight
        del self._suspended[rid]
        self._begin_phase(rec.flight, "decode", args={"resumed": True})
        return True

    # -- prefill ------------------------------------------------------------
    def _advance_prefill(self) -> None:
        if self._prefill is None:
            return
        budget = max(1, self.pool.free_slots) if self.active else 10 ** 9
        pf = self._prefill
        if self.paged and self.family.kind == "encdec":
            self._advance_encdec_prefill(pf)
            return
        prompt = pf["flight"].req.prompt
        while budget > 0 and pf["sizes"]:
            width = pf["sizes"].popleft()
            chunk = torch.as_tensor(
                np.asarray(prompt[pf["pos"]:pf["pos"] + width], np.int64),
                device=self.device)[None, :]
            chunk_span = (self.tracer.begin(
                "prefill_chunk", tid=self._tid(pf["flight"].req.rid),
                pid=self._pid, args={"pos": pf["pos"], "width": width})
                if self.tracer is not None else None)
            if self.paged and pf["caches"] is None:
                pf["last"], _, pf["length"] = engine.prefill_chunk_paged(
                    self.params, self.pool.caches,
                    self.pool.device_row(pf["flight"].slot), pf["length"],
                    chunk, self.cfg)
            else:
                pf["last"], _, pf["length"] = engine.prefill_chunk(
                    self.params, pf["caches"], pf["length"], chunk, self.cfg)
            pf["pos"] += width
            self.prefill_chunks += 1
            self.chunk_widths[width] += 1
            budget -= 1
            if chunk_span is not None:
                self.tracer.end(chunk_span)
        if not pf["sizes"]:
            self._finish_prefill()

    def _advance_encdec_prefill(self, pf: dict) -> None:
        """One-shot enc-dec prefill: a whole-audio hit gathers the shared
        cross blocks and skips the encoder; a miss encodes the frames.
        Both prime a decoder row at BOS and give the same decoder caches
        for the same audio."""
        flight, seq = pf["flight"], pf["seq"]
        width = len(flight.req.prompt)
        bos = torch.full((1, 1), engine.ENCDEC_BOS, dtype=torch.int64,
                         device=self.device)
        span = (self.tracer.begin(
            "prefill_chunk", tid=self._tid(flight.req.rid), pid=self._pid,
            args={"pos": 0, "width": width,
                  "encoder_skipped": bool(seq.matched)})
            if self.tracer is not None else None)
        if seq.matched:
            nc = self.pool.max_blocks - 1
            cross = engine.gather_encdec_cross(
                self.pool.caches, torch.tensor(seq.blocks[:nc],
                                               dtype=torch.int64,
                                               device=self.device))
            pf["last"], pf["caches"], pf["length"] = \
                engine.encdec_prefill_cached(self.params, cross, bos,
                                             self.cfg,
                                             max_len=self.pool.slot_len)
        else:
            frames = engine.encdec_frames_from_ids(flight.req.prompt,
                                                   self.cfg, self.device)
            pf["last"], pf["caches"], pf["length"] = engine.encdec_prefill(
                self.params, frames, bos, self.cfg,
                max_len=self.pool.slot_len)
        pf["sizes"].clear()
        pf["pos"] = width
        self.prefill_chunks += 1
        self.chunk_widths[width] += 1
        if span is not None:
            self.tracer.end(span)
        self._finish_prefill()

    def _finish_prefill(self) -> None:
        pf = self._prefill
        self._prefill = None
        flight: _InFlight = pf["flight"]
        logits = engine.logits_from_hidden(self.params, pf["last"], self.cfg)
        noise = self._noise(flight.req.rid, 0)[None].to(self.device)
        tok = int(engine.sample_per_slot(logits, self.top_k, noise,
                                         self.temperature)[0])
        self.prefills_done += 1
        # the first token closes the prefill phase
        self._record_token(flight, tok)
        self._begin_phase(flight, "decode")
        if flight.remaining <= 0 or self._hit_eos(flight):
            self._finish(flight)
            return
        if self.paged:
            slot = flight.slot               # row claimed at admission
            if self.family.kind == "state":
                self.pool.install_state(pf["seq"], pf["caches"])
            elif self.family.kind == "encdec":
                self.pool.install_encdec(pf["seq"], pf["caches"])
            self.pool.finalize_prefill(pf["seq"])
            self.pool.lens[slot] = pf["length"]
        else:
            slot = self.pool.acquire()       # _admit gated on a free slot
            self.pool.insert(slot, pf["caches"], pf["length"])
            flight.slot = slot
        self.tokens[slot] = tok
        self.active[slot] = flight

    # -- decode -------------------------------------------------------------
    def _decode_tick(self) -> None:
        if not self.active:
            return
        if self.paged:
            # back every active row's next write with an exclusively-owned
            # block; a row the pool cannot back first swaps out strictly-
            # lower-priority decodes, and only with none left is evicted
            lens_pre = self.pool.lens.copy()
            for slot in list(self.active):
                flight = self.active.get(slot)
                if flight is None:          # swapped out as a victim above
                    continue
                ok = self.pool.prepare_write(slot, int(lens_pre[slot]))
                while not ok:
                    blocks_before = self.pool.free_blocks
                    if not self._preempt_one(flight.req.priority):
                        break
                    ok = self.pool.prepare_write(slot, int(lens_pre[slot]))
                    if not ok and self.pool.free_blocks <= blocks_before:
                        break               # the victim freed nothing usable
                if not ok:
                    flight.result.evicted = True
                    self._finish(flight)
            if not self.active:
                return
        n = self.pool.num_slots
        noise = torch.zeros((n, self.k), dtype=torch.float32)
        active_mask = np.zeros((n,), bool)
        for s, flight in self.active.items():
            noise[s] = self._noise(flight.req.rid, flight.produced)
            active_mask[s] = True
        lens = torch.from_numpy(self.pool.lens).to(self.device)
        toks = torch.from_numpy(self.tokens).to(self.device)[:, None]
        noise = noise.to(self.device)
        if self.paged and self.family.kind == "state":
            # each active slot decodes in its own state row; the others
            # read the sentinel row and their writes are dropped
            rows = np.zeros((n,), np.int64)
            for s in self.active:
                rows[s] = self.pool.seqs[s].blocks[0]
            step, label = engine.decode_step_state, "decode_step_state"
            args = (self.params, self.pool.caches,
                    torch.from_numpy(rows).to(self.device),
                    torch.from_numpy(active_mask).to(self.device), lens,
                    toks, self.cfg)
        elif self.paged and self.family.kind == "encdec":
            # a table row is [cross blocks..., self row]; the cross blocks
            # are immutable, so only the self rows are written back
            tables = self.pool.device_tables(self.active.keys())
            nc = self.pool.max_blocks - 1
            step, label = (engine.decode_step_encdec_paged,
                           "decode_step_encdec_paged")
            args = (self.params, self.pool.caches, tables[:, :nc],
                    tables[:, nc].long(),
                    torch.from_numpy(active_mask).to(self.device), lens,
                    toks, self.cfg)
        elif self.paged:
            # non-active rows (idle or mid-prefill) see the sentinel table
            # row: their length-0 garbage write lands in block 0
            step, label = engine.decode_step_paged, "decode_step_paged"
            args = (self.params, self.pool.caches,
                    self.pool.device_tables(self.active.keys()), lens, toks,
                    self.cfg)
        else:
            # idle slots decode at length 0: their garbage write lands at
            # position 0 of a free slot, which the next insert overwrites
            step, label = engine.decode_step_slots, "decode_step"
            args = (self.params, self.pool.caches, lens, toks, self.cfg)
        if (not self._profiled and obs_kernels.profiling_enabled()
                and label not in ("decode_step_state",
                                  "decode_step_encdec_paged")):
            # one-time profile of this step: its analytic cost from the
            # live lengths now and, on the card, a replay on private copies
            # once the serve is over (obs.kernels.run_pending); a
            # fixed-state or enc-dec pool's step is not profiled, as in
            # the reference
            self._profiled = True
            cost = obs_kernels.decode_step_cost(
                self.cfg, n, [int(self.pool.lens[s]) + 1
                              for s in self.active])
            obs_kernels.profile_step(
                step, label, *self._step_copy(args), cost=cost,
                device=self.device, noise=noise.clone(), top_k=self.top_k,
                temperature=self.temperature)
        tok, _, _ = step(*args, noise=noise, top_k=self.top_k,
                         temperature=self.temperature)
        # idle slots don't age
        self.pool.lens = np.where(active_mask, self.pool.lens + 1,
                                  0).astype(np.int32)
        if self.paged and self._suspended:
            # stage the next resume's blocks while the step just issued
            # runs, before the read-back below waits for it
            self._prefetch_swap_in()
        tok_host = tok.cpu().numpy().astype(np.int64)
        self.tokens = tok_host
        self.decode_steps += 1
        self._occupancy_sum += len(self.active) / n
        if self._metrics is not None:
            self._metrics["occupancy"].observe(len(self.active) / n)
        for slot in list(self.active):
            flight = self.active[slot]
            self._record_token(flight, int(tok_host[slot]))
            slot_full = int(self.pool.lens[slot]) >= self.pool.slot_len
            eos = self._hit_eos(flight)
            if flight.remaining <= 0 or eos or slot_full:
                flight.result.evicted = (slot_full and flight.remaining > 0
                                         and not eos)
                self._finish(flight)

    def _step_copy(self, args: tuple) -> tuple:
        """``args`` of a decode step with private copies of what it reads
        and writes: paged, the pool's blocks its tables name, gathered and
        renumbered (the live K/V only, the sentinel block among them);
        unpaged, the slot caches.  Replaying the step on them leaves the
        live pool as it is."""
        if self.paged:
            params, pools, tables, lens, toks, cfg = args
            ids = torch.unique(tables)      # sorted
            pools = {name: x.index_select(1, ids)
                     for name, x in pools.items()}
            tables = torch.searchsorted(ids, tables).to(tables.dtype)
            return params, pools, tables, lens.clone(), toks.clone(), cfg
        params, caches, lens, toks, cfg = args
        caches = {name: x.clone() for name, x in caches.items()}
        return params, caches, lens.clone(), toks.clone(), cfg

    # -- bookkeeping --------------------------------------------------------
    def _record_token(self, flight: _InFlight, token: int) -> None:
        now = self.clock.monotonic()
        result = flight.result
        result.tokens.append(token)
        if flight.produced == 0:
            result.first_token_time = now
            result.record_latency(now - result.arrival_time)
        else:
            result.record_latency(now - flight.last_token_time)
        flight.last_token_time = now
        if self._metrics is not None:
            self._metrics["tokens"].inc()
        if self.tracer is not None:
            self.tracer.instant(
                "token", tid=self._tid(flight.req.rid), pid=self._pid,
                args={"i": flight.produced, "token": token})
        flight.produced += 1
        flight.remaining -= 1

    def _hit_eos(self, flight: _InFlight) -> bool:
        """Whether the flight's last sampled token is ``eos_id``."""
        return (self.eos_id is not None and bool(flight.result.tokens)
                and flight.result.tokens[-1] == self.eos_id)

    def _finish(self, flight: _InFlight) -> None:
        flight.result.finish_time = self.clock.monotonic()
        self._end_phase(flight)
        if self.tracer is not None:
            cause = ("evicted" if flight.result.evicted
                     else "eos" if self._hit_eos(flight)
                     and flight.remaining > 0 else "completed")
            self.tracer.instant(
                "retire", tid=self._tid(flight.req.rid), pid=self._pid,
                args={"cause": cause, "tokens": len(flight.result.tokens)})
        self.finished.append(flight.result)
        self._generators.pop(flight.req.rid, None)
        if flight.slot >= 0:
            # paged flights own their row from admission, so one retired
            # straight out of prefill is not in `active` yet
            self.active.pop(flight.slot, None)
            self.pool.release(flight.slot)


# ---------------------------------------------------------------------------
# Synthetic workloads.
# ---------------------------------------------------------------------------
def poisson_workload(n_requests: int, *, rate_per_tick: float,
                     prompt_lens=(8, 32), decode_lens=(4, 32),
                     vocab: int = 1000, seed: int = 0,
                     shared_prefix: int = 0, priority_classes: int = 1,
                     slo_ms: Optional[float] = None) -> list:
    """Poisson arrivals (exponential gaps in ticks), uniform prompt/decode
    lengths, an optional shared prompt prefix; ``priority_classes > 1``
    draws each request's class uniformly from [0, classes) and ``slo_ms``
    gives class 0 that deadline — the reference's generator with the same
    numpy draws (a class is drawn only for more than one class), so both
    packages serve the same requests."""
    rng = np.random.default_rng(seed)
    prefix = (rng.integers(0, vocab, shared_prefix) if shared_prefix
              else None)
    t = 0.0
    out = []
    for rid in range(n_requests):
        t += rng.exponential(1.0 / max(rate_per_tick, 1e-9))
        body = rng.integers(0, vocab, rng.integers(prompt_lens[0],
                                                   prompt_lens[1] + 1))
        priority = (int(rng.integers(0, priority_classes))
                    if priority_classes > 1 else 0)
        out.append(Request(
            rid=rid,
            prompt=body if prefix is None else np.concatenate([prefix, body]),
            max_new_tokens=int(rng.integers(decode_lens[0],
                                            decode_lens[1] + 1)),
            arrival_tick=int(t), priority=priority,
            slo_ms=slo_ms if (slo_ms and priority == 0) else None))
    return out
