"""Continuous-batching scheduler over the slot pool or the paged KV pool.

Port of ``src/repro/serving/scheduler.py`` for ``ContinuousScheduler``
with the token cache families (fp and int8 K/V), unpaged (``paged=False``,
the slot pool) and paged: ``Request`` (line 106), ``RequestResult`` (126),
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
  (int8 K/V) prefills each prompt in one chunk.  Unpaged, chunks fill
  a batch-1 scratch cache of ``slot_len``, inserted into the slot acquired
  when the prefill finishes; paged, chunks write straight into the pool
  through the sequence's table row.
* **Decode** — one step over every slot per tick.  Unpaged, idle slots
  decode too (at length 0, writing garbage at position 0 that the next
  insert overwrites) and their lengths are reset to 0 after the step; paged,
  rows not decoding see the sentinel table, and a row the pool cannot back
  (and no swap can make room for) is evicted before the step.
* **Sampling noise** — each request owns a ``torch.Generator`` seeded from
  ``(seed, rid)`` and draws its ``k`` Gumbels per token from it, so a
  request's stream does not depend on its neighbours, on arrival order, on
  how its prefill was chunked or on a preemption.  ``noise_fn(rid,
  token_index, k)`` overrides the generators (tests feed the reference's
  noise through it).

``run`` serves through ``engine_api.Engine``, the loop every front end
drives.  Not ported yet: end-of-sequence retirement, temperature, the
tracer and metrics hooks (later slices; see ROADMAP.md).
"""
from __future__ import annotations

from collections import Counter, deque
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.topk_fusion import gumbel_noise
from repro_torch.obs import clock as obs_clock
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
    ``block_size``), ``prefill_chunk``, ``top_k``, ``paged`` (the block
    pool, or the slot pool when False), ``block_size`` / ``num_blocks``
    (paged geometry), ``preempt`` (paged: let a request that cannot be
    placed swap out a strictly-lower-priority decode; False leaves
    priorities ordering-only) and ``clock`` (every latency and deadline
    stamp; tests inject a ``VirtualClock``).  New here: ``seed`` for the
    per-request generators, ``noise_fn`` to override them, and ``device`` —
    ``"cuda"`` by default, ``"cpu"`` only when asked.
    """

    def __init__(self, params, cfg: ModelConfig, *, num_slots: int,
                 slot_len: int, prefill_chunk: int = 32, top_k: int = 5,
                 seed: int = 0, paged: bool = True, block_size: int = 8,
                 num_blocks: Optional[int] = None, preempt: bool = True,
                 clock: Optional[obs_clock.Clock] = None,
                 noise_fn: Optional[NoiseFn] = None, device="cuda"):
        self.params = params
        self.cfg = cfg
        self.family = cache_family.resolve(cfg)
        self.device = torch.device(device)
        self.clock = clock or obs_clock.get()
        self.paged = paged
        self.preempt = preempt
        self.pool = (PagedPool(cfg, num_slots, slot_len, block_size,
                               num_blocks, device=self.device) if paged
                     else SlotPool(cfg, num_slots, slot_len, self.device))
        self.prefill_chunk = max(1, prefill_chunk)
        self.top_k = top_k
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
        self._admit()
        self._advance_prefill()
        self._decode_tick()

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
            # a single-shot family (int8 K/V) gets the whole rest at once
            "sizes": deque([rest] if self.family.single_shot_prefill
                           else engine.prefill_schedule(rest,
                                                        self.prefill_chunk))}
        result.admitted_time = self.clock.monotonic()
        return True

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
        return True

    # -- prefill ------------------------------------------------------------
    def _advance_prefill(self) -> None:
        if self._prefill is None:
            return
        budget = max(1, self.pool.free_slots) if self.active else 10 ** 9
        pf = self._prefill
        prompt = pf["flight"].req.prompt
        while budget > 0 and pf["sizes"]:
            width = pf["sizes"].popleft()
            chunk = torch.as_tensor(
                np.asarray(prompt[pf["pos"]:pf["pos"] + width], np.int64),
                device=self.device)[None, :]
            if self.paged:
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
        if not pf["sizes"]:
            self._finish_prefill()

    def _finish_prefill(self) -> None:
        pf = self._prefill
        self._prefill = None
        flight: _InFlight = pf["flight"]
        logits = engine.logits_from_hidden(self.params, pf["last"], self.cfg)
        noise = self._noise(flight.req.rid, 0)[None].to(self.device)
        tok = int(engine.sample_per_slot(logits, self.top_k, noise)[0])
        self.prefills_done += 1
        self._record_token(flight, tok)
        if flight.remaining <= 0:
            self._finish(flight)
            return
        if self.paged:
            slot = flight.slot               # row claimed at admission
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
        if self.paged:
            # non-active rows (idle or mid-prefill) see the sentinel table
            # row: their length-0 garbage write lands in block 0
            tok, _, _ = engine.decode_step_paged(
                self.params, self.pool.caches,
                self.pool.device_tables(self.active.keys()), lens, toks,
                self.cfg, noise=noise, top_k=self.top_k)
        else:
            # idle slots decode at length 0: their garbage write lands at
            # position 0 of a free slot, which the next insert overwrites
            tok, _, _ = engine.decode_step_slots(
                self.params, self.pool.caches, lens, toks, self.cfg,
                noise=noise, top_k=self.top_k)
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
        for slot in list(self.active):
            flight = self.active[slot]
            self._record_token(flight, int(tok_host[slot]))
            slot_full = int(self.pool.lens[slot]) >= self.pool.slot_len
            if flight.remaining <= 0 or slot_full:
                flight.result.evicted = slot_full and flight.remaining > 0
                self._finish(flight)

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
        flight.produced += 1
        flight.remaining -= 1

    def _finish(self, flight: _InFlight) -> None:
        flight.result.finish_time = self.clock.monotonic()
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
