"""Continuous-batching scheduler over the slot pool or the paged KV pool.

Port of ``src/repro/serving/scheduler.py`` for ``ContinuousScheduler``
with the token cache families (fp and int8 K/V), unpaged (``paged=False``,
the slot pool) and paged: ``Request`` (line 106), ``RequestResult`` (126),
``ServeReport`` (190), ``SlotPool`` (410), ``poisson_workload`` (1238, the
same numpy draws) and the scheduler's admit → chunked prefill → pooled
decode tick.

* **Admission** — by (arrival tick, FIFO); a request is admitted when it
  has arrived, no other prefill is in flight, and the pool can place it:
  unpaged, a free slot; paged, a batch row plus the blocks its unmatched
  prompt needs, after prefix matching and LRU reclaim.
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
  is evicted before the step.
* **Sampling noise** — each request owns a ``torch.Generator`` seeded from
  ``(seed, rid)`` and draws its ``k`` Gumbels per token from it, so a
  request's stream does not depend on its neighbours, on arrival order or
  on how its prefill was chunked.  ``noise_fn(rid, token_index, k)``
  overrides the generators (tests feed the reference's noise through it).

Not ported yet: priorities, SLOs and preempt-and-swap, end-of-sequence
retirement, temperature, the tracer and metrics hooks (later slices; see
ROADMAP.md).
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
    """One generation request; ``arrival_tick`` is the scheduler tick at
    which it becomes visible (0 = already waiting)."""
    rid: int
    prompt: np.ndarray                  # [T] token ids
    max_new_tokens: int
    arrival_tick: int = 0


@dataclass
class RequestResult:
    rid: int
    prompt_len: int
    tokens: list = field(default_factory=list)
    arrival_time: float = 0.0
    finish_time: float = 0.0
    evicted: bool = False               # retired by a capacity backstop
    latencies: list = field(default_factory=list)   # first: from arrival


@dataclass
class ServeReport:
    results: list                       # RequestResult, by completion order
    decode_steps: int
    prefill_chunks: int
    occupancy: float                    # mean active-slot fraction per step
    wall_time: float
    paged: Optional[dict]               # PagedPool.stats(); None unpaged

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


NoiseFn = Callable[[int, int, int], object]


class ContinuousScheduler:
    """Drives the slot pool or the paged pool: admission → chunked prefill
    → pooled decode.

    Keyword arguments mirror the reference's: ``num_slots`` (decode batch
    rows), ``slot_len`` (per-sequence cache bound; paged, a multiple of
    ``block_size``), ``prefill_chunk``, ``top_k``, ``paged`` (the block
    pool, or the slot pool when False), ``block_size`` / ``num_blocks``
    (paged geometry) and ``clock``.  New here: ``seed`` for the per-request
    generators, ``noise_fn`` to override them, and ``device`` — ``"cuda"``
    by default, ``"cpu"`` only when asked.
    """

    def __init__(self, params, cfg: ModelConfig, *, num_slots: int,
                 slot_len: int, prefill_chunk: int = 32, top_k: int = 5,
                 seed: int = 0, paged: bool = True, block_size: int = 8,
                 num_blocks: Optional[int] = None,
                 clock: Optional[obs_clock.Clock] = None,
                 noise_fn: Optional[NoiseFn] = None, device="cuda"):
        self.params = params
        self.cfg = cfg
        self.family = cache_family.resolve(cfg)
        self.device = torch.device(device)
        self.clock = clock or obs_clock.get()
        self.paged = paged
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
        return bool(self.queue or self.active or self._prefill)

    # -- admission ----------------------------------------------------------
    def _admit(self) -> None:
        """Start at most one prefill per tick, for the earliest-arrived
        request (FIFO among equals); the head never skips."""
        if self._prefill is not None:
            return
        arrived = [(r.arrival_tick, i, r) for i, r in enumerate(self.queue)
                   if r.arrival_tick <= self.tick_count]
        if arrived:
            self._start_prefill(min(arrived, key=lambda e: e[:2])[2])

    def _start_prefill(self, req: Request) -> bool:
        result = RequestResult(rid=req.rid, prompt_len=len(req.prompt),
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
            # block; a row the pool cannot back is evicted before the step
            lens_pre = self.pool.lens.copy()
            for slot in list(self.active):
                flight = self.active[slot]
                if not self.pool.prepare_write(slot, int(lens_pre[slot])):
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
            result.latencies.append(now - result.arrival_time)
        else:
            result.latencies.append(now - flight.last_token_time)
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
                     shared_prefix: int = 0) -> list:
    """Poisson arrivals (exponential gaps in ticks), uniform prompt/decode
    lengths, an optional shared prompt prefix — the reference's generator
    with the same numpy draws (its single-priority form), so both packages
    serve the same requests."""
    rng = np.random.default_rng(seed)
    prefix = (rng.integers(0, vocab, shared_prefix) if shared_prefix
              else None)
    t = 0.0
    out = []
    for rid in range(n_requests):
        t += rng.exponential(1.0 / max(rate_per_tick, 1e-9))
        body = rng.integers(0, vocab, rng.integers(prompt_lens[0],
                                                   prompt_lens[1] + 1))
        out.append(Request(
            rid=rid,
            prompt=body if prefix is None else np.concatenate([prefix, body]),
            max_new_tokens=int(rng.integers(decode_lens[0],
                                            decode_lens[1] + 1)),
            arrival_tick=int(t)))
    return out
