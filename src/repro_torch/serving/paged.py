"""Paged KV-cache serving: block allocator, prefix sharing, block tables.

Port of ``src/repro/serving/paged.py`` (``BlockAllocator`` line 80,
``PrefixIndex`` 142, ``PagedSeq`` 231, ``SwappedSeq`` 240, ``PagedPool``
283) for the token families, the fixed-state family, whose block is a
sequence's whole state row: one column of the table, one block a
sequence admitted fresh and never shared (``_admit_state``, 526), written
by ``install_state`` (587) when its prefill ends, and no per-step block
upkeep; and the enc-dec family, whose table row is the audio's cross
blocks and one self row: admitted under the whole-audio key
(``_audio_key`` 520, ``_admit_encdec`` 544), the cross blocks shared by
every request of the same audio, written by ``install_encdec`` (593) when
a fresh encode ends and registered under that key.  The bookkeeping is
plain Python and matches the reference's state exactly: admission with
prefix sharing and copy-on-write at the divergence block,
``prepare_write`` before each decode step,
``finalize_prefill``, ``release`` into the persistent LRU prefix cache (or
straight to the free list with ``persistent_prefix=False``), the cache's
reclaim under pressure, ``probe``, ``device_tables(active_slots)`` with
sentinel masking, preempt-and-swap (``swap_out`` / ``prefetch_swap_in`` /
``swap_in``) and ``stats``.  Physical block 0 is the reserved sentinel.

Tables and lengths live on the host (numpy); ``device_tables`` hands the
engine a tensor on the pool's device for each step.

The swap on the card.  ``swap_out`` gathers a victim's exclusively-held
blocks with one ``index_select`` per pool leaf and copies them into pinned
host memory with one asynchronous copy per leaf, both on the current
stream; an event recorded after the copy marks the host copy complete.  The
freed blocks may go to another sequence at once: its writes queue behind
the copy on the same stream.  ``prefetch_swap_in`` stages the host copy
back onto the card on a stream of its own, which first waits on that event,
so the transfer overlaps a decode step already queued on the current
stream; ``swap_in`` makes the current stream wait on the staging event
before it writes the blocks back (``engine.write_paged_block``), and marks
the staged tensors used on the current stream (``record_stream``) so the
caching allocator does not hand their memory out while the write runs.  On
the CPU plain copies do the same work.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.serving import cache_family, engine


class DoubleFreeError(RuntimeError):
    """A block was dereferenced more times than it was referenced."""


class BlockAllocator:
    """Fixed pool of physical KV blocks: free list + per-block refcounts."""

    def __init__(self, num_blocks: int):
        if num_blocks < 1:
            raise ValueError(f"need at least one block (got {num_blocks})")
        self.num_blocks = int(num_blocks)
        self._ref = np.zeros(self.num_blocks, np.int32)
        self._free: deque[int] = deque(range(self.num_blocks))

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def live_blocks(self) -> int:
        return int((self._ref > 0).sum())

    def refcount(self, bid: int) -> int:
        return int(self._ref[bid])

    def alloc(self) -> Optional[int]:
        if not self._free:
            return None
        bid = self._free.popleft()
        self._ref[bid] = 1
        return bid

    def incref(self, bid: int) -> None:
        if self._ref[bid] <= 0:
            raise ValueError(f"incref of unallocated block {bid}")
        self._ref[bid] += 1

    def decref(self, bid: int) -> bool:
        """Drop one reference; True iff the block returned to the free list."""
        if self._ref[bid] <= 0:
            raise DoubleFreeError(f"block {bid} freed more times than "
                                  "referenced")
        self._ref[bid] -= 1
        if self._ref[bid] == 0:
            self._free.append(bid)
            return True
        return False

    def check_invariants(self) -> None:
        free = list(self._free)
        if len(free) != len(set(free)):
            raise AssertionError("free list holds duplicates")
        if not all(self._ref[b] == 0 for b in free):
            raise AssertionError("free-listed block with a live refcount")
        if not (self._ref >= 0).all():
            raise AssertionError("negative refcount")
        if len(free) + self.live_blocks != self.num_blocks:
            raise AssertionError("free + live does not partition the pool")


class PrefixIndex:
    """Token-prefix chain → physical block, at block granularity.

    Chain keys are nested tuples ``key_i = (key_{i-1}, tokens_of_block_i)``
    (exact match).  Full blocks map one key to one block; partial tails are
    kept per chain key as (tokens, block) candidates for copy-on-write."""

    def __init__(self):
        self._full: dict[tuple, int] = {}
        self._partial: dict[tuple, dict[tuple, int]] = {}
        self._by_block: dict[int, list] = {}

    @staticmethod
    def chain_keys(tokens, block_size: int) -> list:
        toks = tuple(int(t) for t in tokens)
        keys: list = []
        key: tuple = ()
        for i in range(len(toks) // block_size):
            key = (key, toks[i * block_size:(i + 1) * block_size])
            keys.append(key)
        return keys

    def lookup(self, key: tuple) -> Optional[int]:
        return self._full.get(key)

    def lookup_partial(self, key: tuple, rem_tokens, cap: int):
        """Best divergence-block candidate under ``key``: (block,
        shared_len) with the longest common prefix (≤ ``cap``), or (None, 0)."""
        best, best_len = None, 0
        for toks, bid in self._partial.get(key, {}).items():
            n = 0
            for a, b in zip(toks, rem_tokens):
                if a != b or n >= cap:
                    break
                n += 1
            if n > best_len:
                best, best_len = bid, n
        return best, best_len

    def register(self, key: tuple, bid: int) -> None:
        if key in self._full:
            return                        # first writer wins; same content
        self._full[key] = bid
        self._by_block.setdefault(bid, []).append(("full", key))

    def register_partial(self, key: tuple, tokens: tuple, bid: int) -> None:
        bucket = self._partial.setdefault(key, {})
        if tokens in bucket:
            return
        bucket[tokens] = bid
        self._by_block.setdefault(bid, []).append(("partial", key, tokens))

    def has_block(self, bid: int) -> bool:
        return bid in self._by_block

    def drop_block(self, bid: int) -> None:
        for entry in self._by_block.pop(bid, ()):
            if entry[0] == "full":
                self._full.pop(entry[1], None)
            else:
                bucket = self._partial.get(entry[1])
                if bucket is not None:
                    bucket.pop(entry[2], None)
                    if not bucket:
                        self._partial.pop(entry[1], None)

    def __len__(self) -> int:
        return len(self._full) + sum(len(b) for b in self._partial.values())


@dataclass
class PagedSeq:
    """One admitted sequence's paged-cache state."""
    slot: int                       # batch row / block-table row
    prompt: np.ndarray
    blocks: list = field(default_factory=list)   # physical ids, logical order
    matched: int = 0                # prompt tokens adopted from the index


@dataclass
class SwappedSeq:
    """A preempted sequence's host-side record (``PagedPool.swapped``).

    ``entries`` mirrors the block list in logical order: ``("shared", bid)``
    for a block another holder also references (kept resident, never
    copied), ``("host", j)`` for an exclusively-held block whose content is
    entry ``j`` of the block axis of ``host`` (leaf → [L, n, ...], pinned
    memory on the card's pools) and whose physical block was freed.
    ``length`` is the valid cache extent decode resumes from.  ``ready``
    is recorded on the current stream after the device → host copy;
    ``staged`` holds the device copy ``prefetch_swap_in`` made on the
    staging stream, complete at ``staged_ready``."""
    prompt: np.ndarray
    matched: int
    length: int
    entries: list
    host: dict = field(default_factory=dict)
    ready: Optional[object] = None              # torch.cuda.Event
    staged: dict = field(default_factory=dict)
    staged_ready: Optional[object] = None       # torch.cuda.Event


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


class PagedPool:
    """Block-pooled KV cache with per-slot block tables.

    ``num_blocks`` usable blocks (default: every slot at full length) plus
    the sentinel block 0; ``slot_len`` must be a multiple of ``block_size``.
    With ``persistent_prefix`` (default) indexed prompt blocks park in a
    persistent LRU prefix cache when their last sequence retires, reclaimed
    coldest-first under pressure; ``False`` frees them with their index
    entries.
    """

    def __init__(self, cfg: ModelConfig, num_slots: int, slot_len: int,
                 block_size: int, num_blocks: Optional[int] = None,
                 persistent_prefix: bool = True, device="cuda"):
        self.cfg = cfg
        self.family = cache_family.resolve(cfg)
        self.family.validate_geometry(slot_len, block_size)
        self.num_slots = num_slots
        self.slot_len = slot_len
        self.block_size = block_size
        self.device = torch.device(device)
        self.max_blocks = self.family.max_blocks(slot_len, block_size)
        usable = (num_blocks if num_blocks is not None
                  else num_slots * self.max_blocks)
        if usable < 1:
            raise ValueError(f"need at least one usable block (got {usable})")
        self.alloc = BlockAllocator(usable + 1)
        self._sentinel = self.alloc.alloc()
        if self._sentinel != 0:
            raise AssertionError("the sentinel must be physical block 0")
        self.index = PrefixIndex()
        self.caches = engine.init_paged_cache(cfg, usable + 1, block_size,
                                              self.device, slot_len=slot_len)
        self.lens = np.zeros((num_slots,), np.int32)
        self.tables = np.zeros((num_slots, self.max_blocks), np.int32)
        self._free_rows: deque[int] = deque(range(num_slots))
        self.seqs: dict[int, PagedSeq] = {}
        self.persistent_prefix = persistent_prefix
        # LRU prefix cache: bid → None, insertion order = cold → hot; each
        # member holds exactly one allocator reference
        self._cached: dict[int, None] = {}
        # host-side store of preempted sequences, keyed by request id
        self.swapped: dict[int, SwappedSeq] = {}
        # bytes of one physical block over every pool leaf
        self.block_bytes = sum(x[:, 0].numel() * x.element_size()
                               for x in self.caches.values())
        self._staging = (torch.cuda.Stream(device=self.device)
                         if self.device.type == "cuda" else None)
        self.blocks_shared = 0          # full blocks adopted via the index
        self.tokens_reused = 0          # prompt tokens whose prefill was skipped
        self.cow_copies = 0
        self.prefix_cache_hits = 0      # cache-held blocks revived by admission
        self.reclaimed_blocks = 0       # cold cached blocks fed to the free list
        self.swapped_blocks_out = 0     # exclusive blocks copied to the host
        self.swapped_blocks_in = 0      # host blocks restored by swap_in
        self.swapped_bytes_out = 0      # payload bytes of those copies
        self.swapped_bytes_in = 0
        self.swap_prefetched_blocks = 0  # host blocks staged ahead of swap_in
        self.min_free_blocks = self.alloc.free_blocks

    @property
    def free_slots(self) -> int:
        return len(self._free_rows)

    def fits(self, prompt_len: int) -> bool:
        """Whether a prompt of this length can ever be admitted."""
        return self.family.blocks_for_prompt(prompt_len, self.block_size) \
            <= self.alloc.num_blocks - 1

    @property
    def free_blocks(self) -> int:
        return self.alloc.free_blocks

    @property
    def cached_blocks(self) -> int:
        """Blocks parked in the persistent prefix cache (reclaimable)."""
        return len(self._cached)

    # -- persistent prefix cache (LRU) --------------------------------------
    def _touch(self, bid: int) -> None:
        if bid in self._cached:
            self._cached.pop(bid)
            self._cached[bid] = None

    def _reclaim_until(self, free_target: int, exclude=()) -> None:
        """Feed cold cached blocks (LRU-first) to the free list until
        ``free_target`` blocks are free or the cache is spent."""
        exclude = set(exclude)
        for bid in list(self._cached):
            if self.alloc.free_blocks >= free_target:
                break
            if bid in exclude or self.alloc.refcount(bid) > 1:
                continue
            del self._cached[bid]
            self.index.drop_block(bid)
            if self.alloc.decref(bid):
                self.reclaimed_blocks += 1

    def device_tables(self, active_slots=None) -> torch.Tensor:
        """Block tables [num_slots, M] for a batched decode step.  Rows not
        in ``active_slots`` (idle or mid-prefill, length 0) are masked to the
        sentinel, so their garbage write lands in block 0 and never in a
        block a prefill already filled."""
        if active_slots is None:
            t = self.tables
        else:
            t = np.full_like(self.tables, self._sentinel)
            for s in active_slots:
                t[s] = self.tables[s]
        return torch.from_numpy(np.ascontiguousarray(t)).to(self.device)

    def device_row(self, slot: int) -> torch.Tensor:
        return torch.from_numpy(self.tables[slot:slot + 1].copy()).to(
            self.device)

    # -- admission ----------------------------------------------------------
    def admit(self, prompt) -> Optional[PagedSeq]:
        """Match the prompt against the prefix index, then claim a batch row
        plus the fresh blocks the unmatched part needs (prompt + the first
        decode write).  None when either is unavailable.  At most
        ``len(prompt) - 1`` tokens are adopted.  A fixed-state family
        claims one fresh, unshared row block (``_admit_state``); an enc-dec
        family matches the whole audio and claims a self row block
        (``_admit_encdec``)."""
        if not self._free_rows:
            return None
        if self.family.kind == "state":
            return self._admit_state(prompt)
        if self.family.kind == "encdec":
            return self._admit_encdec(prompt)
        toks = [int(t) for t in prompt]
        n = len(toks)
        bs = self.block_size
        cap = n - 1
        shared: list[int] = []
        key: tuple = ()
        matched = 0
        for k2 in PrefixIndex.chain_keys(toks, bs):
            if matched + bs > cap:
                break
            bid = self.index.lookup(k2)
            if bid is None:
                break
            shared.append(bid)
            key = k2
            matched += bs
        tail_src, tail_len = (None, 0)
        if matched < cap:
            tail_src, tail_len = self.index.lookup_partial(
                key, toks[matched:], cap - matched)
        total = _ceil_div(n + 1, bs)
        fresh_needed = total - len(shared)
        if self.alloc.free_blocks < fresh_needed:
            protect = set(shared)
            if tail_src is not None:
                protect.add(tail_src)
            self._reclaim_until(fresh_needed, exclude=protect)
        if self.alloc.free_blocks < fresh_needed:
            return None
        slot = self._free_rows.popleft()
        for bid in shared:
            if self.alloc.refcount(bid) == 1 and bid in self._cached:
                self.prefix_cache_hits += 1
            self.alloc.incref(bid)
            self._touch(bid)
        if tail_src is not None:
            self._touch(tail_src)
        blocks = list(shared)
        for _ in range(fresh_needed):
            bid = self.alloc.alloc()
            blocks.append(bid)
        if tail_src is not None:
            # copy-on-write at the divergence block
            engine.copy_paged_block(self.caches, tail_src, blocks[len(shared)])
            self.cow_copies += 1
            matched += tail_len
        self.blocks_shared += len(shared)
        self.tokens_reused += matched
        self.tables[slot, :len(blocks)] = blocks
        seq = PagedSeq(slot=slot, prompt=np.asarray(toks, np.int64),
                       blocks=blocks, matched=matched)
        self.seqs[slot] = seq
        self.min_free_blocks = min(self.min_free_blocks,
                                   self.alloc.free_blocks)
        return seq

    def _admit_state(self, prompt) -> Optional[PagedSeq]:
        """Fixed-state admission: one fresh block (the whole state row),
        never shared — the state changes in place every decode step."""
        if self.alloc.free_blocks < 1:
            self._reclaim_until(1)
        bid = self.alloc.alloc()
        if bid is None:
            return None
        slot = self._free_rows.popleft()
        self.tables[slot, 0] = bid
        seq = PagedSeq(slot=slot,
                       prompt=np.asarray([int(t) for t in prompt], np.int64),
                       blocks=[bid], matched=0)
        self.seqs[slot] = seq
        self.min_free_blocks = min(self.min_free_blocks,
                                   self.alloc.free_blocks)
        return seq

    @staticmethod
    def _audio_key(toks, block_size: int) -> tuple:
        """The whole-audio identity an enc-dec prompt shares under: the
        chain key over every frame block, which encodes the whole frame
        sequence, so two prompts share it iff they are the same audio."""
        return PrefixIndex.chain_keys(toks, block_size)[-1]

    def _admit_encdec(self, prompt) -> Optional[PagedSeq]:
        """Enc-dec admission: adopt the whole audio's encoder blocks on an
        exact match (refcount + 1, no encoder run), else claim fresh ones;
        always claim one self-K/V row block."""
        toks = [int(t) for t in prompt]
        nc = self.max_blocks - 1
        audio = self._audio_key(toks, self.block_size)
        shared: list[int] = []
        for i in range(nc):
            bid = self.index.lookup((audio, i))
            if bid is None:
                shared = []             # all or nothing by construction
                break
            shared.append(bid)
        fresh_needed = (nc - len(shared)) + 1          # + the self row
        if self.alloc.free_blocks < fresh_needed:
            self._reclaim_until(fresh_needed, exclude=shared)
        if self.alloc.free_blocks < fresh_needed:
            return None
        slot = self._free_rows.popleft()
        for bid in shared:
            if self.alloc.refcount(bid) == 1 and bid in self._cached:
                self.prefix_cache_hits += 1
            self.alloc.incref(bid)
            self._touch(bid)
        blocks = list(shared)
        for _ in range(fresh_needed):
            blocks.append(self.alloc.alloc())
        matched = len(toks) if shared else 0
        self.blocks_shared += len(shared)
        self.tokens_reused += matched
        self.tables[slot, :len(blocks)] = blocks
        seq = PagedSeq(slot=slot, prompt=np.asarray(toks, np.int64),
                       blocks=blocks, matched=matched)
        self.seqs[slot] = seq
        self.min_free_blocks = min(self.min_free_blocks,
                                   self.alloc.free_blocks)
        return seq

    def install_encdec(self, seq: PagedSeq, caches: dict) -> None:
        """Write a freshly prefilled batch-1 decoder cache into the pool:
        the self row always; the cross blocks only when this sequence
        computed them (a hit adopted the same shared blocks, which are not
        written again: their ids are routed out of range and dropped)."""
        nc = self.max_blocks - 1
        cross = ([self.alloc.num_blocks] * nc if seq.matched
                 else seq.blocks[:nc])
        engine.install_encdec_row(
            self.caches, caches,
            torch.tensor(cross, dtype=torch.int64, device=self.device),
            torch.tensor([seq.blocks[nc]], dtype=torch.int64,
                         device=self.device))

    def install_state(self, seq: PagedSeq, caches: dict) -> None:
        """Write a freshly-prefilled batch-1 contiguous cache into the
        sequence's state row block, in place."""
        rows = torch.tensor([seq.blocks[0]], dtype=torch.int64,
                            device=self.device)
        engine.scatter_state_rows(self.cfg, self.caches, caches, rows)

    def finalize_prefill(self, seq: PagedSeq) -> None:
        """Register the finished prompt's block chain so later arrivals with
        the same prefix share it (full blocks exact, a partial tail as a
        divergence candidate); an enc-dec sequence's cross blocks under
        its whole-audio key."""
        if not self.family.shareable:
            return
        toks = [int(t) for t in seq.prompt]
        bs = self.block_size
        if self.family.kind == "encdec":
            # the cross blocks, under the whole-audio key
            audio = self._audio_key(toks, bs)
            for i, bid in enumerate(seq.blocks[:self.max_blocks - 1]):
                self.index.register((audio, i), bid)
            return
        key: tuple = ()
        n_full = len(toks) // bs
        for i in range(n_full):
            tup = tuple(toks[i * bs:(i + 1) * bs])
            key_i = (key, tup)
            self.index.register(key_i, seq.blocks[i])
            if i == n_full - 1 and len(toks) == n_full * bs:
                # block-aligned prompt: also a divergence candidate, so an
                # identical prompt CoW-copies it and prefills one token
                self.index.register_partial(key, tup, seq.blocks[i])
            key = key_i
        rem = tuple(toks[n_full * bs:])
        if rem:
            self.index.register_partial(key, rem, seq.blocks[n_full])

    def probe(self, prompt) -> int:
        """Read-only: prompt tokens an ``admit`` would adopt right now (none
        for a fixed-state family, the whole audio or none for enc-dec)."""
        if self.family.kind == "state":
            return 0
        toks = [int(t) for t in prompt]
        if self.family.kind == "encdec":
            audio = self._audio_key(toks, self.block_size)
            return len(toks) if self.index.lookup((audio, 0)) is not None \
                else 0
        cap = len(toks) - 1
        bs = self.block_size
        matched = 0
        key: tuple = ()
        for k2 in PrefixIndex.chain_keys(toks, bs):
            if matched + bs > cap or self.index.lookup(k2) is None:
                break
            key = k2
            matched += bs
        if matched < cap:
            _, tail_len = self.index.lookup_partial(key, toks[matched:],
                                                    cap - matched)
            matched += tail_len
        return matched

    # -- decode-time block upkeep -------------------------------------------
    def _alloc_reclaiming(self, exclude=()) -> Optional[int]:
        bid = self.alloc.alloc()
        if bid is None:
            self._reclaim_until(1, exclude=exclude)
            bid = self.alloc.alloc()
        return bid

    def prepare_write(self, slot: int, pos: int) -> bool:
        """Make position ``pos`` of ``slot`` writable before the decode step:
        allocate the next block at a boundary, copy-on-write a block another
        holder references.  False: out of blocks even after reclaiming.  A
        fixed-state row is rewritten in place: nothing to do."""
        if self.family.kind != "token":
            return True
        seq = self.seqs[slot]
        bi = pos // self.block_size
        if bi > len(seq.blocks):
            raise AssertionError(f"write at block {bi} skips past the "
                                 f"{len(seq.blocks)} blocks of slot {slot}")
        if bi < len(seq.blocks):
            bid = seq.blocks[bi]
            if self.alloc.refcount(bid) > 1:
                fresh = self._alloc_reclaiming(exclude=seq.blocks)
                if fresh is None:
                    return False
                engine.copy_paged_block(self.caches, bid, fresh)
                if self.alloc.decref(bid):
                    self.index.drop_block(bid)
                seq.blocks[bi] = fresh
                self.tables[slot, bi] = fresh
                self.cow_copies += 1
                self.min_free_blocks = min(self.min_free_blocks,
                                           self.alloc.free_blocks)
            return True
        fresh = self._alloc_reclaiming(exclude=seq.blocks)
        if fresh is None:
            return False
        seq.blocks.append(fresh)
        self.tables[slot, len(seq.blocks) - 1] = fresh
        self.min_free_blocks = min(self.min_free_blocks,
                                   self.alloc.free_blocks)
        return True

    # -- retirement ---------------------------------------------------------
    def release(self, slot: int) -> None:
        """Retire ``slot``: drop its reference on every block; a block whose
        last reference this was parks in the prefix cache if the index maps
        it, else returns to the free list."""
        seq = self.seqs.pop(slot, None)
        if seq is None:
            return
        for bid in seq.blocks:
            if (self.persistent_prefix and self.alloc.refcount(bid) == 1
                    and self.index.has_block(bid)):
                self._cached[bid] = None
                continue
            if self.alloc.decref(bid):
                self.index.drop_block(bid)
        self.tables[slot, :] = self._sentinel
        self.lens[slot] = 0
        self._free_rows.append(slot)

    # -- preempt-and-swap ---------------------------------------------------
    def swap_out(self, slot: int, rid: int) -> SwappedSeq:
        """Suspend ``slot``'s sequence to the host-side store under ``rid``.

        Refcount-aware: a block shared with another live sequence or with
        the prefix cache keeps this sequence's reference and is never copied
        out.  The exclusively-held blocks are gathered and copied to the
        host in one asynchronous copy per leaf (pinned memory on the card),
        then freed.  The batch row, table row and length are released like a
        retirement; ``swap_in`` rebuilds them."""
        seq = self.seqs.pop(slot)
        entries: list = []
        out: list = []
        for bid in seq.blocks:
            if self.alloc.refcount(bid) > 1:
                entries.append(("shared", bid))
                continue
            entries.append(("host", len(out)))
            out.append(bid)
        rec = SwappedSeq(prompt=seq.prompt, matched=seq.matched,
                         length=int(self.lens[slot]), entries=entries)
        if out:
            rec.host, rec.ready = self._copy_out(out)
            for bid in out:
                if self.alloc.decref(bid):
                    self.index.drop_block(bid)
            self.swapped_blocks_out += len(out)
            self.swapped_bytes_out += len(out) * self.block_bytes
        self.swapped[rid] = rec
        self.tables[slot, :] = self._sentinel
        self.lens[slot] = 0
        self._free_rows.append(slot)
        return rec

    def _copy_out(self, bids: list):
        """Copies of blocks ``bids`` off the pool: (leaf → [L, n, ...] on
        the host, the event after the copy, or None on the CPU)."""
        idx = torch.as_tensor(bids, dtype=torch.int64).to(self.device,
                                                           non_blocking=True)
        host = {}
        for name, x in self.caches.items():
            blocks = x.index_select(1, idx)
            if self.device.type == "cuda":
                host[name] = torch.empty(blocks.shape, dtype=blocks.dtype,
                                         pin_memory=True)
                host[name].copy_(blocks, non_blocking=True)
            else:
                host[name] = blocks          # index_select copied already
        if self.device.type != "cuda":
            return host, None
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self.device))
        return host, ready

    def swap_in(self, rid: int) -> Optional[PagedSeq]:
        """Resume the sequence ``swap_out`` stored under ``rid``: claim a
        batch row, restore the host-copied blocks into freshly-allocated
        blocks (reclaiming cold cached blocks if the free list runs short),
        reattach the kept shared blocks and rebuild the table at the
        suspended length — no re-prefill.  None when a row or the blocks are
        unavailable; the record stays stored for a later attempt."""
        rec = self.swapped[rid]
        if not self._free_rows:
            return None
        kept = {e[1] for e in rec.entries if e[0] == "shared"}
        need = sum(1 for e in rec.entries if e[0] == "host")
        if self.alloc.free_blocks < need:
            self._reclaim_until(need, exclude=kept)
        if self.alloc.free_blocks < need:
            return None
        del self.swapped[rid]
        slot = self._free_rows.popleft()
        blocks: list = []
        fresh: list = []
        for kind, payload in rec.entries:
            if kind == "shared":
                blocks.append(payload)
                self._touch(payload)
                continue
            bid = self.alloc.alloc()
            blocks.append(bid)
            fresh.append(bid)
        if fresh:
            engine.write_paged_block(self.caches, self._restore_source(rec),
                                     fresh)
            self.swapped_blocks_in += len(fresh)
            self.swapped_bytes_in += len(fresh) * self.block_bytes
        self.tables[slot, :] = self._sentinel
        self.tables[slot, :len(blocks)] = blocks
        self.lens[slot] = rec.length
        seq = PagedSeq(slot=slot, prompt=rec.prompt, blocks=blocks,
                       matched=rec.matched)
        self.seqs[slot] = seq
        self.min_free_blocks = min(self.min_free_blocks,
                                   self.alloc.free_blocks)
        return seq

    def _restore_source(self, rec: SwappedSeq) -> dict:
        """What ``swap_in`` writes back: the staged device copy, once the
        current stream waits for it (and holds its memory until the write
        ran), else the host copy."""
        if not rec.staged:
            return rec.host
        if self.device.type == "cuda":
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(rec.staged_ready)
            for t in rec.staged.values():
                t.record_stream(cur)
        return rec.staged

    def prefetch_swap_in(self, rid: int) -> int:
        """Stage the suspended sequence's host blocks onto the pool's
        device ahead of its ``swap_in``.  On the card the copies run on the
        staging stream after the swap-out copy's event, overlapping whatever
        the current stream has queued (the scheduler calls this right after
        a decode step is issued).  Idempotent; returns the blocks newly
        staged (0 for an unknown rid)."""
        rec = self.swapped.get(rid)
        if rec is None or rec.staged or not rec.host:
            return 0
        if self._staging is None:
            rec.staged = {n: h.clone() for n, h in rec.host.items()}
        else:
            self._staging.wait_event(rec.ready)
            with torch.cuda.stream(self._staging):
                rec.staged = {n: h.to(self.device, non_blocking=True)
                              for n, h in rec.host.items()}
                rec.staged_ready = torch.cuda.Event()
                rec.staged_ready.record(self._staging)
        staged = sum(1 for e in rec.entries if e[0] == "host")
        self.swap_prefetched_blocks += staged
        return staged

    def stats(self) -> dict:
        return {
            "block_size": self.block_size,
            "num_blocks": self.alloc.num_blocks - 1,      # minus sentinel
            "free_blocks": self.alloc.free_blocks,
            "min_free_blocks": self.min_free_blocks,
            "blocks_shared": self.blocks_shared,
            "tokens_reused": self.tokens_reused,
            "cow_copies": self.cow_copies,
            "cached_blocks": len(self._cached),
            "prefix_cache_hits": self.prefix_cache_hits,
            "reclaimed_blocks": self.reclaimed_blocks,
            "swapped_blocks_out": self.swapped_blocks_out,
            "swapped_blocks_in": self.swapped_blocks_in,
            "swapped_bytes_out": self.swapped_bytes_out,
            "swapped_bytes_in": self.swapped_bytes_in,
            "swap_prefetched_blocks": self.swap_prefetched_blocks,
        }
