"""Serving primitives: cache init, prefill, decode steps, logits and
sampling, for three serving shapes over one decoder (dense, MoE, MLA or
recurrent), and the encoder-decoder's paged serving.

* **Lockstep batch** (``prefill`` + ``decode_step``): one scalar cache
  length shared by every row, the drain-and-refill baseline; a VLM's
  patch embeddings prefill ahead of the prompts here, as in the
  reference.
* **Slot pool** (``chunked_prefill`` / ``prefill_chunk`` / ``write_slot`` /
  ``decode_step_slots``): contiguous per-slot caches with a [B] length
  vector; a finished slot is overwritten by the next request's prefilled
  cache.
* **Paged pool** (``init_paged_cache`` / ``copy_paged_block`` /
  ``write_paged_block`` / ``prefill_chunk_paged`` / ``decode_step_paged``):
  a shared block pool read through block tables; not for MLA
  (``paged_supported``).  A fixed-state config's pool holds one state row
  a sequence (``gather_state_rows`` / ``scatter_state_rows`` /
  ``decode_step_state``).  An enc-dec config's pool holds each audio's
  cross-K/V blocks, shared by every request of that audio, and one decoder
  self row a sequence (``encdec_prefill`` / ``encdec_prefill_cached`` /
  ``install_encdec_row`` / ``decode_step_encdec_paged``).

The contiguous caches are the cache family's layout: attention K/V
``{"k", "v": [L, B, S, Hkv, D]}`` (int8 adds ``"k_scale"``,
``"v_scale"``), an MLA model's latents ``{"c_kv": [L, B, S, R],
"k_rope": [L, B, S, Dr]}``, or a recurrent model's state leaves
(``cache_family.FixedStateFamily``); every function here goes over the
leaves the family gave, whichever they are.

Port of ``src/repro/serving/engine.py`` for the dense families (dense, MoE
and MLA blocks) and the fixed-state family (mamba, mlstm and slstm blocks,
and zamba2's shared attention):
``init_cache`` (line 49), ``prefill`` (55; ``patch_embeds`` at 63-66),
``logits_from_hidden`` (69), ``decode_step`` (80), ``prefill_schedule``
(111), ``chunked_prefill`` (135),
``prefill_chunk`` (165), ``write_slot`` (182), ``sample_per_slot`` (199),
``decode_step_slots`` (218), ``paged_supported`` (241),
``init_paged_cache`` (251),
``copy_paged_block`` (265), ``write_paged_block`` (276),
``prefill_chunk_paged`` (291),
``decode_step_paged`` (305), ``gather_state_rows`` (330),
``scatter_state_rows`` (346) and ``decode_step_state`` (366); and for the
enc-dec family ``encdec_prefill`` (391), ``encdec_decode_step`` (411),
``ENCDEC_BOS`` (431), ``encdec_frames_from_ids`` (434),
``encdec_prefill_cached`` (442), ``encdec_decode_step_slots`` (460),
``gather_encdec_rows`` (475), ``gather_encdec_cross`` (495),
``install_encdec_row`` (509) and ``decode_step_encdec_paged`` (535).  Caches and pools are updated in place
(the JAX code returned new ones; its out-of-range "drop" writes are masked
``index_copy_``s here); functions still return them so the call sites read
like the reference's.

Under a ``distributed.context.ShardContext`` the lockstep batch runs
sharded, as the reference's ``decode_step`` (lines 90-96) under its
context: every rank holds its rows of the batch (``batch_axes``) and its
slice of the caches' sequence (``cache_seq_axes``); ``prefill`` runs the
rank's rows over the whole prompt, replicated over the sequence group,
with the kernels it runs unsharded, then keeps the rank's slice; a decode
step's attention ⊕-merges the slices' partials and ``sample`` draws the
token through ``sharded_topk_sample`` over the vocabulary split across the
model axis.  The attention K/V families only (fp and int8): a latent or
recurrent cache under a context raises.

Sampling takes its Gumbel noise as an argument: the scheduler draws it from
one ``torch.Generator`` per request (or a test's ``noise_fn``), so a row's
token depends only on its own logits and noise — what makes batched decode
reproduce solo decode token for token.  ``temperature`` divides the logits
before the vocabulary pass unless it is 1.0, as in the reference.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.topk_fusion import gumbel_pick, topk_sample
from repro_torch.distributed import context
from repro_torch.kernels import dispatch
from repro_torch.models import encdec, transformer
from repro_torch.serving import cache_family

Tensor = torch.Tensor


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device="cuda") -> dict:
    """Zeroed contiguous caches, the layout the config's cache family owns:
    {"k", "v": [L, B, S, Hkv, D]} (and int8's scales), or MLA's latents
    {"c_kv": [L, B, S, R], "k_rope": [L, B, S, Dr]}."""
    return cache_family.resolve(cfg).init_cache(batch, max_len, device)


def prefill(params: dict, tokens: Tensor, cfg: ModelConfig, *,
            max_len: int, patch_embeds: Optional[Tensor] = None):
    """Run the prompts tokens [B, T] through the model into fresh caches of
    ``max_len`` on the tokens' device; a VLM's ``patch_embeds`` [B, P, D]
    go first (``transformer.forward``), so the cache holds P + T positions.
    Returns (last_hidden [B, D], caches, cache_len = T, or T + P with
    patches).  Under a ``ShardContext``, ``tokens`` are the rank's rows and
    the caches come back as the rank's slice of the sequence (``max_len``
    must split evenly over the context's ``cache_seq_axes``)."""
    ctx = context.get()
    if ctx is not None:
        return _prefill_sharded(ctx, params, tokens, cfg, max_len=max_len,
                                patch_embeds=patch_embeds)
    caches = init_cache(cfg, tokens.shape[0], max_len, tokens.device)
    hidden, caches = transformer.forward(params, tokens, cfg,
                                         patch_embeds=patch_embeds,
                                         caches=caches, cache_len=0)
    return hidden[:, -1], caches, tokens.shape[1] + (
        cfg.num_patches if patch_embeds is not None else 0)


#: the cache leaves a sequence-sharded lockstep batch takes: attention K/V,
#: and int8 K/V's scales
SHARDED_CACHE_LEAVES = {"k", "v", "k_scale", "v_scale"}


def _prefill_sharded(ctx, params, tokens, cfg, *, max_len, patch_embeds):
    """``prefill`` under a context: the rank's rows over the whole prompt
    (no context: the same kernels as one process), then the rank's slice
    of each cache leaf [L, B, S, ...] along S."""
    n = context.axis_size(ctx.mesh, ctx.cache_seq_axes)
    if max_len % n:
        raise ValueError(f"sharded prefill: max_len {max_len} does not split "
                         f"over {n} sequence shards")
    with context.use(None):
        last, caches, length = prefill(params, tokens, cfg, max_len=max_len,
                                       patch_embeds=patch_embeds)
    if not set(caches) <= SHARDED_CACHE_LEAVES:
        raise NotImplementedError(
            f"a sequence-sharded lockstep batch takes attention K/V caches, "
            f"not {sorted(caches)}")
    s_local = max_len // n
    start = context.axis_index(ctx.mesh, ctx.cache_seq_axes) * s_local
    return last, {name: leaf[:, :, start:start + s_local].contiguous()
                  for name, leaf in caches.items()}, length


def sample(logits: Tensor, top_k: int, *, noise=None, generator=None,
           temperature: float = 1.0):
    """(tokens [B], top probs [B, k]) from logits [B, V]: the fused
    softmax+top-k and Gumbel-max (``core.topk_sample``), or under a
    ``ShardContext`` its vocabulary-sharded form over the model axis
    (``sharded_topk_sample``, the reference's ``decode_step`` lines
    90-96)."""
    ctx = context.get()
    if ctx is None:
        return topk_sample(logits, top_k, noise=noise, generator=generator,
                           temperature=temperature)
    from repro_torch.distributed.decode_attention import sharded_topk_sample
    return sharded_topk_sample(logits, top_k, mesh=ctx.mesh,
                               batch_axes=ctx.batch_axes,
                               vocab_axis=ctx.par.model_axis,
                               temperature=temperature, noise=noise,
                               generator=generator)


def decode_step(params: dict, caches: dict, cache_len: int, tokens: Tensor,
                cfg: ModelConfig, *, noise=None, generator=None,
                top_k: int = 5, temperature: float = 1.0):
    """One lockstep decode step: tokens [B, 1] at the shared length
    ``cache_len`` → (next_token [B], caches, cache_len + 1).  The vocabulary
    pass is the fused softmax+top-k (``sample``: vocabulary-sharded under a
    ``ShardContext``), with one Gumbel draw [B, k] for the batch:
    ``noise``, or from ``generator``."""
    hidden, caches = transformer.forward(params, tokens, cfg, caches=caches,
                                         cache_len=cache_len)
    logits = logits_from_hidden(params, hidden[:, -1], cfg)
    next_tok, _ = sample(logits, top_k, noise=noise, generator=generator,
                         temperature=temperature)
    return next_tok, caches, cache_len + 1


def logits_from_hidden(params: dict, last_hidden: Tensor,
                       cfg: ModelConfig) -> Tensor:
    """LM-head logits [B, V] (fp32) from the last-position hidden state
    [B, D], with padded vocab rows masked to -inf."""
    logits = transformer.logits_last(params, last_hidden[:, None], cfg)
    if cfg.real_vocab_size and cfg.real_vocab_size < cfg.vocab_size:
        mask = torch.arange(cfg.vocab_size, device=logits.device) \
            < cfg.real_vocab_size
        logits = logits.masked_fill(~mask, float("-inf"))
    return logits


def prefill_schedule(t: int, chunk: int) -> list:
    """Chunk widths for a ``t``-token prompt: full ``chunk``s, then a binary
    (power-of-two) decomposition of the remainder — the reference's schedule
    verbatim, so chunking (and hence numerics) match."""
    sizes = []
    rem = int(t)
    while rem >= chunk:
        sizes.append(chunk)
        rem -= chunk
    p = 1
    while p * 2 <= rem:
        p *= 2
    while rem:
        if p <= rem:
            sizes.append(p)
            rem -= p
        p //= 2
    return sizes


def chunked_prefill(params: dict, tokens: Tensor, cfg: ModelConfig, *,
                    max_len: int, chunk: int = 0):
    """Prefill prompts tokens [B, T] in ``prefill_schedule`` chunks against
    fresh caches of ``max_len`` (``chunk=0``, or one at least T, is a single
    shot; a single-shot family, int8 K/V, always goes in whole) — the slot
    pool's canonical single-sequence prefill, the same per-chunk step the
    scheduler interleaves with decode.  Returns (last_hidden [B, D], caches,
    length)."""
    t = tokens.shape[1]
    if cache_family.resolve(cfg).single_shot_prefill:
        chunk = 0
    caches = init_cache(cfg, tokens.shape[0], max_len, tokens.device)
    length, pos, last = 0, 0, None
    for c in prefill_schedule(t, chunk or t):
        last, caches, length = prefill_chunk(params, caches, length,
                                             tokens[:, pos:pos + c], cfg)
        pos += c
    return last, caches, length


def prefill_chunk(params: dict, caches: dict, cache_len: Union[int, Tensor],
                  tokens: Tensor, cfg: ModelConfig):
    """Advance a prefill by one chunk: tokens [B, c] are written into the
    caches at ``cache_len`` (a scalar, or per-row [B]) and attended causally
    against everything before them, in absolute coordinates.  Returns
    (last_hidden [B, D], caches, cache_len + c)."""
    hidden, caches = transformer.forward(params, tokens, cfg, caches=caches,
                                         cache_len=cache_len)
    return hidden[:, -1], caches, cache_len + tokens.shape[1]


def write_slot(cfg: ModelConfig, pool: dict, seq: dict, slot: int) -> dict:
    """Overwrite slot ``slot`` of the pool caches [L, B, S, ...] with a
    batch-1 sequence cache [L, 1, S, ...] of the same ``max_len``, in place:
    the whole slot is replaced, so nothing a retired sequence left behind
    survives.  (The reference rebuilt the whole pool, which is JAX's
    immutability, not the semantics.)"""
    for name, arr in pool.items():
        arr[:, slot] = seq[name][:, 0].to(arr.dtype)
    return pool


def sample_per_slot(logits: Tensor, top_k: int, noise: Tensor,
                    temperature: float = 1.0) -> Tensor:
    """Fused softmax+top-k (paper Alg. 4, through ``dispatch``) of the
    logits over ``temperature`` (untouched at 1.0), then a Gumbel-max pick
    with per-row noise ``noise`` [B, k]."""
    if temperature != 1.0:
        logits = logits / temperature
    out = dispatch.softmax_topk(logits, top_k)
    return gumbel_pick(out, noise)


def paged_supported(cfg: ModelConfig) -> bool:
    """Whether the config's cache family has a block-pool layout: the
    attention K/V of dense and MoE blocks, fp or int8, and a recurrent
    model's state rows; an MLA model's latent cache is contiguous only."""
    return cache_family.resolve(cfg).paged_serveable


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     device="cuda", slot_len=None) -> dict:
    """Zeroed block pools {"k", "v": [L, P, Hkv, BS, D]} — kernel-native
    page layout, no batch axis; ``num_blocks`` includes the sentinel 0.
    A fixed-state config's pool is ``num_blocks`` state rows, each sized
    by ``slot_len``.  Raises the reference's ``ValueError`` for a config
    without one (``paged_supported``)."""
    return cache_family.resolve(cfg).init_paged_cache(
        num_blocks, block_size, device, slot_len=slot_len)


def copy_paged_block(pools: dict, src: int, dst: int) -> dict:
    """Copy physical block ``src`` over ``dst`` in every layer's pool, in
    place — the copy-on-write primitive behind prefix-sharing divergence."""
    for pool in pools.values():
        pool[:, dst] = pool[:, src]
    return pools


def write_paged_block(pools: dict, blocks: dict, dst) -> dict:
    """Write block contents into physical blocks ``dst`` (a list of ids) of
    every pool leaf, in place — the swap-in restore primitive.  ``blocks``
    maps each leaf name to [L, len(dst), ...], the leaf with its block axis
    cut to those blocks (on any device; a copy from pinned host memory is
    asynchronous).  Every leaf moves, so an int8 pool restores its scale
    pages with the payload, and the write replaces whole blocks in the
    pool's dtype: a swap round trip is bit-exact."""
    device = next(iter(pools.values())).device
    idx = torch.as_tensor(dst, dtype=torch.int64).to(device, non_blocking=True)
    for name, pool in pools.items():
        pool.index_copy_(1, idx, blocks[name].to(device, non_blocking=True))
    return pools


def prefill_chunk_paged(params: dict, pools: dict, block_tables: Tensor,
                        cache_len: Union[int, Tensor], tokens: Tensor,
                        cfg: ModelConfig):
    """Advance a paged prefill by one chunk: tokens [1, c] are written into
    the pool through ``block_tables`` [1, M] at ``cache_len`` and attended
    causally against the valid prefix.  Returns (last_hidden [1, D], pools,
    new length)."""
    hidden, pools = transformer.forward(params, tokens, cfg, caches=pools,
                                        cache_len=cache_len,
                                        block_tables=block_tables)
    return hidden[:, -1], pools, cache_len + tokens.shape[1]


def decode_step_slots(params: dict, caches: dict, slot_lens: Tensor,
                      tokens: Tensor, cfg: ModelConfig, *, noise: Tensor,
                      top_k: int = 5, temperature: float = 1.0):
    """One decode step over the whole slot pool: tokens [B, 1], per-slot
    lengths [B], Gumbel noise [B, k] → (next_token [B], caches,
    slot_lens + 1).  Every slot advances one position at its own offset;
    the per-row valid lengths mask the ragged caches."""
    hidden, caches = transformer.forward(params, tokens, cfg, caches=caches,
                                         cache_len=slot_lens)
    logits = logits_from_hidden(params, hidden[:, -1], cfg)
    next_tok = sample_per_slot(logits, top_k, noise, temperature)
    return next_tok, caches, slot_lens + 1


def decode_step_paged(params: dict, pools: dict, block_tables: Tensor,
                      slot_lens: Tensor, tokens: Tensor, cfg: ModelConfig, *,
                      noise: Tensor, top_k: int = 5,
                      temperature: float = 1.0):
    """One decode step over the paged pool: tokens [B, 1], block_tables
    [B, M], per-slot lengths [B], Gumbel noise [B, k] → (next_token [B],
    pools, slot_lens + 1)."""
    hidden, pools = transformer.forward(params, tokens, cfg, caches=pools,
                                        cache_len=slot_lens,
                                        block_tables=block_tables)
    logits = logits_from_hidden(params, hidden[:, -1], cfg)
    next_tok = sample_per_slot(logits, top_k, noise, temperature)
    return next_tok, pools, slot_lens + 1


# ---------------------------------------------------------------------------
# Fixed-state (SSM / xLSTM / hybrid) paged serving: one block is one
# sequence's whole state row, the contiguous layout with the pool's block
# axis where the batch axis was (position 1 of every leaf).
# ---------------------------------------------------------------------------
def gather_state_rows(cfg: ModelConfig, pools: dict, rows: Tensor) -> dict:
    """Pool rows ``rows`` [B] as a contiguous batch-B cache, the layout
    ``init_cache(cfg, B, slot_len)`` gives, so the slot pool's decode step
    runs on it unchanged (a copy: the pool is not touched)."""
    return {name: x.index_select(1, rows) for name, x in pools.items()}


def scatter_state_rows(cfg: ModelConfig, pools: dict, caches: dict,
                       rows: Tensor) -> dict:
    """Write a contiguous batch-B cache back into pool rows ``rows`` [B],
    in place.  Row indices outside the pool are dropped, so a row routed
    there (an inactive slot) never writes live state."""
    keep, dst = _kept(rows, next(iter(pools.values())).shape[1])
    for name, x in pools.items():
        x.index_copy_(1, dst, caches[name].index_select(1, keep).to(x.dtype))
    return pools


def decode_step_state(params: dict, pools: dict, rows: Tensor,
                      active: Tensor, slot_lens: Tensor, tokens: Tensor,
                      cfg: ModelConfig, *, noise: Tensor, top_k: int = 5,
                      temperature: float = 1.0):
    """One decode step over a fixed-state pool: rows [B] (each slot's
    state row), active [B] bool, per-slot lengths [B], tokens [B, 1] →
    (next_token [B], pools, slot_lens + 1).  Each active slot's row is
    gathered, the slot pool's decode step runs on the copy, and the new
    state is scattered back.  Inactive slots gather the sentinel row 0 and
    their writes are dropped, so they never touch live state; rows are
    independent through the whole network, so an active slot's stream is
    its solo decode's."""
    n = next(iter(pools.values())).shape[1]
    caches = gather_state_rows(cfg, pools, torch.where(active, rows, 0))
    next_tok, caches, new_lens = decode_step_slots(
        params, caches, slot_lens, tokens, cfg, noise=noise, top_k=top_k,
        temperature=temperature)
    scatter_state_rows(cfg, pools, caches, torch.where(active, rows, n))
    return next_tok, pools, new_lens


# ---------------------------------------------------------------------------
# Encoder-decoder (whisper) serving.  The prompt is the audio (frame ids);
# the encoder output's cross-K/V projection is sliced into immutable,
# shareable pool blocks, and each sequence owns one growing decoder
# self-K/V row block.  A repeated same-audio request adopts the cross
# blocks and the encoder does not run again.
# ---------------------------------------------------------------------------
#: Decoder start token of a served enc-dec request: the prompt is the
#: audio, so every decoder row begins at the same BOS.
ENCDEC_BOS = 0


def encdec_prefill(params: dict, frames: Tensor, bos_tokens: Tensor,
                   cfg: ModelConfig, *, max_len: int):
    """Encode the frames [B, S_enc, D] and prime fresh decoder caches of
    ``max_len`` with ``bos_tokens`` [B, T] (the cross leaves replaced by
    the encoder output's projection).  Returns (last_hidden [B, D],
    caches, length = T)."""
    enc_out = encdec.encode(params, frames, cfg)
    caches = init_cache(cfg, frames.shape[0], max_len, frames.device)
    hidden, caches = encdec.decode_hidden(params, bos_tokens, enc_out, cfg,
                                          caches=caches, cache_len=0)
    return hidden[:, -1], caches, bos_tokens.shape[1]


def encdec_decode_step(params: dict, caches: dict, cache_len: int,
                       tokens: Tensor, cfg: ModelConfig, *, noise=None,
                       generator=None, top_k: int = 5):
    """One lockstep enc-dec decode step: tokens [B, 1] at the shared
    length → (next_token [B], caches, cache_len + 1), sampled from the
    last position's logits (``transformer.logits_last``) with one Gumbel
    draw [B, k] (``noise``, or from ``generator``)."""
    hidden, caches = encdec.decode_hidden(params, tokens, None, cfg,
                                          caches=caches, cache_len=cache_len)
    logits = transformer.logits_last(params, hidden, cfg)
    next_tok, _ = topk_sample(logits, top_k, noise=noise, generator=generator)
    return next_tok, caches, cache_len + 1


def encdec_frames_from_ids(ids, cfg: ModelConfig, device="cuda") -> Tensor:
    """Deterministic stand-in audio features: frame id ``i`` is row ``i``
    of ``sinusoidal(vocab_size, d_model)`` (computed for the ids alone), so
    identical id sequences are identical audio.  Returns frames
    [1, S_enc, D] fp32 on ``device``."""
    ids = torch.as_tensor(ids, dtype=torch.int64).to(device)
    return encdec.sinusoidal_at(ids, cfg.d_model)[None]


def encdec_prefill_cached(params: dict, cross: dict, bos_tokens: Tensor,
                          cfg: ModelConfig, *, max_len: int):
    """Prime a decoder cache from an already computed cross-K/V
    projection ``{"cross_k", "cross_v": [L, B, S_enc, Hkv, D]}``, the path
    a whole-audio prefix hit takes, without the encoder.  Bit-identical to
    ``encdec_prefill`` of the same audio: the stored K/V are what the fresh
    encode produced, and the attention over given K/V is the same call
    either way.  Returns (last_hidden [B, D], caches, length)."""
    caches = cache_family.resolve(cfg).self_cache(
        bos_tokens.shape[0], max_len, bos_tokens.device)
    caches.update(cross)
    hidden, caches = encdec.decode_hidden(params, bos_tokens, None, cfg,
                                          caches=caches, cache_len=0)
    return hidden[:, -1], caches, bos_tokens.shape[1]


def encdec_decode_step_slots(params: dict, caches: dict, slot_lens: Tensor,
                             tokens: Tensor, cfg: ModelConfig, *,
                             noise: Tensor, top_k: int = 5,
                             temperature: float = 1.0):
    """One continuous-batching enc-dec decode step: tokens [B, 1],
    per-slot decoder lengths [B], Gumbel noise [B, k] → (next_token [B],
    caches, slot_lens + 1), the noise a row's own, as in
    ``decode_step_slots``."""
    hidden, caches = encdec.decode_hidden(params, tokens, None, cfg,
                                          caches=caches, cache_len=slot_lens)
    logits = logits_from_hidden(params, hidden[:, -1], cfg)
    next_tok = sample_per_slot(logits, top_k, noise, temperature)
    return next_tok, caches, slot_lens + 1


def _flat_cross(x: Tensor, bids: Tensor, b: int) -> Tensor:
    """Pool blocks ``bids`` ([b · nc], row-major) of a cross leaf
    [L, P, BS, Hkv, D] re-flattened to [L, b, nc · BS, Hkv, D] (a copy)."""
    g = x.index_select(1, bids.reshape(-1))
    return g.reshape((g.shape[0], b, -1) + tuple(g.shape[3:]))


def gather_encdec_rows(pools: dict, cross_tables: Tensor,
                       self_rows: Tensor) -> dict:
    """Contiguous decoder caches from the pool (copies): ``cross_tables``
    [B, S_enc // BS] gathers and re-flattens each row's encoder blocks,
    ``self_rows`` [B] picks each row's self-K/V row."""
    b = cross_tables.shape[0]
    out = {name: pools[name].index_select(1, self_rows)
           for name in encdec.SELF_LEAVES}
    out.update({name: _flat_cross(pools[name], cross_tables, b)
                for name in encdec.CROSS_LEAVES})
    return out


def gather_encdec_cross(pools: dict, cross_bids: Tensor) -> dict:
    """Shared encoder blocks ``cross_bids`` [nc] re-flattened into one
    batch-1 cross projection ``{"cross_k", "cross_v": [L, 1, S_enc, Hkv,
    D]}``, the operand ``encdec_prefill_cached`` takes on a hit."""
    return {name: _flat_cross(pools[name], cross_bids, 1)
            for name in encdec.CROSS_LEAVES}


def _kept(rows: Tensor, n: int) -> tuple[Tensor, Tensor]:
    """(positions of ``rows`` inside [0, n), those rows): a write routed
    out of range is dropped."""
    keep = ((rows >= 0) & (rows < n)).nonzero().squeeze(1)
    return keep, rows.index_select(0, keep)


def install_encdec_row(pools: dict, caches: dict, cross_bids: Tensor,
                       self_row: Tensor) -> dict:
    """Write a freshly prefilled batch-1 decoder cache into the pool, in
    place: the cross projection sliced into blocks ``cross_bids`` [nc] and
    the self row into block ``self_row`` [1].  Indices outside the pool
    are dropped: a prefix hit passes out-of-range cross ids, so the
    shared blocks (the same values) are not written again."""
    n = pools["self_k"].shape[1]
    nc = cross_bids.shape[0]
    keep, dst = _kept(self_row.reshape(1), n)
    for name in encdec.SELF_LEAVES:
        pools[name].index_copy_(1, dst, caches[name].index_select(1, keep)
                                .to(pools[name].dtype))
    keep, dst = _kept(cross_bids, n)
    for name in encdec.CROSS_LEAVES:
        v = caches[name]
        blocks = v.reshape((v.shape[0], nc, v.shape[2] // nc)
                           + tuple(v.shape[3:]))
        pools[name].index_copy_(1, dst, blocks.index_select(1, keep)
                                .to(pools[name].dtype))
    return pools


def decode_step_encdec_paged(params: dict, pools: dict,
                             cross_tables: Tensor, self_rows: Tensor,
                             active: Tensor, slot_lens: Tensor,
                             tokens: Tensor, cfg: ModelConfig, *,
                             noise: Tensor, top_k: int = 5,
                             temperature: float = 1.0):
    """One enc-dec decode step through the pool: gather the cross blocks
    and self rows into a slot batch, run the slot decode step, and write
    back only the self rows (cross blocks are immutable, maybe shared, and
    a decode step never changes them).  Inactive slots gather the sentinel
    row and their writes are dropped.  Returns (next_token [B], pools,
    slot_lens + 1)."""
    n = pools["self_k"].shape[1]
    caches = gather_encdec_rows(pools, cross_tables,
                                torch.where(active, self_rows, 0))
    next_tok, caches, new_lens = encdec_decode_step_slots(
        params, caches, slot_lens, tokens, cfg, noise=noise, top_k=top_k,
        temperature=temperature)
    keep, dst = _kept(torch.where(active, self_rows, n), n)
    for name in encdec.SELF_LEAVES:
        pools[name].index_copy_(1, dst, caches[name].index_select(1, keep))
    return next_tok, pools, new_lens
