"""Serving primitives: cache init, prefill, decode steps, logits and
sampling, for three serving shapes over one dense model.

* **Lockstep batch** (``prefill`` + ``decode_step``): one scalar cache
  length shared by every row, the drain-and-refill baseline.
* **Slot pool** (``chunked_prefill`` / ``prefill_chunk`` / ``write_slot`` /
  ``decode_step_slots``): contiguous per-slot caches with a [B] length
  vector; a finished slot is overwritten by the next request's prefilled
  cache.
* **Paged pool** (``init_paged_cache`` / ``copy_paged_block`` /
  ``prefill_chunk_paged`` / ``decode_step_paged``): a shared block pool read
  through block tables.

Port of ``src/repro/serving/engine.py`` for the dense family:
``init_cache`` (line 49), ``prefill`` (55), ``logits_from_hidden`` (69),
``decode_step`` (80), ``prefill_schedule`` (111), ``chunked_prefill`` (135),
``prefill_chunk`` (165), ``write_slot`` (182), ``sample_per_slot`` (199),
``decode_step_slots`` (218), ``init_paged_cache`` (251),
``copy_paged_block`` (265), ``prefill_chunk_paged`` (291) and
``decode_step_paged`` (305).  Caches and pools are updated in place (the JAX
code returned new ones); functions still return them so the call sites read
like the reference's.

Sampling takes its Gumbel noise as an argument: the scheduler draws it from
one ``torch.Generator`` per request (or a test's ``noise_fn``), so a row's
token depends only on its own logits and noise — what makes batched decode
reproduce solo decode token for token.
"""
from __future__ import annotations

from typing import Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.topk_fusion import gumbel_pick, topk_sample
from repro_torch.kernels import dispatch
from repro_torch.models import transformer
from repro_torch.serving import cache_family

Tensor = torch.Tensor


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device="cuda") -> dict:
    """Zeroed contiguous caches {"k", "v": [L, B, S, Hkv, D]}, the layout
    the config's cache family owns."""
    return cache_family.resolve(cfg).init_cache(batch, max_len, device)


def prefill(params: dict, tokens: Tensor, cfg: ModelConfig, *,
            max_len: int):
    """Run the prompts tokens [B, T] through the model into fresh caches of
    ``max_len`` on the tokens' device.  Returns (last_hidden [B, D], caches,
    cache_len = T)."""
    caches = init_cache(cfg, tokens.shape[0], max_len, tokens.device)
    hidden, caches = transformer.forward(params, tokens, cfg, caches=caches,
                                         cache_len=0)
    return hidden[:, -1], caches, tokens.shape[1]


def decode_step(params: dict, caches: dict, cache_len: int, tokens: Tensor,
                cfg: ModelConfig, *, noise=None, generator=None,
                top_k: int = 5):
    """One lockstep decode step: tokens [B, 1] at the shared length
    ``cache_len`` → (next_token [B], caches, cache_len + 1).  The vocabulary
    pass is the fused softmax+top-k (``core.topk_sample``), with one Gumbel
    draw [B, k] for the batch: ``noise``, or from ``generator``."""
    hidden, caches = transformer.forward(params, tokens, cfg, caches=caches,
                                         cache_len=cache_len)
    logits = logits_from_hidden(params, hidden[:, -1], cfg)
    next_tok, _ = topk_sample(logits, top_k, noise=noise, generator=generator)
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


def sample_per_slot(logits: Tensor, top_k: int, noise: Tensor) -> Tensor:
    """Fused softmax+top-k (paper Alg. 4, through ``dispatch``) then a
    Gumbel-max pick with per-row noise ``noise`` [B, k]."""
    out = dispatch.softmax_topk(logits, top_k)
    return gumbel_pick(out, noise)


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     device="cuda") -> dict:
    """Zeroed block pools {"k", "v": [L, P, Hkv, BS, D]} — kernel-native
    page layout, no batch axis; ``num_blocks`` includes the sentinel 0."""
    return cache_family.resolve(cfg).init_paged_cache(num_blocks, block_size,
                                                      device)


def copy_paged_block(pools: dict, src: int, dst: int) -> dict:
    """Copy physical block ``src`` over ``dst`` in every layer's pool, in
    place — the copy-on-write primitive behind prefix-sharing divergence."""
    for pool in pools.values():
        pool[:, dst] = pool[:, src]
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
                      top_k: int = 5):
    """One decode step over the whole slot pool: tokens [B, 1], per-slot
    lengths [B], Gumbel noise [B, k] → (next_token [B], caches,
    slot_lens + 1).  Every slot advances one position at its own offset;
    the per-row valid lengths mask the ragged caches."""
    hidden, caches = transformer.forward(params, tokens, cfg, caches=caches,
                                         cache_len=slot_lens)
    logits = logits_from_hidden(params, hidden[:, -1], cfg)
    next_tok = sample_per_slot(logits, top_k, noise)
    return next_tok, caches, slot_lens + 1


def decode_step_paged(params: dict, pools: dict, block_tables: Tensor,
                      slot_lens: Tensor, tokens: Tensor, cfg: ModelConfig, *,
                      noise: Tensor, top_k: int = 5):
    """One decode step over the paged pool: tokens [B, 1], block_tables
    [B, M], per-slot lengths [B], Gumbel noise [B, k] → (next_token [B],
    pools, slot_lens + 1)."""
    hidden, pools = transformer.forward(params, tokens, cfg, caches=pools,
                                        cache_len=slot_lens,
                                        block_tables=block_tables)
    logits = logits_from_hidden(params, hidden[:, -1], cfg)
    next_tok = sample_per_slot(logits, top_k, noise)
    return next_tok, pools, slot_lens + 1
