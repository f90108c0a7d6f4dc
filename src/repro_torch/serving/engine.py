"""Serving primitives over the paged KV pool: pool init, block copy, prefill
chunk, decode step, logits and per-row sampling.

Port of the paged parts of ``src/repro/serving/engine.py``:
``logits_from_hidden`` (line 69), ``prefill_schedule`` (111),
``sample_per_slot`` (199), ``init_paged_cache`` (251), ``copy_paged_block``
(265), ``prefill_chunk_paged`` (291) and ``decode_step_paged`` (305).  The
pools are updated in place (the JAX code returned new pools); functions
still return them so the call sites read like the reference's.

Sampling takes its Gumbel noise as an argument: the scheduler draws it from
one ``torch.Generator`` per request (or a test's ``noise_fn``), so a row's
token depends only on its own logits and noise — what makes batched decode
reproduce solo decode token for token.
"""
from __future__ import annotations

from typing import Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.topk_fusion import gumbel_pick
from repro_torch.kernels import dispatch
from repro_torch.models import transformer
from repro_torch.serving import cache_family

Tensor = torch.Tensor


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
