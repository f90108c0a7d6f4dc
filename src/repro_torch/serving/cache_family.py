"""Cache families: what the serving stack assumes about a config's KV layout.

Port of ``src/repro/serving/cache_family.py`` for the ``dense`` family only
(``DenseFamily``, line 183): fp attention K/V as contiguous per-sequence
caches (the slot pool and the lockstep batch) or paged as blocks of
``block_size`` token positions, prefix-shareable with copy-on-write.  The
int8, fixed-state and enc-dec families come with later slices; ``resolve``
raises for them.  The pool-layout contract is the reference's: the physical
block axis sits at position 1 of every pool leaf ([L, P, Hkv, BS, D]).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


class CacheFamily:
    """Base protocol: layout construction + serving-policy bits."""

    #: Do identical prompt prefixes share physical blocks (with CoW)?
    shareable: bool = True
    #: Does the prompt occupy the decode cache?
    prompt_in_decoder: bool = True

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    def init_cache(self, batch: int, max_len: int, device) -> dict:
        raise NotImplementedError

    def init_paged_cache(self, num_blocks: int, block_size: int,
                         device) -> dict:
        raise NotImplementedError

    def max_blocks(self, slot_len: int, block_size: int) -> int:
        raise NotImplementedError

    def blocks_for_prompt(self, prompt_len: int, block_size: int) -> int:
        raise NotImplementedError

    def validate_geometry(self, slot_len: int, block_size: int) -> None:
        """Raise ValueError on a pool geometry this family cannot serve."""

    def validate_prompt(self, prompt_len: int, slot_len: int) -> None:
        """Raise ValueError on a prompt this family can never admit."""
        if self.prompt_in_decoder and prompt_len >= slot_len:
            raise ValueError(
                f"prompt of {prompt_len} cannot fit a slot of {slot_len} "
                "with room to decode")


class DenseFamily(CacheFamily):
    """Standard fp attention K/V of dense decoder blocks."""

    name = "dense"

    def _zeros(self, shape, device) -> dict:
        dt = transformer.DTYPES[self.cfg.dtype]
        return {"k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device)}

    def init_cache(self, batch: int, max_len: int, device) -> dict:
        """Zeroed contiguous caches {"k", "v": [L, B, S, Hkv, D]}: layer i's
        [B, S, Hkv, D] is the model layout the attention kernels read."""
        cfg = self.cfg
        return self._zeros((cfg.num_layers, batch, max_len, cfg.num_kv_heads,
                            cfg.resolved_head_dim), device)

    def init_paged_cache(self, num_blocks: int, block_size: int,
                         device) -> dict:
        """Zeroed pools {"k", "v": [L, P, Hkv, BS, D]}; ``num_blocks``
        counts the sentinel block 0."""
        cfg = self.cfg
        return self._zeros((cfg.num_layers, num_blocks, cfg.num_kv_heads,
                            block_size, cfg.resolved_head_dim), device)

    def max_blocks(self, slot_len: int, block_size: int) -> int:
        return slot_len // block_size

    def blocks_for_prompt(self, prompt_len: int, block_size: int) -> int:
        return -(-(prompt_len + 1) // block_size)

    def validate_geometry(self, slot_len: int, block_size: int) -> None:
        if slot_len % block_size:
            raise ValueError(
                f"slot_len {slot_len} must be a multiple of block_size "
                f"{block_size}")


@functools.lru_cache(maxsize=None)
def resolve(cfg: ModelConfig) -> CacheFamily:
    """The cache family serving this config (dense only in this slice)."""
    kinds = {k for k, _ in transformer.block_pattern(cfg)}
    if kinds != {"dense"} or cfg.kv_cache_dtype not in ("",):
        raise NotImplementedError(
            f"cache family for {cfg.name!r} (blocks {sorted(kinds)}, "
            f"kv_cache_dtype={cfg.kv_cache_dtype!r}) is not ported yet")
    return DenseFamily(cfg)
