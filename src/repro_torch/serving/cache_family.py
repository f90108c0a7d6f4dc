"""Cache families: what the serving stack assumes about a config's KV layout.

Port of ``src/repro/serving/cache_family.py`` for the attention-K/V
decoders (dense and MoE blocks, whose caches are the same) and their two
families: ``DenseFamily`` (line 183), fp attention K/V as contiguous
per-sequence caches (the slot pool and the lockstep batch) or paged as blocks
of ``block_size`` token positions, prefix-shareable with copy-on-write; and
``DenseInt8Family`` (232), int8 K/V with a bf16 scale per (position, KV head)
beside them, prefilled in one shot and never shared.  The fixed-state and
enc-dec families come with later slices; ``resolve`` raises for them.  The
pool-layout contract is the reference's: the physical block axis sits at
position 1 of every pool leaf ([L, P, Hkv, BS, D], scales [L, P, Hkv, BS]).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


class CacheFamily:
    """Base protocol: layout construction + serving-policy bits."""

    #: Are K/V stored quantized, with scales beside them?
    quantized: bool = False
    #: Must a prompt prefill in one chunk?  A quantized prefill attends over
    #: the current chunk's exact K/V only, so a chunk schedule would drop
    #: the prefix.
    single_shot_prefill: bool = False
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
    """Standard fp attention K/V of dense (and MoE) decoder blocks."""

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


class DenseInt8Family(DenseFamily):
    """Quantized attention K/V: int8 payload plus a bf16 scale per
    (position, KV head).  Contiguous caches are {"k", "v": int8
    [L, B, S, Hkv, D], "k_scale", "v_scale": bf16 [L, B, S, Hkv]}; pools
    add scale pages [L, P, Hkv, BS] beside the int8 pools, read through the
    same block table.  Prefill is single shot (it attends over the prompt's
    exact K/V), and blocks are never prefix-shared: scales are per-sequence
    write-time values, so the family stays out of the prefix index."""

    name = "dense_int8"
    quantized = True
    single_shot_prefill = True
    shareable = False

    def _zeros(self, shape, device) -> dict:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:-1], dtype=torch.bfloat16,
                                       device=device),
                "v_scale": torch.zeros(shape[:-1], dtype=torch.bfloat16,
                                       device=device)}

    def dequantize_block(self, block: dict) -> dict:
        """fp32 K/V from int8 leaves [..., BS, D] and their scales
        [..., BS]: ``x.float() * scale.float()``, the arithmetic the kernels
        apply to each tile after the read."""
        return {name: block[name].float()
                * block[f"{name}_scale"].float()[..., None]
                for name in ("k", "v")}


@functools.lru_cache(maxsize=None)
def resolve(cfg: ModelConfig) -> CacheFamily:
    """The cache family serving this config: int8 K/V for
    ``kv_cache_dtype == "int8"``, else fp K/V (any other value keeps the
    model dtype, as in the reference).  Dense and MoE blocks hold the same
    attention K/V, so both kinds, alone or mixed, take these families, as
    in the reference (``cache_family.py:79,199``)."""
    kinds = {k for k, _ in transformer.block_pattern(cfg)}
    if not kinds <= {"dense", "moe"}:
        raise NotImplementedError(
            f"cache family for {cfg.name!r} (blocks {sorted(kinds)}) is not "
            "ported yet")
    if cfg.kv_cache_dtype == "int8":
        return DenseInt8Family(cfg)
    return DenseFamily(cfg)
