"""Cache families: what the serving stack assumes about a config's KV layout.

Port of ``src/repro/serving/cache_family.py`` for the attention decoders
(dense and MoE blocks, whose caches are the same, and MLA blocks) and their
two families: ``DenseFamily`` (line 183), fp attention K/V as contiguous
per-sequence caches (the slot pool and the lockstep batch) or paged as blocks
of ``block_size`` token positions, prefix-shareable with copy-on-write; and
``DenseInt8Family`` (232), int8 K/V with a bf16 scale per (position, KV head)
beside them, prefilled in one shot and never shared.  An MLA config's
cache is its compressed latent under both families, fp in the model dtype
(the reference's ``_segment_caches`` ignores ``quantized`` for ``mla``, line
84): ``{"c_kv": [L, B, S, R], "k_rope": [L, B, S, Dr]}``, contiguous only
(``paged_serveable`` False, ``init_paged_cache`` raising the reference's
``ValueError``); the int8 family keeps its single-shot prefill and
``shareable = False`` there too.  ``FixedStateFamily`` (292) serves the
recurrent decoders (xLSTM, and zamba2's Mamba2 layers with their shared
attention block): one block is a sequence's whole state row, prefilled in
one shot and never shared.  ``EncDecFamily`` (354) serves whisper: a
sequence's blocks are its audio's immutable cross-K/V blocks, shared by
every request of the same whole audio, and one decoder self row.  The
pool-layout contract is the reference's: the physical block axis sits at
position 1 of every pool leaf ([L, P, Hkv, BS, D], scales [L, P, Hkv, BS],
a state pool's [L, P, ...], an enc-dec pool's [L, P, S | BS, Hkv, D]).
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import ssm, transformer, xlstm

#: Block kinds whose cache is a fixed-size recurrent state.
STATE_KINDS = frozenset({"mamba", "mlstm", "slstm"})


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
    #: May it serve through the paged pool?  When False,
    #: ``init_paged_cache`` raises with ``paged_unsupported_reason``.
    paged_serveable: bool = True
    paged_unsupported_reason: str = ""

    #: May it serve only through the paged pool?  (The enc-dec family's
    #: shared encoder blocks are the pool.)
    requires_paged: bool = False

    #: "token" (a block holds ``block_size`` positions), "state" (a block
    #: is one sequence's whole state row) or "encdec" (cross blocks of the
    #: encoder output and one decoder self row).
    kind: str = "token"

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    def _reject_paged(self) -> None:
        cfg = self.cfg
        raise ValueError(
            f"paged KV cache unsupported for arch {cfg.name!r}: "
            f"{self.paged_unsupported_reason} "
            f"(family={cfg.family!r}, kv_cache_dtype={cfg.kv_cache_dtype!r})")

    def init_cache(self, batch: int, max_len: int, device) -> dict:
        raise NotImplementedError

    def init_paged_cache(self, num_blocks: int, block_size: int, device,
                         slot_len=None) -> dict:
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
    """Standard fp attention K/V of dense (and MoE) decoder blocks, and
    MLA blocks' latent caches (contiguous only: paging them is a gap the
    reference shares, so ``paged_serveable`` follows the block kinds)."""

    name = "dense"

    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg)
        kinds = {k for k, _ in transformer.block_pattern(cfg)}
        self.latent = kinds == {"mla"}
        self.paged_serveable = kinds <= {"dense", "moe"}
        if not self.paged_serveable:
            self.paged_unsupported_reason = (
                "needs standard fp attention caches in every block")

    def _latent_cache(self, batch: int, max_len: int, device) -> dict:
        """Zeroed MLA latent caches {"c_kv": [L, B, S, R], "k_rope":
        [L, B, S, Dr]} in the model dtype, whatever the family."""
        cfg, m = self.cfg, self.cfg.mla
        dt = transformer.DTYPES[cfg.dtype]
        lead = (cfg.num_layers, batch, max_len)
        return {"c_kv": torch.zeros(lead + (m.kv_lora_rank,), dtype=dt,
                                    device=device),
                "k_rope": torch.zeros(lead + (m.qk_rope_head_dim,),
                                      dtype=dt, device=device)}

    def _zeros(self, shape, device) -> dict:
        dt = transformer.DTYPES[self.cfg.dtype]
        return {"k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device)}

    def init_cache(self, batch: int, max_len: int, device) -> dict:
        """Zeroed contiguous caches {"k", "v": [L, B, S, Hkv, D]}: layer i's
        [B, S, Hkv, D] is the model layout the attention kernels read; an
        MLA config's latent caches (``_latent_cache``)."""
        cfg = self.cfg
        if self.latent:
            return self._latent_cache(batch, max_len, device)
        return self._zeros((cfg.num_layers, batch, max_len, cfg.num_kv_heads,
                            cfg.resolved_head_dim), device)

    def init_paged_cache(self, num_blocks: int, block_size: int, device,
                         slot_len=None) -> dict:
        """Zeroed pools {"k", "v": [L, P, Hkv, BS, D]}; ``num_blocks``
        counts the sentinel block 0 (``slot_len`` is not needed).  Raises
        for a config that is not ``paged_serveable``."""
        if not self.paged_serveable:
            self._reject_paged()
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
    write-time values, so the family stays out of the prefix index.  An MLA config keeps fp latent
    caches under this family (``DenseFamily._latent_cache``), with its
    single-shot prefill and no sharing, as the reference's does."""

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


class FixedStateFamily(CacheFamily):
    """The recurrent state of SSM, xLSTM and hybrid stacks (zamba2,
    xlstm-125m).

    A fixed-size state is a one-block "page": one physical block is a
    sequence's whole cache row, the state of every recurrent layer plus,
    for a hybrid, the shared block's K/V over ``slot_len`` positions.
    ``block_size`` plays no part and a table is one column wide.  The
    state changes in place every step, so blocks are never shared, and the
    prefill is single shot (the chunked scan starts from zeros and carries
    no prefix state).

    Caches are flat, each leaf with its layer axis 0 and batch (or pool
    block) axis 1: ``{"ssm": [L_m, B, H, N, P] fp32, "conv_x": [L_m, B,
    w − 1, inner], "conv_b", "conv_c": [L_m, B, w − 1, N], "k", "v":
    [calls, B, S, Hkv, D]}`` for zamba2 (L_m mamba layers, one K/V entry
    per shared-block call), ``{"m": [L_ml, B, H], "C": [L_ml, B, H, Dh,
    Dh], "n": [L_ml, B, H, Dh], "conv": [L_ml, B, w − 1, inner], "s_c",
    "s_n", "s_m", "s_h": [L_sl, B, D]}`` for xLSTM; ``transformer.
    layer_plan`` maps layer i to its index among its kind.  A pool is the
    same layout with the block axis in place of the batch, so the slot
    code, the swap and the block copies need no branch of their own."""

    name = "fixed_state"
    kind = "state"
    single_shot_prefill = True
    shareable = False

    def init_cache(self, batch: int, max_len: int, device) -> dict:
        """Every layer's initial state (``ssm.mamba2_cache_init``,
        ``xlstm.xlstm_cache_init``: the mLSTM's m at −inf, the sLSTM's n at
        1), stacked over the layers of its kind, and zeroed K/V of
        ``max_len`` for every shared-block call."""
        cfg = self.cfg
        dt = transformer.DTYPES[cfg.dtype]
        counts = transformer.layer_counts(cfg)
        out: dict = {}
        if counts.get("attn"):
            shape = (counts["attn"], batch, max_len, cfg.num_kv_heads,
                     cfg.resolved_head_dim)
            out["k"] = torch.zeros(shape, dtype=dt, device=device)
            out["v"] = torch.zeros(shape, dtype=dt, device=device)
        if counts.get("mamba"):
            one = ssm.mamba2_cache_init(cfg, batch, dt, device)
            out.update(_stacked(one, counts["mamba"]))
        for kind in ("mlstm", "slstm"):
            if counts.get(kind):
                first = next(i for k, i, _ in transformer.layer_plan(cfg)
                             if k == kind)
                one = xlstm.xlstm_cache_init(cfg, first, batch, dt, device)
                out.update(_stacked(one, counts[kind]))
        return out

    def init_paged_cache(self, num_blocks: int, block_size: int, device,
                         slot_len=None) -> dict:
        """The contiguous layout with the pool's ``num_blocks`` rows
        (sentinel 0 included) in place of the batch: one row a sequence,
        its shared-block K/V sized by ``slot_len``."""
        if slot_len is None:
            raise TypeError("fixed-state pools need slot_len: one block "
                            "holds a whole state row sized by it")
        return self.init_cache(num_blocks, slot_len, device)

    def max_blocks(self, slot_len: int, block_size: int) -> int:
        return 1

    def blocks_for_prompt(self, prompt_len: int, block_size: int) -> int:
        return 1

    def prompt_quantum(self) -> int:
        """The single-shot prefill runs the chunked scan once over the
        whole prompt, whose length must divide into the scan's chunk: a
        prompt is at most this quantum or a multiple of it (the lcm of the
        SSM's and the xLSTM's chunks)."""
        q = 1
        for sub in (self.cfg.ssm, self.cfg.xlstm):
            if sub is not None:
                q = q * sub.chunk // math.gcd(q, sub.chunk)
        return q

    def validate_prompt(self, prompt_len: int, slot_len: int) -> None:
        super().validate_prompt(prompt_len, slot_len)
        q = self.prompt_quantum()
        if prompt_len > q and prompt_len % q:
            raise ValueError(
                f"fixed-state prefill is single-shot through the chunked "
                f"scan: prompt of {prompt_len} must be ≤ {q} or a multiple "
                f"of {q}")


class EncDecFamily(CacheFamily):
    """Encoder-decoder (whisper): immutable encoder cross-K/V plus a
    decoder self-K/V row.

    The prompt is the audio (frame ids); the encoder is bidirectional, so
    its output, and so the cross-attention's K/V, depends on every frame:
    only a whole-audio exact match may share blocks, and whisper's fixed
    padded window (``cfg.encoder_seq_len``) makes every prompt that exact
    length.  A sequence's table row is ``S_enc // block_size`` immutable
    cross blocks (shareable, refcounted, parked in the prefix cache like
    dense prefixes) and one self-K/V row block that grows with the decoded
    tokens.  Every leaf has its layer axis 0 and batch (or pool block)
    axis 1: contiguous caches ``{"self_k", "self_v": [L, B, S, Hkv, D],
    "cross_k", "cross_v": [L, B, S_enc, Hkv, D]}``, pools the same with
    ``num_blocks`` rows, each carrying a ``slot_len`` self row and
    ``block_size`` cross positions (the reference's layout)."""

    name = "encdec"
    kind = "encdec"
    single_shot_prefill = True
    prompt_in_decoder = False
    requires_paged = True

    def _zeros(self, rows: int, self_len: int, cross_len: int,
               device) -> dict:
        cfg = self.cfg
        dt = transformer.DTYPES[cfg.dtype]
        tail = (cfg.num_kv_heads, cfg.resolved_head_dim)
        out = {}
        for names, n in ((("self_k", "self_v"), self_len),
                         (("cross_k", "cross_v"), cross_len)):
            for name in names:
                out[name] = torch.zeros((cfg.num_layers, rows, n) + tail,
                                        dtype=dt, device=device)
        return out

    def init_cache(self, batch: int, max_len: int, device) -> dict:
        return self._zeros(batch, max_len, self.cfg.encoder_seq_len, device)

    def self_cache(self, batch: int, max_len: int, device) -> dict:
        """The self-attention leaves of ``init_cache`` alone, for a prefill
        whose cross leaves come from the pool."""
        return {name: x for name, x in self._zeros(batch, max_len, 0,
                                                   device).items()
                if name.startswith("self_")}

    def init_paged_cache(self, num_blocks: int, block_size: int, device,
                         slot_len=None) -> dict:
        if slot_len is None:
            raise TypeError(
                "enc-dec pools need slot_len: each block carries a decoder "
                "self-K/V row sized by it")
        self.validate_geometry(slot_len, block_size)
        return self._zeros(num_blocks, slot_len, block_size, device)

    def cross_blocks(self, block_size: int) -> int:
        return self.cfg.encoder_seq_len // block_size

    def max_blocks(self, slot_len: int, block_size: int) -> int:
        return self.cross_blocks(block_size) + 1

    def blocks_for_prompt(self, prompt_len: int, block_size: int) -> int:
        return self.cross_blocks(block_size) + 1

    def validate_geometry(self, slot_len: int, block_size: int) -> None:
        if self.cfg.encoder_seq_len % block_size:
            raise ValueError(
                f"encoder_seq_len {self.cfg.encoder_seq_len} must be a "
                f"multiple of block_size {block_size} to page the encoder "
                "output")

    def validate_prompt(self, prompt_len: int, slot_len: int) -> None:
        if prompt_len != self.cfg.encoder_seq_len:
            raise ValueError(
                f"enc-dec prompts are audio frame ids padded to the encoder "
                f"window: expected exactly {self.cfg.encoder_seq_len} "
                f"frames, got {prompt_len}")


def _stacked(one: dict, count: int) -> dict:
    """One layer's state leaves [B, ...] repeated over ``count`` layers:
    [count, B, ...]."""
    return {name: x.unsqueeze(0).repeat((count,) + (1,) * x.dim())
            for name, x in one.items()}


@functools.lru_cache(maxsize=None)
def resolve(cfg: ModelConfig) -> CacheFamily:
    """The cache family serving this config: the fixed-state family for a
    stack with recurrent blocks, before the KV dtype is looked at (as the
    reference's ``cache_family.py:429-439``); else int8 K/V for
    ``kv_cache_dtype == "int8"``, else fp K/V (any other value keeps the
    model dtype, as in the reference).  Dense and MoE blocks hold the same
    attention K/V, so both kinds, alone or mixed, take these families, as
    in the reference (``cache_family.py:79,199``); so do MLA blocks, with
    their latent caches (``DenseFamily``).  An encoder-decoder config
    takes ``EncDecFamily`` before anything else, as in the reference."""
    if cfg.family == "encdec":
        return EncDecFamily(cfg)
    kinds = {k for k, _ in transformer.block_pattern(cfg)}
    if kinds & STATE_KINDS:
        return FixedStateFamily(cfg)
    if not (kinds <= {"dense", "moe"} or kinds == {"mla"}):
        raise NotImplementedError(
            f"cache family for {cfg.name!r} (blocks {sorted(kinds)}) is not "
            "ported yet")
    if cfg.kv_cache_dtype == "int8":
        return DenseInt8Family(cfg)
    return DenseFamily(cfg)
