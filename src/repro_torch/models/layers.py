"""Dense model layers of the port: norms, rotary embedding, GQA attention over
a paged KV pool or a contiguous KV cache, the SwiGLU MLP, embedding and LM
head.

Port of the dense parts of ``src/repro/models/layers.py``: ``rms_norm`` (line
90), ``rope`` (109), ``cache_write`` (146), ``paged_cache_write`` (163),
``_quantize_kv`` (203), the paged and the contiguous branches of
``attention_apply``, fp and int8 (277-353), ``mlp_apply`` (459),
``embed_tokens`` (555) and ``head_matrix`` (559).  Parameters are plain
dicts of tensors.  The MLA and MoE branches come with later slices.
"""
from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import dispatch

Tensor = torch.Tensor


def rms_norm(scale: Tensor, x: Tensor, eps: float) -> Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """Rotary embedding. x [..., T, H, D_rot]; positions [..., T] or [T]."""
    d = x.shape[-1]
    freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                    device=x.device) / d)
    angles = positions[..., :, None].float() * freqs            # [.., T, D/2]
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def cache_write(cache: Tensor, new: Tensor,
                cache_len: Union[int, Tensor]) -> Tensor:
    """Write ``new`` [B, t, ...] into ``cache`` [B, S, ...] at offset
    ``cache_len`` along the sequence axis, in place, and return the cache.

    A scalar ``cache_len`` is the lockstep batch (one shared offset: a
    ``copy_`` into the slice); a [B] vector writes each row at its own offset
    (the slot pool: one ``index_put_``).  The JAX code returned a new array
    (``dynamic_update_slice``, which clamps a start that would overrun S);
    here every position written must lie inside S."""
    b, t = new.shape[:2]
    new = new.to(cache.dtype)
    if not torch.is_tensor(cache_len) or cache_len.dim() == 0:
        cache.narrow(1, int(cache_len), t).copy_(new)
        return cache
    pos = cache_len.to(cache.device, torch.int64)[:, None] + torch.arange(
        t, device=cache.device)                                      # [B, t]
    rows = torch.arange(b, device=cache.device)[:, None].expand(b, t)
    cache.index_put_((rows, pos), new)
    return cache


def paged_cache_write(pool: Tensor, new: Tensor, cache_len: Union[int, Tensor],
                      block_tables: Tensor) -> Tensor:
    """Write ``new`` [B, t, Hkv, D] into the block pool [P, Hkv, BS, D]
    through the block table [B, M], in place, and return the pool.

    Row b's position ``cache_len[b] + i`` lands in physical block
    ``block_tables[b, pos // BS]`` at offset ``pos % BS``.  The JAX code
    rebuilt the pool functionally (``pool.at[...].set``); here one
    ``index_put_`` scatters into it.  Distinct rows never write the same
    (block, offset), except idle rows, which all land in the sentinel
    block 0 that the allocator never hands out."""
    b, t = new.shape[:2]
    bs = pool.shape[2]
    ln = torch.as_tensor(cache_len, dtype=torch.int64,
                         device=pool.device).expand(b)
    pos = ln[:, None] + torch.arange(t, device=pool.device)          # [B, t]
    bids = torch.gather(block_tables.to(pool.device, torch.int64), 1,
                        pos // bs).reshape(-1)
    offs = (pos % bs).reshape(-1)
    heads = torch.arange(pool.shape[1], device=pool.device)
    flat = new.to(pool.dtype).reshape((b * t,) + tuple(new.shape[2:]))
    pool.index_put_((bids[:, None], heads[None, :], offs[:, None]), flat)
    return pool


def _quantize_kv(x: Tensor) -> tuple[Tensor, Tensor]:
    """Per-(position, head) int8 quantization: x [B, T, H, D] → (int8
    [B, T, H, D], bf16 scale [B, T, H]).  The reference's arithmetic: the
    scale is max|x| / 127 (at least 1e-8) in fp32, the values round half to
    even (``torch.round``, like ``jnp.round``) and clip to ±127, and the
    stored scale rounds to bf16."""
    xf = x.float()
    scale = (xf.abs().amax(dim=-1) / 127.0).clamp(min=1e-8)
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def attention_apply(p: dict, x: Tensor, cfg: ModelConfig, *,
                    positions: Tensor, cache: Optional[dict] = None,
                    cache_len: Optional[Union[int, Tensor]] = None,
                    block_tables: Optional[Tensor] = None):
    """x [B, T, D] → (out [B, T, D], cache).

    * ``cache=None``: causal self-attention over this call's K/V, the
      training form (differentiable; see ``dispatch.sdpa``).
    * paged serving: ``cache`` holds this layer's block pools
      ``{"k", "v": [P, Hkv, BS, D]}`` shared by every sequence; this step's
      K/V are written through ``block_tables`` at ``cache_len`` (in place)
      and attention reads the pages through the same table.
    * contiguous caches (the slot pool, the lockstep batch): ``cache``
      holds ``{"k", "v": [B, S, Hkv, D]}``; this step's K/V are written at
      ``cache_len`` (a scalar or per-row [B]) in place, and attention reads
      each row's valid prefix.

    Either way a one-token step (decode, or a one-token prefill tail) takes
    the decode kernel, and a wider one the cached-prefill kernel, with the
    queries at absolute offset ``cache_len`` and ``cache_len + t`` valid
    positions per row.

    The cache layout, not a config string, selects the int8 form: a cache
    with ``"k_scale"`` holds int8 K/V (pools or caches) and bf16 scales
    beside them ([P, Hkv, BS] pages or [B, S, Hkv]).  Every step writes the
    quantized K/V and their scales; a prefill (t > 1, single shot) attends
    over this call's exact K/V through the cached-prefill kernel, and a
    decode step over the int8 cache through the dequantizing decode kernel.
    """
    b, t, _ = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = (x @ p["wq"]).reshape(b, t, hq, hd)
    k = (x @ p["wk"]).reshape(b, t, hkv, hd)
    v = (x @ p["wv"]).reshape(b, t, hkv, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if cache is not None and "k_scale" in cache:
        k8, ks = _quantize_kv(k)
        v8, vs = _quantize_kv(v)
        for name, new in (("k", k8), ("v", v8), ("k_scale", ks),
                          ("v_scale", vs)):
            if block_tables is not None:
                paged_cache_write(cache[name], new, cache_len, block_tables)
            else:
                cache_write(cache[name], new, cache_len)
        valid = torch.as_tensor(cache_len, dtype=torch.int32,
                                device=x.device).expand(b) + t
        if t > 1:
            out = dispatch.sdpa(cfg, q, k, v, causal=True, q_offset=cache_len,
                                kv_valid_len=valid)
        else:
            out = dispatch.sdpa(cfg, q, cache["k"], cache["v"], causal=False,
                                q_offset=cache_len, kv_valid_len=valid,
                                decode=True, k_scale=cache["k_scale"],
                                v_scale=cache["v_scale"],
                                block_tables=block_tables)
    elif cache is not None:
        if block_tables is not None:
            k_all = paged_cache_write(cache["k"], k, cache_len, block_tables)
            v_all = paged_cache_write(cache["v"], v, cache_len, block_tables)
        else:
            k_all = cache_write(cache["k"], k, cache_len)
            v_all = cache_write(cache["v"], v, cache_len)
        valid = torch.as_tensor(cache_len, dtype=torch.int32,
                                device=x.device).expand(b) + t
        out = dispatch.sdpa(cfg, q, k_all, v_all, causal=t > 1,
                            q_offset=cache_len, kv_valid_len=valid,
                            decode=(t == 1), block_tables=block_tables)
    else:
        out = dispatch.sdpa(cfg, q, k, v, causal=True, q_offset=0,
                            kv_valid_len=None)
    out = out.reshape(b, t, hq * hd) @ p["wo"]
    return out, cache


def mlp_apply(p: dict, x: Tensor, cfg: ModelConfig) -> Tensor:
    up = x @ p["w_up"]
    if cfg.act == "silu":
        h = F.silu(x @ p["w_gate"]) * up
    else:
        h = F.gelu(up, approximate="tanh")     # jax.nn.gelu's default
    return h @ p["w_down"]


def embed_tokens(p: dict, tokens: Tensor) -> Tensor:
    return p["embed"][tokens]


def head_matrix(p: dict, cfg: ModelConfig) -> Tensor:
    return p["embed"].T if cfg.tie_embeddings else p["head"]
