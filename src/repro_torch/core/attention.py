"""Online-softmax attention (the paper's ⊕ recurrence applied to attention).

Port of ``src/repro/core/attention.py``: ``naive_attention`` (line 30) is the
materializing oracle, ``online_attention`` (line 80) streams KV in chunks over
``_chunked_fwd_impl`` (line 136), carrying ``(m, d, acc)`` — Algorithm 3 with
a weighted-value accumulator.  It is the plain version behind the attention
kernels, int8 caches included: ``k_scale``/``v_scale`` [B, Tk, Hkv]
dequantize each chunk after its slice (``int8 * scale`` in fp32), as the
reference does.  The reference's causal chunk skipping and custom VJP are
left out.

Layouts: q [B, Tq, Hq, D]; k, v [B, Tk, Hkv, D]; Hq % Hkv == 0 (GQA/MQA).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

Tensor = torch.Tensor
NEG_INF = float("-inf")
DEFAULT_CHUNK = 1024


def _as_index(x: Union[int, Tensor], device) -> Tensor:
    return torch.as_tensor(x, dtype=torch.int64, device=device)


def _q_positions(tq: int, q_offset: Tensor) -> Tensor:
    """Query positions: [Tq] for a scalar offset, [B, Tq] for per-row ones."""
    return q_offset[..., None] + torch.arange(tq, device=q_offset.device)


def _chunk_mask(q_pos: Tensor, k_pos: Tensor, kv_valid_len: Tensor,
                causal: bool) -> Tensor:
    """[B, Tq, C] mask (True = attend) for one KV chunk."""
    m = k_pos[None, None, :] < kv_valid_len[:, None, None]
    if causal:
        qp = q_pos[None, :, None] if q_pos.ndim == 1 else q_pos[:, :, None]
        m = m & (k_pos[None, None, :] <= qp)
    return m


def naive_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = False,
                    q_offset: Union[int, Tensor] = 0,
                    kv_valid_len: Optional[Tensor] = None,
                    scale: Optional[float] = None) -> Tensor:
    """Reference attention that materializes the full score matrix."""
    b, tq, hq, dh = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else dh ** -0.5
    qf = q.float().reshape(b, tq, hkv, g, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * scale
    vlen = (_as_index(tk, q.device).expand(b) if kv_valid_len is None
            else _as_index(kv_valid_len, q.device).expand(b))
    mask = _chunk_mask(_q_positions(tq, _as_index(q_offset, q.device)),
                       torch.arange(tk, device=q.device), vlen, causal)
    s = s.masked_fill(~mask[:, None, None], NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(torch.isneginf(s), torch.zeros_like(s), torch.exp(s - m))
    d = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p / d.clamp(min=1e-30), v.float())
    return o.reshape(b, tq, hq, v.shape[-1]).to(q.dtype)


def online_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = False,
                     q_offset: Union[int, Tensor] = 0,
                     kv_valid_len: Optional[Union[int, Tensor]] = None,
                     chunk_size: int = DEFAULT_CHUNK,
                     scale: Optional[float] = None,
                     k_scale: Optional[Tensor] = None,
                     v_scale: Optional[Tensor] = None) -> Tensor:
    """Chunked online attention; returns out [B, Tq, Hq, Dv] in q's dtype.
    ``k_scale``/``v_scale`` [B, Tk, Hkv] set: k, v are int8, dequantized
    per chunk."""
    out, _ = online_attention_lse(q, k, v, causal=causal, q_offset=q_offset,
                                  kv_valid_len=kv_valid_len,
                                  chunk_size=chunk_size, scale=scale,
                                  k_scale=k_scale, v_scale=v_scale)
    return out


def online_attention_lse(q: Tensor, k: Tensor, v: Tensor, *,
                         causal: bool = False,
                         q_offset: Union[int, Tensor] = 0,
                         kv_valid_len: Optional[Union[int, Tensor]] = None,
                         chunk_size: int = DEFAULT_CHUNK,
                         scale: Optional[float] = None,
                         k_scale: Optional[Tensor] = None,
                         v_scale: Optional[Tensor] = None):
    """``online_attention`` that also returns lse [B, Hq, Tq] (float32,
    −inf for a row with no valid key) — the paged prefill kernel's outputs."""
    b, tq, hq, dh = q.shape
    scale = scale if scale is not None else dh ** -0.5
    vlen = (torch.full((b,), k.shape[1], dtype=torch.int64, device=q.device)
            if kv_valid_len is None
            else _as_index(kv_valid_len, q.device).expand(b))
    out, lse = _chunked_fwd_impl(q, k, v, _as_index(q_offset, q.device), vlen,
                                 causal, min(chunk_size, k.shape[1]), scale,
                                 k_scale=k_scale, v_scale=v_scale)
    return out, lse.reshape(b, hq, tq)


def _chunked_fwd_impl(q, k, v, q_offset, kv_valid_len, causal, chunk_size,
                      scale, k_scale=None, v_scale=None):
    """k_scale / v_scale [B, Tk, Hkv]: dequantization scales of int8 k, v,
    padded with the keys and applied to each chunk after its slice."""
    b, tq, hq, dh = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = hq // hkv
    n_chunks, rem = divmod(tk, chunk_size)
    if rem:  # pad KV; padded keys are masked out via kv_valid_len clamping
        pad = chunk_size - rem
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        if k_scale is not None:
            k_scale = torch.nn.functional.pad(k_scale, (0, 0, 0, pad))
            v_scale = torch.nn.functional.pad(v_scale, (0, 0, 0, pad))
        n_chunks += 1
    kv_valid_len = kv_valid_len.clamp(max=tk)
    # fp32 accumulation (fp64 for fp64 inputs, which gradient checks use)
    f = dict(dtype=torch.promote_types(q.dtype, torch.float32),
             device=q.device)
    qf = (q.to(f["dtype"]) * scale).reshape(b, tq, hkv, g, dh)
    q_pos = _q_positions(tq, q_offset)
    m_run = torch.full((b, hkv, g, tq), NEG_INF, **f)
    d_run = torch.zeros((b, hkv, g, tq), **f)
    acc = torch.zeros((b, hkv, g, tq, dv), **f)
    for idx in range(n_chunks):
        lo = idx * chunk_size
        kc = k[:, lo:lo + chunk_size].to(f["dtype"])
        vc = v[:, lo:lo + chunk_size].to(f["dtype"])
        if k_scale is not None:
            kc = kc * k_scale[:, lo:lo + chunk_size].to(f["dtype"])[..., None]
            vc = vc * v_scale[:, lo:lo + chunk_size].to(f["dtype"])[..., None]
        k_pos = lo + torch.arange(chunk_size, device=q.device)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kc)
        mask = _chunk_mask(q_pos, k_pos, kv_valid_len, causal)
        s = s.masked_fill(~mask[:, None, None], NEG_INF)
        # --- Algorithm 3 lines 4-5, chunk-granular -------------------------
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        alpha = torch.exp(torch.where(m_run == m_new,
                                      torch.zeros_like(m_run), m_run - m_new))
        p = torch.where(torch.isneginf(s), torch.zeros_like(s),
                        torch.exp(s - m_new[..., None]))
        d_run = d_run * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, vc)
        m_run = m_new
    out = acc / d_run.clamp(min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, tq, hq, dv).to(q.dtype)
    lse = torch.where(d_run > 0, m_run + torch.log(d_run.clamp(min=1e-30)),
                      torch.full_like(d_run, NEG_INF))
    return out, lse  # lse: [B, Hkv, G, Tq]
