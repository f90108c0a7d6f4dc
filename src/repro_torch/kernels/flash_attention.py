"""Flash attention forward: the CUDA kernels' wrappers and their plain
PyTorch versions — fresh (the training form) and cached prefill over a paged
KV pool or a contiguous KV cache.

* ``flash_attention_fwd`` replaces
  ``src/repro/kernels/flash_attention.py:flash_attention_pallas`` (the
  ``pallas_call`` at line 122): queries and keys of the same call, every key
  valid; bf16 runs the tensor-core (wgmma) kernel and fp32 the CUDA-core
  one, by dtype alone (``csrc/flash_attention_fwd.cu``).
  ``FlashAttention`` is its ``torch.autograd.Function``, the port of
  the reference's ``ops._flash`` custom VJP (``ops.py:154-203``); its
  backward is ``kernels.flash_attention_bwd``.  The kernel reads q, k, v in
  the model layout (k and v through their strides) where the reference
  swapped axes around the kernel, and masks the ragged edge itself where
  the reference needed a tile that divides T.

* ``flash_attention_paged`` replaces
  ``src/repro/kernels/flash_attention.py:flash_attention_paged_pallas`` (the
  ``pallas_call`` at line 432) in both its forms: bf16/fp32 pools, and int8
  pools with bf16 scale pages (``k_scale_pool``/``v_scale_pool``, launched
  and counted as ``flash_attention_paged_int8``).  The form follows the
  dtype alone, as the contiguous prefill's does: bf16 pools run on the
  tensor cores (the fresh forward's tile loop over K/V tiles gathered
  through the block table), fp32 on CUDA cores; both count as
  ``flash_attention_paged`` (``csrc/flash_attention_paged.cu``).  No
  serving path launches the int8 form (an int8 prefill attends over its
  exact K/V through the contiguous kernel); it serves
  ``paged_flash_attention``'s int8 callers.
* ``flash_attention_offset`` replaces ``flash_attention_offset_pallas`` (the
  ``pallas_call`` at line 260): a prefill chunk of the slot pool, the
  lockstep prefill or an int8 run's single-shot prefill, at per-row
  ``q_offset`` against a contiguous cache.  The kernel reads the cache in
  the model layout through its strides and masks the ragged edge itself;
  the reference's ``ops._flash_offset`` transposed q, k and v and padded
  the cache to a tile multiple first.  The kernel's form follows the dtype
  alone, as the fresh forward's does: bf16 runs on the tensor cores (wgmma,
  the fresh forward's tile loop), fp32 on CUDA cores
  (``csrc/flash_attention_offset.cu``).  The tensor-core form is the faster
  at every chunk width measured, one query row included (PERF.md), so no
  width threshold is kept.

Layouts keep the model's: q [B, Tq, Hq, D] in, out [B, Tq, Hq, D];
pools [P, Hkv, BS, D] with block_tables [B, M] int32, or k, v
[B, Tk, Hkv, D]; q_offset, kv_valid_len [B].  lse comes back as
[B, Hq, Tq] float32, −inf for a row with no valid key (the Pallas kernels'
[B, Hq, Tq, 1] without the unit axis).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.attention import DEFAULT_CHUNK, online_attention_lse
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention_bwd as _bwd
from repro_torch.kernels.flash_decode import (check_kv_dtypes, gather_pages,
                                              gather_scales)

SUPPORTED_HEAD_DIMS = (64,)          # smollm-360m's head_dim (csrc instances)
BQ = 16               # query rows of one CTA (csrc kPrefillRows)
_SMEM_LIMIT = 48 * 1024

#: Kernel launches since the last reset (a path's proof of route).
launches = {"flash_attention_paged": 0, "flash_attention_offset": 0,
            "flash_attention": 0, "flash_attention_paged_int8": 0}

_C = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_OFFSET_ARGTYPES = [_C] * 7 + [_I] * 6 + [_L] * 3 + [ctypes.c_float, _I, _C]
_PAGED_ARGTYPES = [_C] * 8 + [_I] * 8 + [ctypes.c_float, _I, _C]
_ARGTYPES = {
    "flash_attention_paged": _PAGED_ARGTYPES,
    "flash_attention_paged_wgmma": _PAGED_ARGTYPES,
    "flash_attention_offset": _OFFSET_ARGTYPES,
    "flash_attention": [_C, _C, _C, _C, _C, _I, _I, _I, _I, _I, _I, _I, _L, _L,
                        _L, ctypes.c_float, _I, _C],
    "flash_attention_paged_int8": [_C] * 10 + [_I] * 8 + [_L] * 3
    + [ctypes.c_float, _I, _C],
    "flash_attention_offset_wgmma": _OFFSET_ARGTYPES,
}
# launch name → (its C entry point, the source whose library holds it, the
# kernel whose launches it counts)
_ENTRY = {"flash_attention": ("flash_attention_fwd", "flash_attention_fwd",
                              "flash_attention"),
          "flash_attention_paged_int8": ("flash_attention_paged_int8",
                                         "flash_attention_paged",
                                         "flash_attention_paged_int8"),
          "flash_attention_offset_wgmma": ("flash_attention_offset_wgmma",
                                           "flash_attention_offset",
                                           "flash_attention_offset"),
          "flash_attention_paged_wgmma": ("flash_attention_paged_wgmma",
                                          "flash_attention_paged",
                                          "flash_attention_paged")}


def flash_attention_fwd_plain(q, k, v, *, causal: bool = True,
                              chunk_size: int = DEFAULT_CHUNK):
    """The fresh kernel's plain version: the chunked online attention of q
    [B, Tq, Hq, D] over every position of k, v [B, Tk, Hkv, D], query row i
    at position i.  Returns (out [B, Tq, Hq, D], lse [B, Hq, Tq])."""
    return online_attention_lse(q, k, v, causal=causal,
                                chunk_size=chunk_size)


def flash_attention_offset_plain(q, k, v, q_offset, kv_valid_len, *,
                                 causal: bool = True,
                                 chunk_size: int = DEFAULT_CHUNK):
    """The contiguous kernel's plain version: the chunked online attention
    of q [B, Tq, Hq, D] at absolute offset ``q_offset`` over the first
    ``kv_valid_len`` (clamped to Tk) positions of k, v [B, Tk, Hkv, D].
    Returns (out [B, Tq, Hq, D], lse [B, Hq, Tq])."""
    return online_attention_lse(q, k, v, causal=causal, q_offset=q_offset,
                                kv_valid_len=kv_valid_len,
                                chunk_size=chunk_size)


def flash_attention_paged_plain(q, k_pool, v_pool, q_offset, kv_valid_len,
                                block_tables, *, causal: bool = True,
                                chunk_size: int = DEFAULT_CHUNK,
                                k_scale_pool=None, v_scale_pool=None):
    """The paged kernel's plain version: gather the pages (and the scale
    pages of int8 pools, as the reference's ``_gathered_int8_chunked``)
    and run the chunked online attention.  Returns (out [B, Tq, Hq, D], lse
    [B, Hq, Tq])."""
    return online_attention_lse(
        q, gather_pages(k_pool, block_tables),
        gather_pages(v_pool, block_tables), causal=causal, q_offset=q_offset,
        kv_valid_len=kv_valid_len, chunk_size=chunk_size,
        **gather_scales(k_scale_pool, v_scale_pool, block_tables))


def _check(name, q, k, v, hkv, k_scale=None, v_scale=None):
    """Shared validation: CUDA operands of q's dtype (or int8 K/V with bf16
    scales) and head_dim, in a GQA grouping and a grid the kernel takes."""
    if q.device.type != "cuda":
        raise ValueError(f"{name} kernel needs CUDA tensors, got {q.device}")
    b, tq, hq, dh = q.shape
    if k.shape[-1] != dh or v.shape != k.shape:
        raise ValueError(f"{name} kernel: q {tuple(q.shape)} and K/V "
                         f"{tuple(k.shape)}/{tuple(v.shape)} do not match")
    check_kv_dtypes(name, q, k, v, k_scale, v_scale)
    if hq % hkv or dh not in SUPPORTED_HEAD_DIMS or hq > 65535 or b > 65535:
        raise ValueError(f"{name} kernel: Hq={hq}, Hkv={hkv}, D={dh} not "
                         f"supported (D in {SUPPORTED_HEAD_DIMS})")
    return b, tq, hq, dh


def _kv_strides(name, k, v, b):
    """k, v [B, Tk, Hkv, D] are read through their strides: the last must
    be 1 and K and V must share them.  Returns (sb, ss, sh)."""
    if k.dim() != 4 or k.shape[0] != b or k.stride(-1) != 1 or \
            k.stride() != v.stride():
        raise ValueError(f"{name} kernel: K/V {tuple(k.shape)} with strides "
                         f"{k.stride()}/{v.stride()} for {b} rows (need "
                         "[B, Tk, Hkv, D], unit last stride, equal K/V "
                         "strides)")
    return k.stride()[:3]


def _rows(x, q, b):
    return torch.as_tensor(x, device=q.device).to(torch.int32).expand(
        b).contiguous()


def prepare_paged(q, k_pool, v_pool, q_offset, kv_valid_len, block_tables, *,
                  causal: bool = True, k_scale_pool=None, v_scale_pool=None):
    """Validate CUDA operands of the paged kernel and allocate the outputs.
    bf16 pools launch the tensor-core form, which raises on operands that
    are not 16-byte aligned; fp32 pools the CUDA-core form.  With
    ``k_scale_pool``/``v_scale_pool`` [P, Hkv, BS] (bf16, passed by their
    strides) the pools are int8 and the int8 form launches.  Returns
    (launch arguments, (out [B, Tq, Hq, D], lse [B, Hq, Tq]));
    :func:`launch` fills them.  Raises on another device, dtype or shape the
    kernel does not take."""
    hkv, bs = k_pool.shape[1], k_pool.shape[2]
    b, tq, hq, dh = _check("flash_attention_paged", q, k_pool, v_pool, hkv,
                           k_scale_pool, v_scale_pool)
    wgmma = q.dtype == torch.bfloat16 and k_scale_pool is None
    smem = 4 * (BQ * (dh + 1) + bs * (dh + 1) + bs * dh + BQ * bs)
    if k_pool.dim() != 4 or (smem > _SMEM_LIMIT and not wgmma):
        raise ValueError(f"flash_attention_paged kernel: pools "
                         f"{tuple(k_pool.shape)} need {smem} B of shared "
                         f"memory (at most {_SMEM_LIMIT})")
    code = build.dtype_code(q)
    qc = q.contiguous()
    kc, vc = k_pool.contiguous(), v_pool.contiguous()
    tables = block_tables.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(qc)
    lse = torch.empty((b, hq, tq), dtype=torch.float32, device=q.device)
    rows = (_rows(q_offset, q, b), _rows(kv_valid_len, q, b), tables, out,
            lse, code, b, tq, hq, hkv, bs, dh, tables.shape[1])
    tail = (float(dh ** -0.5), int(bool(causal)))
    if wgmma:
        _bwd.check_wgmma_operands("flash_attention_paged", (qc, kc, vc, out),
                                  kc.stride()[:3])
        args = ("flash_attention_paged_wgmma", qc, kc, vc, *rows, *tail)
    elif k_scale_pool is None:
        args = ("flash_attention_paged", qc, kc, vc, *rows, *tail)
    else:
        args = ("flash_attention_paged_int8", qc, kc, vc, k_scale_pool,
                v_scale_pool, *rows, *k_scale_pool.stride(), *tail)
    return args, (out, lse)


def prepare(q, k, v, q_offset, kv_valid_len, *, causal: bool = True):
    """Validate CUDA operands of the contiguous kernel and allocate the
    outputs.  k, v [B, Tk, Hkv, D] are passed by their strides (the last
    must be 1, and K and V must share them), never copied or padded.  bf16
    launches the tensor-core form, which raises on operands that are not
    16-byte aligned or K/V strides that are not multiples of 8; fp32 the
    CUDA-core form.  Returns (launch arguments, (out [B, Tq, Hq, D], lse
    [B, Hq, Tq])); :func:`launch` fills them."""
    if k.dim() != 4:
        raise ValueError(f"flash_attention_offset kernel: k {tuple(k.shape)} "
                         "is not [B, Tk, Hkv, D]")
    tk, hkv = k.shape[1], k.shape[2]
    b, tq, hq, dh = _check("flash_attention_offset", q, k, v, hkv)
    sb, ss, sh = _kv_strides("flash_attention_offset", k, v, b)
    build.dtype_code(q)                 # raises on another dtype
    qc = q.contiguous()
    out = torch.empty_like(qc)
    lse = torch.empty((b, hq, tq), dtype=torch.float32, device=q.device)
    name = "flash_attention_offset"
    if q.dtype == torch.bfloat16:
        _bwd.check_wgmma_operands(name, (qc, k, v), (sb, ss, sh))
        name = "flash_attention_offset_wgmma"
    return (name, qc, k, v, _rows(q_offset, q, b), _rows(kv_valid_len, q, b),
            out, lse, b, tq, hq, hkv, tk, dh, sb, ss, sh, float(dh ** -0.5),
            int(bool(causal))), (out, lse)


def launch(args) -> None:
    """Launch a prepared kernel (counts one launch of it)."""
    name = args[0]
    entry, source, counted = _ENTRY.get(name, (name, name, name))
    build.call(entry, _ARGTYPES[name], args[1:], source=source)
    launches[counted] += 1


def flash_attention_paged(q, k_pool, v_pool, q_offset, kv_valid_len,
                          block_tables, *, causal: bool = True,
                          k_scale_pool=None, v_scale_pool=None):
    """Launch the paged prefill kernel on CUDA tensors (its int8 form when
    the pools' scale pages are given).  Returns (out [B, Tq, Hq, D], lse
    [B, Hq, Tq])."""
    args, out = prepare_paged(q, k_pool, v_pool, q_offset, kv_valid_len,
                              block_tables, causal=causal,
                              k_scale_pool=k_scale_pool,
                              v_scale_pool=v_scale_pool)
    launch(args)
    return out


def flash_attention_offset(q, k, v, q_offset, kv_valid_len, *,
                           causal: bool = True):
    """Launch the contiguous cached-prefill kernel on CUDA tensors: q
    [B, Tq, Hq, D] at absolute offset ``q_offset`` [B] against the first
    ``kv_valid_len`` [B] (clamped to Tk) positions of k, v [B, Tk, Hkv, D].
    Returns (out [B, Tq, Hq, D], lse [B, Hq, Tq])."""
    args, out = prepare(q, k, v, q_offset, kv_valid_len, causal=causal)
    launch(args)
    return out


def prepare_fwd(q, k, v, *, causal: bool = True):
    """Validate CUDA operands of the fresh kernel and allocate the outputs.
    k, v [B, Tk, Hkv, D] are passed by their strides, never copied.  Returns
    (launch arguments, (out [B, Tq, Hq, D], lse [B, Hq, Tq]))."""
    if k.dim() != 4:
        raise ValueError(f"flash_attention kernel: k {tuple(k.shape)} is not "
                         "[B, Tk, Hkv, D]")
    tk, hkv = k.shape[1], k.shape[2]
    b, tq, hq, dh = _check("flash_attention", q, k, v, hkv)
    sb, ss, sh = _kv_strides("flash_attention", k, v, b)
    if tq == 0 or tk == 0:
        raise ValueError(f"flash_attention kernel: empty sequence (Tq={tq}, "
                         f"Tk={tk})")
    code = build.dtype_code(q)
    qc = q.contiguous()
    _bwd.check_wgmma_operands("flash_attention", (qc, k, v), (sb, ss, sh))
    out = torch.empty_like(qc)
    lse = torch.empty((b, hq, tq), dtype=torch.float32, device=q.device)
    args = ("flash_attention", qc, k, v, out, lse, code, b, tq, tk, hq, hkv,
            dh, sb, ss, sh, float(dh ** -0.5), int(bool(causal)))
    return args, (out, lse)


def flash_attention_fwd(q, k, v, *, causal: bool = True):
    """Launch the fresh forward kernel on CUDA tensors: q [B, Tq, Hq, D]
    against every position of k, v [B, Tk, Hkv, D], query row i at position
    i.  Returns (out [B, Tq, Hq, D], lse [B, Hq, Tq] float32)."""
    args, out = prepare_fwd(q, k, v, causal=causal)
    launch(args)
    return out


class FlashAttention(torch.autograd.Function):
    """Differentiable fresh flash attention, the port of the reference's
    ``ops._flash``: ``FlashAttention.apply(q, k, v, causal)`` → out
    [B, Tq, Hq, D].  The forward saves (q, k, v, out, lse) as ``_flash_fwd``
    does; the backward rebuilds P from lse.  CUDA tensors run the kernels
    (``flash_attention_fwd``, ``flash_attention_bwd``), CPU tensors their
    plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, causal=True):
        if q.device.type == "cuda":
            out, lse = flash_attention_fwd(q, k, v, causal=causal)
        elif q.device.type == "cpu":
            out, lse = flash_attention_fwd_plain(q, k, v, causal=causal)
        else:
            raise NotImplementedError(f"FlashAttention: no kernel or plain "
                                      f"version for device {q.device}")
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if dout.device.type == "cuda":
            dq, dk, dv = _bwd.flash_attention_bwd(q, k, v, out, lse, dout,
                                                  causal=ctx.causal)
        else:
            dq, dk, dv = _bwd.flash_attention_bwd_plain(
                q, k, v, out, lse, dout, causal=ctx.causal)
        return dq, dk, dv, None
