"""Paged cached-prefill flash attention: the CUDA kernel's wrapper and its
plain PyTorch version.

Replaces ``src/repro/kernels/flash_attention.py:flash_attention_paged_pallas``
(the ``pallas_call`` at line 432) in its bf16/fp32 form.  The int8 form
belongs to the int8-KV slice and raises here.

Layouts keep the model's: q [B, Tq, Hq, D] in, out [B, Tq, Hq, D];
pools [P, Hkv, BS, D]; q_offset, kv_valid_len [B]; block_tables [B, M]
int32.  lse comes back as [B, Hq, Tq] float32, −inf for a row with no valid
key (the Pallas kernel's [B, Hq, Tq, 1] without the unit axis).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.attention import DEFAULT_CHUNK, online_attention_lse
from repro_torch.kernels import build
from repro_torch.kernels.flash_decode import gather_pages

SUPPORTED_HEAD_DIMS = (64,)          # smollm-360m's head_dim (csrc instances)
BQ = 16               # query rows of one CTA (csrc kBQ)
_SMEM_LIMIT = 48 * 1024

#: Kernel launches since the last reset (the serving path's proof of route).
launches = 0

_C = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = build.library("flash_attention_paged")
    fn = lib.flash_attention_paged_launch
    if fn.argtypes is None:
        fn.argtypes = [_C, _C, _C, _C, _C, _C, _C, _C, _I, _I, _I, _I, _I, _I,
                       _I, _I, ctypes.c_float, _I, _C]
        fn.restype = ctypes.c_int
    return lib


def flash_attention_paged_plain(q, k_pool, v_pool, q_offset, kv_valid_len,
                                block_tables, *, causal: bool = True,
                                chunk_size: int = DEFAULT_CHUNK):
    """The plain version: gather the pages and run the chunked online
    attention.  Returns (out [B, Tq, Hq, D], lse [B, Hq, Tq])."""
    return online_attention_lse(
        q, gather_pages(k_pool, block_tables),
        gather_pages(v_pool, block_tables), causal=causal, q_offset=q_offset,
        kv_valid_len=kv_valid_len, chunk_size=chunk_size)


def prepare(q, k_pool, v_pool, q_offset, kv_valid_len, block_tables, *,
            causal: bool = True):
    """Validate CUDA operands and allocate the outputs.  Returns (launch
    arguments, (out [B, Tq, Hq, D], lse [B, Hq, Tq])); :func:`launch` fills
    them.  Raises on another device, dtype or shape the kernel does not
    take."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_paged kernel needs CUDA tensors, "
                         f"got {q.device}")
    b, tq, hq, dh = q.shape
    p, hkv, bs, dk = k_pool.shape
    if dk != dh or v_pool.shape != k_pool.shape:
        raise ValueError(f"flash_attention_paged kernel: q {tuple(q.shape)} "
                         f"and pools {tuple(k_pool.shape)}/"
                         f"{tuple(v_pool.shape)} do not match")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(f"flash_attention_paged kernel: q is {q.dtype} but "
                        f"the pools are {k_pool.dtype} (int8 pools are ported "
                        "with the int8-KV slice)")
    smem = 4 * (BQ * (dh + 1) + bs * (dh + 1) + bs * dh + BQ * bs)
    if (hq % hkv or dh not in SUPPORTED_HEAD_DIMS or smem > _SMEM_LIMIT
            or hq > 65535 or b > 65535):
        raise ValueError(f"flash_attention_paged kernel: Hq={hq}, Hkv={hkv}, "
                         f"D={dh}, BS={bs} not supported (D in "
                         f"{SUPPORTED_HEAD_DIMS}, {smem} B of shared memory "
                         f"<= {_SMEM_LIMIT})")
    code = build.dtype_code(q)
    qc = q.contiguous()
    kc, vc = k_pool.contiguous(), v_pool.contiguous()
    tables = block_tables.to(device=q.device, dtype=torch.int32).contiguous()
    qoff = torch.as_tensor(q_offset, device=q.device).to(
        torch.int32).expand(b).contiguous()
    vlen = torch.as_tensor(kv_valid_len, device=q.device).to(
        torch.int32).expand(b).contiguous()
    out = torch.empty_like(qc)
    lse = torch.empty((b, hq, tq), dtype=torch.float32, device=q.device)
    args = (qc, kc, vc, qoff, vlen, tables, out, lse, code, b, tq, hq, hkv,
            bs, dh, tables.shape[1], float(dh ** -0.5), int(bool(causal)))
    return args, (out, lse)


def launch(args) -> None:
    """Launch the kernel on prepared arguments (counts one launch)."""
    global launches
    (qc, kc, vc, qoff, vlen, tables, out, lse, code, b, tq, hq, hkv, bs, dh,
     m, scale, causal) = args
    lib = _lib()
    with torch.cuda.device(qc.device):
        err = lib.flash_attention_paged_launch(
            build.ptr(qc), build.ptr(kc), build.ptr(vc), build.ptr(qoff),
            build.ptr(vlen), build.ptr(tables), build.ptr(out), build.ptr(lse),
            code, b, tq, hq, hkv, bs, dh, m, scale, causal,
            build.stream_ptr(qc.device))
    build.check(lib, err, "flash_attention_paged kernel")
    launches += 1


def flash_attention_paged(q, k_pool, v_pool, q_offset, kv_valid_len,
                          block_tables, *, causal: bool = True):
    """Launch the paged prefill kernel on CUDA tensors.  Returns
    (out [B, Tq, Hq, D], lse [B, Hq, Tq])."""
    args, out = prepare(q, k_pool, v_pool, q_offset, kv_valid_len,
                        block_tables, causal=causal)
    launch(args)
    return out
