"""Paged single-token decode attention: the CUDA kernel's wrapper and its
plain PyTorch version.

Replaces ``src/repro/kernels/flash_decode.py:flash_decode_paged_pallas`` (the
``pallas_call`` at line 245) in its bf16/fp32 form.  The int8 form (scale
pages beside int8 pools) belongs to the int8-KV slice and raises here.

Layouts keep the model's: q [B, 1, Hq, D] in, out [B, 1, Hq, D];
pools [P, Hkv, BS, D]; block_tables [B, M] int32 with sentinel block 0;
kv_valid_len [B].
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.attention import DEFAULT_CHUNK, online_attention
from repro_torch.kernels import build

SUPPORTED_HEAD_DIMS = (64,)          # smollm-360m's head_dim (csrc instances)
_SMEM_LIMIT = 48 * 1024

#: Kernel launches since the last reset (the serving path's proof of route).
launches = 0

_C = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = build.library("flash_decode_paged")
    fn = lib.flash_decode_paged_launch
    if fn.argtypes is None:
        fn.argtypes = [_C, _C, _C, _C, _C, _C, _I, _I, _I, _I, _I, _I, _I,
                       ctypes.c_float, _C]
        fn.restype = ctypes.c_int
    return lib


def gather_pages(pool: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """[P, Hkv, BS, D] + [B, M] → contiguous [B, M·BS, Hkv, D] (model
    layout).  Positions past a row's valid length gather stale or sentinel
    blocks — finite garbage the attention mask erases exactly."""
    g = pool[block_tables.long()]               # [B, M, Hkv, BS, D]
    g = g.transpose(2, 3)                       # [B, M, BS, Hkv, D]
    return g.reshape(block_tables.shape[0], -1, pool.shape[1], pool.shape[3])


def flash_decode_paged_plain(q, k_pool, v_pool, block_tables, kv_valid_len, *,
                             chunk_size: int = DEFAULT_CHUNK) -> torch.Tensor:
    """The plain version: gather the pages into a contiguous cache and run
    the chunked online attention (``core.attention.online_attention``)."""
    return online_attention(
        q, gather_pages(k_pool, block_tables),
        gather_pages(v_pool, block_tables), causal=False,
        kv_valid_len=kv_valid_len, chunk_size=chunk_size)


def prepare(q, k_pool, v_pool, block_tables, kv_valid_len):
    """Validate CUDA operands and allocate the output.  Returns (launch
    arguments, out [B, 1, Hq, D]); :func:`launch` fills ``out``.  Raises on
    another device, dtype or shape the kernel does not take."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_paged kernel needs CUDA tensors, got "
                         f"{q.device}")
    b, t, hq, dh = q.shape
    p, hkv, bs, dk = k_pool.shape
    if t != 1 or dk != dh or v_pool.shape != k_pool.shape:
        raise ValueError(f"flash_decode_paged kernel: q {tuple(q.shape)} and "
                         f"pools {tuple(k_pool.shape)}/{tuple(v_pool.shape)} "
                         "are not a one-token decode over equal K/V pools")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(f"flash_decode_paged kernel: q is {q.dtype} but the "
                        f"pools are {k_pool.dtype} (int8 pools are ported "
                        "with the int8-KV slice)")
    g = hq // hkv
    smem = 4 * (g * dh + bs * (dh + 1) + bs * dh + g * bs)
    if (hq % hkv or dh not in SUPPORTED_HEAD_DIMS or g * dh > 1024
            or smem > _SMEM_LIMIT or b > 65535):
        raise ValueError(f"flash_decode_paged kernel: Hq={hq}, Hkv={hkv}, "
                         f"D={dh}, BS={bs} not supported (D in "
                         f"{SUPPORTED_HEAD_DIMS}, G*D <= 1024, "
                         f"{smem} B of shared memory <= {_SMEM_LIMIT})")
    code = build.dtype_code(q)
    qc = q.contiguous()
    kc, vc = k_pool.contiguous(), v_pool.contiguous()
    tables = block_tables.to(device=q.device, dtype=torch.int32).contiguous()
    vlen = torch.as_tensor(kv_valid_len, device=q.device).to(
        torch.int32).expand(b).contiguous()
    out = torch.empty_like(qc)
    args = (qc, kc, vc, tables, vlen, out, code, b, hq, hkv, bs, dh,
            tables.shape[1], float(dh ** -0.5))
    return args, out


def launch(args) -> None:
    """Launch the kernel on prepared arguments (counts one launch)."""
    global launches
    qc, kc, vc, tables, vlen, out, code, b, hq, hkv, bs, dh, m, scale = args
    lib = _lib()
    with torch.cuda.device(qc.device):
        err = lib.flash_decode_paged_launch(
            build.ptr(qc), build.ptr(kc), build.ptr(vc), build.ptr(tables),
            build.ptr(vlen), build.ptr(out), code, b, hq, hkv, bs, dh, m,
            scale, build.stream_ptr(qc.device))
    build.check(lib, err, "flash_decode_paged kernel")
    launches += 1


def flash_decode_paged(q, k_pool, v_pool, block_tables,
                       kv_valid_len) -> torch.Tensor:
    """Launch the paged decode kernel on CUDA tensors."""
    args, out = prepare(q, k_pool, v_pool, block_tables, kv_valid_len)
    launch(args)
    return out
