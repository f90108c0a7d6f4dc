"""Single-token decode attention: the CUDA kernels' wrappers and their plain
PyTorch versions, over a paged KV pool and over a contiguous KV cache.

* ``flash_decode_paged`` replaces
  ``src/repro/kernels/flash_decode.py:flash_decode_paged_pallas`` (the
  ``pallas_call`` at line 245) in its bf16/fp32 form.  The int8 form (scale
  pages beside int8 pools) belongs to the int8-KV slice and raises here.
* ``flash_decode`` replaces ``flash_decode_pallas`` (the ``pallas_call`` at
  line 98), the slot pool's and the lockstep loop's decode.  The kernel
  reads the cache in the model layout through its strides; the reference's
  ``ops.flash_decode`` transposed it to [B, Hkv, S, D] first.

Layouts keep the model's: q [B, 1, Hq, D] in, out [B, 1, Hq, D];
pools [P, Hkv, BS, D] with block_tables [B, M] int32 (sentinel block 0), or
caches [B, S, Hkv, D]; kv_valid_len [B].
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.attention import DEFAULT_CHUNK, online_attention
from repro_torch.kernels import build

SUPPORTED_HEAD_DIMS = (64,)          # smollm-360m's head_dim (csrc instances)
_SMEM_LIMIT = 48 * 1024

#: Kernel launches since the last reset (the serving path's proof of route).
launches = {"flash_decode_paged": 0, "flash_decode": 0}

_C = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = {
    "flash_decode_paged": [_C, _C, _C, _C, _C, _C, _I, _I, _I, _I, _I, _I, _I,
                           ctypes.c_float, _C],
    "flash_decode": [_C, _C, _C, _C, _C, _I, _I, _I, _I, _I, _I, _L, _L, _L,
                     ctypes.c_float, _C],
}


def gather_pages(pool: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """[P, Hkv, BS, D] + [B, M] → contiguous [B, M·BS, Hkv, D] (model
    layout).  Positions past a row's valid length gather stale or sentinel
    blocks — finite garbage the attention mask erases exactly."""
    g = pool[block_tables.long()]               # [B, M, Hkv, BS, D]
    g = g.transpose(2, 3)                       # [B, M, BS, Hkv, D]
    return g.reshape(block_tables.shape[0], -1, pool.shape[1], pool.shape[3])


def flash_decode_plain(q, k_cache, v_cache, kv_valid_len, *,
                       chunk_size: int = DEFAULT_CHUNK):
    """The contiguous kernel's plain version: the chunked online attention
    (``core.attention.online_attention``) of q [B, 1, Hq, D] over the first
    ``kv_valid_len[b]`` positions of caches [B, S, Hkv, D]."""
    return online_attention(q, k_cache, v_cache, causal=False,
                            kv_valid_len=kv_valid_len, chunk_size=chunk_size)


def flash_decode_paged_plain(q, k_pool, v_pool, block_tables, kv_valid_len, *,
                             chunk_size: int = DEFAULT_CHUNK):
    """The paged kernel's plain version: gather the pages into a contiguous
    cache and run the chunked online attention."""
    return flash_decode_plain(q, gather_pages(k_pool, block_tables),
                              gather_pages(v_pool, block_tables),
                              kv_valid_len, chunk_size=chunk_size)


def _check_query(name, q, k, v, hkv):
    """Shared validation: a CUDA one-token query against K/V of q's dtype
    and head_dim, in a GQA grouping the kernel's CTA can hold."""
    if q.device.type != "cuda":
        raise ValueError(f"{name} kernel needs CUDA tensors, got {q.device}")
    b, t, hq, dh = q.shape
    if t != 1 or k.shape[-1] != dh or v.shape != k.shape:
        raise ValueError(f"{name} kernel: q {tuple(q.shape)} and K/V "
                         f"{tuple(k.shape)}/{tuple(v.shape)} are not a "
                         "one-token decode over equal K/V")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name} kernel: q is {q.dtype} but K/V are "
                         f"{k.dtype} (int8 caches are ported with the int8-KV "
                         "slice)")
    g = hq // hkv
    if hq % hkv or dh not in SUPPORTED_HEAD_DIMS or g * dh > 1024 \
            or b > 65535:
        raise ValueError(f"{name} kernel: Hq={hq}, Hkv={hkv}, D={dh} not "
                         f"supported (D in {SUPPORTED_HEAD_DIMS}, "
                         "G*D <= 1024)")
    return b, hq, dh, g


def _vlen(kv_valid_len, q, b):
    return torch.as_tensor(kv_valid_len, device=q.device).to(
        torch.int32).expand(b).contiguous()


def prepare_paged(q, k_pool, v_pool, block_tables, kv_valid_len):
    """Validate CUDA operands of the paged kernel and allocate the output.
    Returns (launch arguments, out [B, 1, Hq, D]); :func:`launch` fills
    ``out``.  Raises on another device, dtype or shape the kernel does not
    take."""
    hkv, bs = k_pool.shape[1], k_pool.shape[2]
    b, hq, dh, g = _check_query("flash_decode_paged", q, k_pool, v_pool, hkv)
    smem = 4 * (g * dh + bs * (dh + 1) + bs * dh + g * bs)
    if k_pool.dim() != 4 or smem > _SMEM_LIMIT:
        raise ValueError(f"flash_decode_paged kernel: pools "
                         f"{tuple(k_pool.shape)} with G={g} need {smem} B of "
                         f"shared memory (at most {_SMEM_LIMIT})")
    code = build.dtype_code(q)
    qc = q.contiguous()
    kc, vc = k_pool.contiguous(), v_pool.contiguous()
    tables = block_tables.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(qc)
    args = ("flash_decode_paged", qc, kc, vc, tables,
            _vlen(kv_valid_len, q, b), out, code, b, hq, hkv, bs, dh,
            tables.shape[1], float(dh ** -0.5))
    return args, out


def prepare(q, k_cache, v_cache, kv_valid_len):
    """Validate CUDA operands of the contiguous kernel and allocate the
    output.  The caches [B, S, Hkv, D] are passed by their strides (the last
    must be 1, and K and V must share them), never copied.  Returns (launch
    arguments, out [B, 1, Hq, D]); :func:`launch` fills ``out``."""
    if k_cache.dim() != 4:
        raise ValueError(f"flash_decode kernel: caches {tuple(k_cache.shape)} "
                         "are not [B, S, Hkv, D]")
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    b, hq, dh, _ = _check_query("flash_decode", q, k_cache, v_cache, hkv)
    if k_cache.shape[0] != b or k_cache.stride(-1) != 1 \
            or k_cache.stride() != v_cache.stride():
        raise ValueError(f"flash_decode kernel: caches {tuple(k_cache.shape)} "
                         f"with strides {k_cache.stride()}/{v_cache.stride()} "
                         f"for {b} rows (need unit last stride, equal K/V "
                         "strides)")
    code = build.dtype_code(q)
    qc = q.contiguous()
    out = torch.empty_like(qc)
    sb, ss, sh, _ = k_cache.stride()
    args = ("flash_decode", qc, k_cache, v_cache, _vlen(kv_valid_len, q, b),
            out, code, b, hq, hkv, s, dh, sb, ss, sh, float(dh ** -0.5))
    return args, out


def launch(args) -> None:
    """Launch a prepared kernel (counts one launch of it)."""
    name = args[0]
    build.call(name, _ARGTYPES[name], args[1:])
    launches[name] += 1


def flash_decode_paged(q, k_pool, v_pool, block_tables,
                       kv_valid_len) -> torch.Tensor:
    """Launch the paged decode kernel on CUDA tensors."""
    args, out = prepare_paged(q, k_pool, v_pool, block_tables, kv_valid_len)
    launch(args)
    return out


def flash_decode(q, k_cache, v_cache, kv_valid_len) -> torch.Tensor:
    """Launch the contiguous decode kernel on CUDA tensors: q [B, 1, Hq, D]
    over caches [B, S, Hkv, D] up to ``kv_valid_len`` [B] (clamped to S)."""
    args, out = prepare(q, k_cache, v_cache, kv_valid_len)
    launch(args)
    return out
