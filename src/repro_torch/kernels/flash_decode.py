"""Single-token decode attention: the CUDA kernels' wrappers and their plain
PyTorch versions, over a paged KV pool and over a contiguous KV cache.

* ``flash_decode_paged`` replaces
  ``src/repro/kernels/flash_decode.py:flash_decode_paged_pallas`` (the
  ``pallas_call`` at line 245) in both its forms: bf16/fp32 pools, and int8
  pools with bf16 scale pages beside them (``k_scale_pool``/
  ``v_scale_pool``, launched and counted as ``flash_decode_paged_int8``).
* ``flash_decode`` replaces ``flash_decode_pallas`` (the ``pallas_call`` at
  line 98), the slot pool's and the lockstep loop's decode.  The kernel
  reads the cache in the model layout through its strides; the reference's
  ``ops.flash_decode`` transposed it to [B, Hkv, S, D] first.  Its int8 form
  (``k_scale``/``v_scale``, counted as ``flash_decode_int8``) has no
  ``pallas_call`` counterpart: the reference ran XLA's dequantizing chunked
  form there (``dispatch.py:858-870``), which is this form's plain version.

Layouts keep the model's: q [B, 1, Hq, D] in, out [B, 1, Hq, D];
pools [P, Hkv, BS, D] with block_tables [B, M] int32 (sentinel block 0), or
caches [B, S, Hkv, D]; kv_valid_len [B].  int8 K/V carry bf16 scales, pages
[P, Hkv, BS] or [B, S, Hkv], and dequantize as ``int8 * scale`` in fp32.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.attention import DEFAULT_CHUNK, online_attention
from repro_torch.kernels import build

SUPPORTED_HEAD_DIMS = (64,)          # smollm-360m's head_dim (csrc instances)
_SMEM_LIMIT = 48 * 1024

#: Kernel launches since the last reset (the serving path's proof of route).
launches = {"flash_decode_paged": 0, "flash_decode": 0,
            "flash_decode_paged_int8": 0, "flash_decode_int8": 0}

_C = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_ARGTYPES = {
    "flash_decode_paged": [_C, _C, _C, _C, _C, _C, _I, _I, _I, _I, _I, _I, _I,
                           _F, _C],
    "flash_decode": [_C, _C, _C, _C, _C, _I, _I, _I, _I, _I, _I, _L, _L, _L,
                     _F, _C],
    "flash_decode_paged_int8": [_C] * 8 + [_I] * 7 + [_L] * 3 + [_F, _C],
    "flash_decode_int8": [_C] * 7 + [_I] * 6 + [_L] * 6 + [_F, _C],
}
# launch name → the source whose library holds its ``<name>_launch``
_SOURCE = {"flash_decode_paged_int8": "flash_decode_paged",
           "flash_decode_int8": "flash_decode"}


def gather_pages(pool: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """[P, Hkv, BS, D] + [B, M] → contiguous [B, M·BS, Hkv, D] (model
    layout).  Positions past a row's valid length gather stale or sentinel
    blocks — finite garbage the attention mask erases exactly."""
    g = pool[block_tables.long()]               # [B, M, Hkv, BS, D]
    g = g.transpose(2, 3)                       # [B, M, BS, Hkv, D]
    return g.reshape(block_tables.shape[0], -1, pool.shape[1], pool.shape[3])


def gather_scales(k_scale_pool, v_scale_pool, block_tables) -> dict:
    """The plain versions' ``k_scale``/``v_scale`` [B, M·BS, Hkv] from
    int8 pools' scale pages [P, Hkv, BS], in the order :func:`gather_pages`
    gives the positions, so position i's scale lands beside position i's
    int8 row (the reference's ``_gather_scale_pages``); {} for fp pools."""
    if k_scale_pool is None:
        return {}
    b, hkv = block_tables.shape[0], k_scale_pool.shape[1]
    ids = block_tables.long()
    pools = {"k_scale": k_scale_pool, "v_scale": v_scale_pool}
    # [B, M, Hkv, BS] → [B, M, BS, Hkv] → [B, M·BS, Hkv]
    return {name: pool[ids].transpose(2, 3).reshape(b, -1, hkv)
            for name, pool in pools.items()}


def flash_decode_plain(q, k_cache, v_cache, kv_valid_len, *,
                       chunk_size: int = DEFAULT_CHUNK, k_scale=None,
                       v_scale=None):
    """The contiguous kernel's plain version: the chunked online attention
    (``core.attention.online_attention``) of q [B, 1, Hq, D] over the first
    ``kv_valid_len[b]`` positions of caches [B, S, Hkv, D]; int8 caches with
    ``k_scale``/``v_scale`` [B, S, Hkv] dequantize per chunk."""
    return online_attention(q, k_cache, v_cache, causal=False,
                            kv_valid_len=kv_valid_len, chunk_size=chunk_size,
                            k_scale=k_scale, v_scale=v_scale)


def flash_decode_paged_plain(q, k_pool, v_pool, block_tables, kv_valid_len, *,
                             chunk_size: int = DEFAULT_CHUNK,
                             k_scale_pool=None, v_scale_pool=None):
    """The paged kernel's plain version: gather the pages (and the scale
    pages of int8 pools) into a contiguous cache and run the chunked online
    attention — the reference's ``_gathered_int8_chunked`` for int8."""
    return flash_decode_plain(q, gather_pages(k_pool, block_tables),
                              gather_pages(v_pool, block_tables),
                              kv_valid_len, chunk_size=chunk_size,
                              **gather_scales(k_scale_pool, v_scale_pool,
                                              block_tables))


def check_kv_dtypes(name, q, k, v, k_scale, v_scale) -> None:
    """K/V of q's dtype, or (with scales) int8 K/V with bf16 scales of
    K's shape without its last axis, K and V scales alike."""
    if k_scale is None:
        if k.dtype != q.dtype or v.dtype != q.dtype:
            raise ValueError(f"{name} kernel: q is {q.dtype} but K/V are "
                             f"{k.dtype}/{v.dtype} (int8 K/V need their "
                             "scales)")
        return
    if k.dtype != torch.int8 or v.dtype != torch.int8:
        raise ValueError(f"{name} kernel: scales given but K/V are "
                         f"{k.dtype}/{v.dtype}, not int8")
    if k_scale.dtype != torch.bfloat16 or v_scale.dtype != torch.bfloat16 \
            or k_scale.shape != k.shape[:-1] \
            or v_scale.shape != k_scale.shape \
            or k_scale.stride() != v_scale.stride() \
            or k_scale.device != q.device or v_scale.device != q.device:
        raise ValueError(f"{name} kernel: scales {k_scale.dtype} "
                         f"{tuple(k_scale.shape)}/{v_scale.dtype} "
                         f"{tuple(v_scale.shape)} (strides "
                         f"{k_scale.stride()}/{v_scale.stride()}) for int8 "
                         f"K/V {tuple(k.shape)}: need bf16 scales of shape "
                         f"{tuple(k.shape[:-1])} on {q.device}, K and V "
                         "scales with equal strides")


def _check_query(name, q, k, v, hkv, k_scale=None, v_scale=None):
    """Shared validation: a CUDA one-token query against K/V of q's dtype
    (or int8 with bf16 scales) and head_dim, in a GQA grouping the kernel's
    CTA can hold."""
    if q.device.type != "cuda":
        raise ValueError(f"{name} kernel needs CUDA tensors, got {q.device}")
    b, t, hq, dh = q.shape
    if t != 1 or k.shape[-1] != dh or v.shape != k.shape:
        raise ValueError(f"{name} kernel: q {tuple(q.shape)} and K/V "
                         f"{tuple(k.shape)}/{tuple(v.shape)} are not a "
                         "one-token decode over equal K/V")
    check_kv_dtypes(name, q, k, v, k_scale, v_scale)
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


def prepare_paged(q, k_pool, v_pool, block_tables, kv_valid_len, *,
                  k_scale_pool=None, v_scale_pool=None):
    """Validate CUDA operands of the paged kernel and allocate the output.
    With ``k_scale_pool``/``v_scale_pool`` [P, Hkv, BS] (bf16, passed by
    their strides) the pools are int8 and the int8 form launches.  Returns
    (launch arguments, out [B, 1, Hq, D]); :func:`launch` fills ``out``.
    Raises on another device, dtype or shape the kernel does not take."""
    hkv, bs = k_pool.shape[1], k_pool.shape[2]
    b, hq, dh, g = _check_query("flash_decode_paged", q, k_pool, v_pool, hkv,
                                k_scale_pool, v_scale_pool)
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
    geometry = (code, b, hq, hkv, bs, dh, tables.shape[1])
    vlen = _vlen(kv_valid_len, q, b)
    if k_scale_pool is None:
        args = ("flash_decode_paged", qc, kc, vc, tables, vlen, out,
                *geometry, float(dh ** -0.5))
    else:
        args = ("flash_decode_paged_int8", qc, kc, vc, k_scale_pool,
                v_scale_pool, tables, vlen, out, *geometry,
                *k_scale_pool.stride(), float(dh ** -0.5))
    return args, out


def prepare(q, k_cache, v_cache, kv_valid_len, *, k_scale=None,
            v_scale=None):
    """Validate CUDA operands of the contiguous kernel and allocate the
    output.  The caches [B, S, Hkv, D] are passed by their strides (the last
    must be 1, and K and V must share them), never copied; so are int8
    caches' ``k_scale``/``v_scale`` [B, S, Hkv] (bf16), which select the
    int8 form.  Returns (launch arguments, out [B, 1, Hq, D]);
    :func:`launch` fills ``out``."""
    if k_cache.dim() != 4:
        raise ValueError(f"flash_decode kernel: caches {tuple(k_cache.shape)} "
                         "are not [B, S, Hkv, D]")
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    b, hq, dh, _ = _check_query("flash_decode", q, k_cache, v_cache, hkv,
                                k_scale, v_scale)
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
    vlen = _vlen(kv_valid_len, q, b)
    if k_scale is None:
        args = ("flash_decode", qc, k_cache, v_cache, vlen, out, code, b, hq,
                hkv, s, dh, sb, ss, sh, float(dh ** -0.5))
    else:
        args = ("flash_decode_int8", qc, k_cache, v_cache, k_scale, v_scale,
                vlen, out, code, b, hq, hkv, s, dh, sb, ss, sh,
                *k_scale.stride(), float(dh ** -0.5))
    return args, out


def launch(args) -> None:
    """Launch a prepared kernel (counts one launch of it)."""
    name = args[0]
    build.call(name, _ARGTYPES[name], args[1:],
               source=_SOURCE.get(name, name))
    launches[name] += 1


def flash_decode_paged(q, k_pool, v_pool, block_tables, kv_valid_len, *,
                       k_scale_pool=None, v_scale_pool=None) -> torch.Tensor:
    """Launch the paged decode kernel on CUDA tensors (its int8 form when
    the pools' scale pages are given)."""
    args, out = prepare_paged(q, k_pool, v_pool, block_tables, kv_valid_len,
                              k_scale_pool=k_scale_pool,
                              v_scale_pool=v_scale_pool)
    launch(args)
    return out


def flash_decode(q, k_cache, v_cache, kv_valid_len, *, k_scale=None,
                 v_scale=None) -> torch.Tensor:
    """Launch the contiguous decode kernel on CUDA tensors: q [B, 1, Hq, D]
    over caches [B, S, Hkv, D] up to ``kv_valid_len`` [B] (clamped to S);
    its int8 form when the caches' scales [B, S, Hkv] are given."""
    args, out = prepare(q, k_cache, v_cache, kv_valid_len, k_scale=k_scale,
                        v_scale=v_scale)
    launch(args)
    return out
