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

On the card each call is one C entry point and one kernel launch: one CTA
per (split, KV head, batch row) leaves its split's partial (m, d, acc) in
an fp32 workspace, and the last of a row's live splits to finish (a ticket
counter, set back to 0 by that CTA) ⊕-combines them in split order.
:func:`decode_plan`, a pure function of the shapes and the card's SM count,
picks the split; the host never reads ``kv_valid_len``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.core.attention import DEFAULT_CHUNK, online_attention
from repro_torch.kernels import build

SUPPORTED_HEAD_DIMS = (64,)          # smollm-360m's head_dim (csrc instances)
MAX_GROUP = 8             # query heads a KV head (kDecodeMaxGroup)
DECODE_THREADS = 128      # threads a split CTA (kDecodeThreads), any G and D
DECODE_WARPS = DECODE_THREADS // 32
SPLIT_BYTES = 16 * 1024   # K bytes a split CTA holds at most (V the same)
MIN_SPLIT = 32            # positions: shorter splits cost more than they hide
WAVES = 2                 # CTAs the grid aims for, in multiples of the SMs
CONTIGUOUS_TILE = 16      # the contiguous form's split unit, positions
SMEM_LIMIT = 232448       # dynamic shared memory a CTA may have (227 KB)
KV_DTYPES = (torch.float32, torch.bfloat16, torch.int8)

#: Kernel launches since the last reset (the serving path's proof of route).
launches = {"flash_decode_paged": 0, "flash_decode": 0,
            "flash_decode_paged_int8": 0, "flash_decode_int8": 0}

_C = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_ARGTYPES = {
    "flash_decode_paged": [_C] * 8 + [_I] * 9 + [_F, _C],
    "flash_decode": [_C] * 7 + [_I] * 8 + [_L] * 3 + [_F, _C],
    "flash_decode_paged_int8": [_C] * 10 + [_I] * 9 + [_L] * 3 + [_F, _C],
    "flash_decode_int8": [_C] * 9 + [_I] * 8 + [_L] * 6 + [_F, _C],
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


class DecodePlan(NamedTuple):
    """How the decode kernels cut one call's key range."""
    split: int        # positions a split CTA takes (a whole number of units)
    splits: int       # splits a (batch row, KV head): grid (splits, Hkv, B)
    threads: int      # threads a split CTA
    smem: int         # dynamic shared memory a split CTA, bytes
    workspace: int    # fp32 words of the partials: acc [.., G, D], (m, d)

    def live(self, vlen: int, max_len: int) -> int:
        """Splits a row of valid length ``vlen`` runs (the others exit)."""
        return -(-min(max(vlen, 0), max_len) // self.split)


def split_smem(g: int, d: int, esz: int, split: int, scaled: bool) -> int:
    """Bytes of dynamic shared memory of a split CTA (``decode_split_smem``
    in ``csrc/attention.cuh``): K and V of the split in their storage type,
    the int8 forms' fp32 scales, the scores [G, split], the warps'
    accumulators [warps, G, D] and each head's (m, d)."""
    return (2 * split * d * esz + (8 * split if scaled else 0) + 4 * g * split
            + 4 * DECODE_WARPS * g * d + 8 * MAX_GROUP)


@functools.lru_cache(maxsize=256)
def decode_plan(b: int, hkv: int, g: int, d: int, max_len: int, page: int,
                dtype: torch.dtype, sm_count: int) -> DecodePlan:
    """The split of a decode call, a pure function of its shapes: ``b``
    batch rows, ``hkv`` KV heads of ``g`` query heads, head_dim ``d``,
    ``max_len`` positions a row may hold (M·BS paged, S contiguous; the
    host's bound, no read of the valid lengths), splits in whole pages of
    ``page`` positions (BS paged, ``CONTIGUOUS_TILE`` contiguous), K/V of
    ``dtype`` (float32, bfloat16 or int8), on a card of ``sm_count`` SMs.

    The split is the longest whole number of pages that still gives
    ``WAVES`` × ``sm_count`` CTAs over (split, KV head, batch row), but no
    shorter than ``MIN_SPLIT`` positions (short caches do not split for
    nothing) and no longer than a cache of ``max_len``, nor than
    ``SPLIT_BYTES`` of K (the CTA holds its whole split in shared memory;
    longer caches take more splits).  Raises for shapes the kernels do not
    take."""
    if dtype not in KV_DTYPES or d not in SUPPORTED_HEAD_DIMS \
            or not 1 <= g <= MAX_GROUP or not 1 <= b <= 65535 \
            or not 1 <= hkv <= 65535 or page < 1 or max_len < 0 \
            or sm_count < 1:
        raise ValueError(f"decode kernels: B={b}, Hkv={hkv}, G={g}, D={d}, "
                         f"max_len={max_len}, page={page}, {dtype} not "
                         f"supported (D in {SUPPORTED_HEAD_DIMS}, G <= "
                         f"{MAX_GROUP}, B <= 65535, K/V in {KV_DTYPES})")
    esz = dtype.itemsize
    scaled = dtype == torch.int8

    def pages(n):                        # n positions up to whole pages
        return -(-n // page) * page

    cap = max(page, SPLIT_BYTES // (d * esz) // page * page)
    want = -(-WAVES * sm_count // (b * hkv))      # splits a row should take
    # the longest whole pages with ceil(max_len / split) >= want
    split = ((max_len - 1) // (want - 1) // page * page if want > 1
             else pages(max_len))
    split = max(split, pages(MIN_SPLIT))
    split = min(split, cap, max(page, pages(max_len)))
    splits = max(1, -(-max_len // split))
    smem = split_smem(g, d, esz, split, scaled)
    if smem > SMEM_LIMIT:
        raise ValueError(f"decode kernels: a split of {split} positions "
                         f"(page {page}, D={d}, {dtype}) needs {smem} B of "
                         f"shared memory (at most {SMEM_LIMIT})")
    return DecodePlan(split, splits, DECODE_THREADS, smem,
                      b * hkv * splits * g * (d + 2))


def _check_query(name, q, k, v, hkv, k_scale=None, v_scale=None):
    """Shared validation: a CUDA one-token query against K/V of q's dtype
    (or int8 with bf16 scales) and head_dim, in a GQA grouping."""
    if q.device.type != "cuda":
        raise ValueError(f"{name} kernel needs CUDA tensors, got {q.device}")
    b, t, hq, dh = q.shape
    if t != 1 or k.shape[-1] != dh or v.shape != k.shape:
        raise ValueError(f"{name} kernel: q {tuple(q.shape)} and K/V "
                         f"{tuple(k.shape)}/{tuple(v.shape)} are not a "
                         "one-token decode over equal K/V")
    check_kv_dtypes(name, q, k, v, k_scale, v_scale)
    if hq % hkv or dh not in SUPPORTED_HEAD_DIMS or hq // hkv > MAX_GROUP:
        raise ValueError(f"{name} kernel: Hq={hq}, Hkv={hkv}, D={dh} not "
                         f"supported (D in {SUPPORTED_HEAD_DIMS}, G <= "
                         f"{MAX_GROUP})")
    return b, hq, dh, hq // hkv


def _check_aligned(name, k, v, strides=(0,)):
    """The kernels copy K/V rows as 16-byte vectors: both base addresses,
    and every stride of a position, head or row (in elements), must keep
    16-byte alignment (the strides' low bits, scaled by the element size, OR
    together)."""
    low = 0
    for stride in strides:
        low |= stride
    if (k.data_ptr() | v.data_ptr()) % 16 or low * k.element_size() % 16:
        raise ValueError(f"{name} kernel: K/V at {k.data_ptr() % 16} / "
                         f"{v.data_ptr() % 16} bytes past 16 with strides "
                         f"{tuple(strides)} (need 16-byte aligned rows)")


def _vlen(kv_valid_len, device, b):
    """kv_valid_len as int32 [B] on the card; the serving path's own
    (already so) passes through without a copy."""
    if isinstance(kv_valid_len, torch.Tensor) \
            and kv_valid_len.dtype == torch.int32 \
            and kv_valid_len.shape == (b,) and kv_valid_len.device == device:
        return kv_valid_len.contiguous()
    return torch.as_tensor(kv_valid_len, device=device).to(
        torch.int32).expand(b).contiguous()


def prepare_paged(q, k_pool, v_pool, block_tables, kv_valid_len, *,
                  k_scale_pool=None, v_scale_pool=None):
    """Validate CUDA operands of the paged kernel, plan the split and
    allocate the output and the workspace.  With ``k_scale_pool``/
    ``v_scale_pool`` [P, Hkv, BS] (bf16, passed by their strides) the pools
    are int8 and the int8 form launches.  Returns (launch arguments, out
    [B, 1, Hq, D]); :func:`launch` fills ``out``.  Raises on another
    device, dtype, shape or alignment the kernels do not take."""
    if k_pool.dim() != 4:
        raise ValueError(f"flash_decode_paged kernel: pools "
                         f"{tuple(k_pool.shape)} are not [P, Hkv, BS, D]")
    hkv, bs = k_pool.shape[1], k_pool.shape[2]
    b, hq, dh, g = _check_query("flash_decode_paged", q, k_pool, v_pool, hkv,
                                k_scale_pool, v_scale_pool)
    code = build.dtype_code(q)
    dev = q.device
    qc = q.contiguous()
    kc, vc = k_pool.contiguous(), v_pool.contiguous()
    _check_aligned("flash_decode_paged", kc, vc)
    tables = block_tables.to(device=dev, dtype=torch.int32).contiguous()
    m = tables.shape[1]
    plan = decode_plan(b, hkv, g, dh, m * bs, bs, kc.dtype,
                       build.sm_count(dev))
    out = torch.empty_like(qc)
    work = torch.empty(plan.workspace, dtype=torch.float32, device=dev)
    geometry = (code, b, hq, hkv, bs, dh, m, plan.split, plan.splits)
    vlen = _vlen(kv_valid_len, dev, b)
    if k_scale_pool is None:
        args = ("flash_decode_paged", qc, kc, vc, tables, vlen, out, work,
                build.tickets(dev, b * hkv), *geometry, float(dh ** -0.5))
    else:
        args = ("flash_decode_paged_int8", qc, kc, vc, k_scale_pool,
                v_scale_pool, tables, vlen, out, work,
                build.tickets(dev, b * hkv), *geometry,
                *k_scale_pool.stride(), float(dh ** -0.5))
    return args, out


def prepare(q, k_cache, v_cache, kv_valid_len, *, k_scale=None,
            v_scale=None):
    """Validate CUDA operands of the contiguous kernel, plan the split and
    allocate the output and the workspace.  The caches [B, S, Hkv, D] are
    passed by their strides (the last must be 1, K and V must share them,
    and rows must be 16-byte aligned), never copied; so are int8 caches'
    ``k_scale``/``v_scale`` [B, S, Hkv] (bf16), which select the int8
    form.  Returns (launch arguments, out [B, 1, Hq, D]); :func:`launch`
    fills ``out``."""
    if k_cache.dim() != 4:
        raise ValueError(f"flash_decode kernel: caches {tuple(k_cache.shape)} "
                         "are not [B, S, Hkv, D]")
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    b, hq, dh, g = _check_query("flash_decode", q, k_cache, v_cache, hkv,
                                k_scale, v_scale)
    if k_cache.shape[0] != b or k_cache.stride(-1) != 1 \
            or k_cache.stride() != v_cache.stride():
        raise ValueError(f"flash_decode kernel: caches {tuple(k_cache.shape)} "
                         f"with strides {k_cache.stride()}/{v_cache.stride()} "
                         f"for {b} rows (need unit last stride, equal K/V "
                         "strides)")
    sb, ss, sh, _ = k_cache.stride()
    _check_aligned("flash_decode", k_cache, v_cache, (sb, ss, sh))
    code = build.dtype_code(q)
    dev = q.device
    qc = q.contiguous()
    plan = decode_plan(b, hkv, g, dh, s, CONTIGUOUS_TILE, k_cache.dtype,
                       build.sm_count(dev))
    out = torch.empty_like(qc)
    work = torch.empty(plan.workspace, dtype=torch.float32, device=dev)
    geometry = (code, b, hq, hkv, s, dh, plan.split, plan.splits, sb, ss, sh)
    vlen = _vlen(kv_valid_len, dev, b)
    if k_scale is None:
        args = ("flash_decode", qc, k_cache, v_cache, vlen, out, work,
                build.tickets(dev, b * hkv), *geometry, float(dh ** -0.5))
    else:
        args = ("flash_decode_int8", qc, k_cache, v_cache, k_scale, v_scale,
                vlen, out, work, build.tickets(dev, b * hkv), *geometry,
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
