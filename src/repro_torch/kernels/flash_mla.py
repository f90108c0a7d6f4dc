"""Multi-head latent attention (MLA) over a latent cache: the CUDA kernels'
wrappers and their plain PyTorch versions, for the absorbed form that MLA
serving runs (``layers.mla_apply`` with a cache).

Every query head h scores ``scale·(q_eff[h]·c_j + q_rope[h]·r_j)`` against
the latent rows j of its batch row and returns ``softmax·c``: one shared
"KV head" (MQA) whose key is [c, r] (Dqk = R + Dr = 288 for minicpm3-4b)
and whose value is c itself (Dv = R = 256), at the scale
(qk_nope + qk_rope)^-0.5 the caller passes (96^-0.5, not 288^-0.5).

* ``flash_decode_mla`` (launches counted as ``flash_decode_mla``): the
  one-token decode, q_eff [B, 1, H, R] and q_rope [B, 1, H, Dr] over
  positions [0, kv_valid_len[b]) of c_cache [B, S, R] and r_cache
  [B, S, Dr].
* ``flash_attention_mla`` (``flash_attention_mla``): the cached prefill,
  T > 1 query tokens at per-row offsets ``q_offset`` [B], causal in
  absolute coordinates (key j is seen by token t when j <= q_offset[b] + t
  and j < kv_valid_len[b]).

Neither replaces a ``pallas_call``: the reference ran this attention in XLA
(``src/repro/kernels/dispatch.py:573`` sends a custom-scale decode to its
chunked fallback, ``:887`` keeps a prefill whose value dim differs from q's
off the kernel).  The port's rule that a CUDA tensor runs a kernel or
raises asks for them.  Both kernels (``csrc/flash_mla.cu``) read the caches
in place through their strides: the reference's ``k_cat = [c_cache,
r_cache]`` copied the whole latent cache per layer and step, which the
plain versions here still do.

The plain versions are the reference's arithmetic: concatenate, then
``core.online_attention`` at ``scale``.  They first zero the cache rows at
or past each row's valid length (a copy), so a poisoned (NaN) tail reads
as the kernels read it, not at all: a masked position's weight is 0, but
0 · NaN is NaN.

On the card each entry point is one launch, in one of two forms chosen by
dtype alone (no probe, no fallback): bf16 on the tensor cores (``wgmma``),
fp32 on the CUDA cores.  The decode's :func:`decode_plan` cuts [0, S) into
splits of whole tiles (64 positions for bf16, 32 for fp32), one CTA of 256
threads a (split, batch row) holding all H heads; the last live split of a
row ⊕-merges the partials behind a ticket counter from ``build.tickets``
(bf16: the weights once a (split, head), then float4 streams; fp32:
``decode_merge`` of ``csrc/attention.cuh``), and a bf16 row with one live
split writes its output at once.  The prefill's :func:`prefill_grid` gives
one CTA a 64 (bf16) or 40 (fp32) flattened (token, head) query rows of a
batch row.

What bounds them on the H100: bytes (each latent row, 288 values, is read
once a batch row and serves all 40 heads' scores and values, ~75 flops a
byte against the ~295 at which the tensor cores would bind), and at the
serving shapes the latency of a tile's copy, its products and the decode's
merge through L2.  The bf16 forms therefore do the products on the tensor
cores (S = Q·Kᵀ over k = 288 and P·V with V the same c tile read MN-major,
two warpgroups each holding O for 128 of the 256 columns), cut splits in
whole 64-key tiles so a short row is one CTA, and merge with every load
in flight at once (``csrc/flash_mla.cu`` has the layout).  The fp32 forms
are the CUDA-core kernels the fp32 parity runs hold to 1e-5.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.core.attention import DEFAULT_CHUNK, online_attention
from repro_torch.kernels import build
from repro_torch.obs import kernels as obs_kernels

#: The latent widths the kernels are built for, (R, Dr): minicpm3-4b's
#: kv_lora_rank 256 and qk_rope_head_dim 32.  Others raise.
LATENT_DIMS = (256, 32)
MAX_HEADS = 40            # query heads a decode CTA holds (fp32: 8 warps x 5)
ROWS_PER_CTA = 40         # fp32: flattened query rows a prefill CTA takes
TILE = 32                 # fp32: latent rows staged a pass, a split's unit
WGMMA_TILE = 64           # bf16: keys a stage, a split's unit, query rows
                          # a CTA (wgmma's M)
MAX_MERGE = 32            # bf16: partials (40 KB each) a merge reads at most
WAVES = 2                 # decode CTAs the grid aims for, x the SMs
THREADS = 256
DTYPES = (torch.float32, torch.bfloat16)

#: Kernel launches since the last reset (the serving path's proof of route).
launches = {"flash_decode_mla": 0, "flash_attention_mla": 0}

_C = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_DECODE_ARGTYPES = [_C] * 8 + [_I] * 5 + [_L] * 4 + [_F, _C]
_PREFILL_ARGTYPES = [_C] * 7 + [_I] * 4 + [_L] * 4 + [_I, _F, _C]
_ARGTYPES = {"flash_decode_mla": _DECODE_ARGTYPES,
             "flash_decode_mla_wgmma": _DECODE_ARGTYPES,
             "flash_attention_mla": _PREFILL_ARGTYPES,
             "flash_attention_mla_wgmma": _PREFILL_ARGTYPES}


def _zero_past(cache, kv_valid_len):
    """A copy of ``cache`` [B, S, ...] with the rows at or past each batch
    row's valid length set to 0."""
    b, s = cache.shape[:2]
    vlen = torch.as_tensor(kv_valid_len, dtype=torch.int64,
                           device=cache.device).expand(b)
    live = torch.arange(s, device=cache.device)[None, :] < vlen[:, None]
    return torch.where(live.reshape(b, s, *[1] * (cache.dim() - 2)), cache,
                       torch.zeros((), dtype=cache.dtype,
                                   device=cache.device))


def mla_plain(q_eff, q_rope, c_cache, r_cache, *, q_offset, kv_valid_len,
              scale: float, causal: bool, chunk_size: int = DEFAULT_CHUNK):
    """The reference's arithmetic (``mla_apply`` at
    ``src/repro/models/layers.py:414-425``): q_cat = [q_eff, q_rope]
    [B, T, H, R + Dr] against one shared key [c, r] [B, S, 1, R + Dr] and
    value c [B, S, 1, R], the chunked online attention at ``scale``, with
    the cache rows past ``kv_valid_len`` zeroed first.  Returns
    [B, T, H, R] in q's dtype."""
    c = _zero_past(c_cache, kv_valid_len)
    r = _zero_past(r_cache, kv_valid_len)
    q = torch.cat([q_eff, q_rope], dim=-1)
    k = torch.cat([c, r.to(c.dtype)], dim=-1)[:, :, None]
    return online_attention(q, k, c[:, :, None], causal=causal,
                            q_offset=q_offset, kv_valid_len=kv_valid_len,
                            chunk_size=chunk_size, scale=scale)


def flash_decode_mla_plain(q_eff, q_rope, c_cache, r_cache, kv_valid_len, *,
                           scale: float, chunk_size: int = DEFAULT_CHUNK):
    """The decode kernel's plain version: :func:`mla_plain` of one query
    token, no causal mask (the valid length alone bounds it)."""
    return mla_plain(q_eff, q_rope, c_cache, r_cache, q_offset=0,
                     kv_valid_len=kv_valid_len, scale=scale, causal=False,
                     chunk_size=chunk_size)


def flash_attention_mla_plain(q_eff, q_rope, c_cache, r_cache, q_offset,
                              kv_valid_len, *, scale: float,
                              causal: bool = True,
                              chunk_size: int = DEFAULT_CHUNK):
    """The prefill kernel's plain version: :func:`mla_plain` at per-row
    offsets ``q_offset``, causal in absolute coordinates."""
    return mla_plain(q_eff, q_rope, c_cache, r_cache, q_offset=q_offset,
                     kv_valid_len=kv_valid_len, scale=scale, causal=causal,
                     chunk_size=chunk_size)


class DecodePlan(NamedTuple):
    """How the MLA decode kernel cuts one call's key range."""
    split: int        # positions a split CTA takes (whole tiles)
    splits: int       # splits a batch row: grid (splits, B)
    threads: int      # threads a CTA
    workspace: int    # fp32 words of the partials: acc [B, splits, H, R]
                      # and (m, d) [B, splits, H]

    def live(self, vlen: int, max_len: int) -> int:
        """Splits a row of valid length ``vlen`` runs (the others exit)."""
        return -(-min(max(vlen, 0), max_len) // self.split)


def tile(dtype: torch.dtype) -> int:
    """A decode split's unit: 64 keys for the bf16 (tensor-core) form, 32
    for the fp32 one."""
    return WGMMA_TILE if dtype == torch.bfloat16 else TILE


@functools.lru_cache(maxsize=256)
def decode_plan(b: int, h: int, max_len: int, dtype: torch.dtype,
                sm_count: int) -> DecodePlan:
    """The split of an MLA decode call, a pure function of its shapes:
    ``b`` batch rows of ``h`` heads over caches of ``max_len`` positions
    (the host's bound; the valid lengths are never read), ``dtype`` the
    operands', on a card of ``sm_count`` SMs.  The split is the shortest
    whole number of ``tile(dtype)``-position tiles that gives ``WAVES`` x
    ``sm_count`` CTAs over (split, batch row) (for bf16 at most
    ``MAX_MERGE`` splits a row, each leaving a 40 KB partial for the
    merge), but no longer than the cache.  Raises for shapes the kernel
    does not take."""
    if dtype not in DTYPES or not 1 <= h <= MAX_HEADS \
            or not 1 <= b <= 65535 or max_len < 0 or sm_count < 1:
        raise ValueError(f"flash_decode_mla kernel: B={b}, H={h}, "
                         f"max_len={max_len}, {dtype} not supported (H <= "
                         f"{MAX_HEADS}, B <= 65535, {DTYPES})")
    unit = tile(dtype)

    def tiles(n):                       # n positions up to whole tiles
        return max(unit, -(-n // unit) * unit)

    want = -(-WAVES * sm_count // b)    # splits a row should take
    if dtype == torch.bfloat16:
        want = min(want, MAX_MERGE)
    split = min(tiles(-(-max_len // want)), tiles(max_len))
    splits = max(1, -(-max_len // split))
    r = LATENT_DIMS[0]
    return DecodePlan(split, splits, THREADS, b * splits * h * (r + 2))


class PrefillGrid(NamedTuple):
    """How the MLA prefill kernel covers one call."""
    ctas: int         # CTAs a batch row: grid (ctas, B)
    rows: int         # flattened (token, head) query rows a CTA
    threads: int      # threads a CTA


@functools.lru_cache(maxsize=256)
def prefill_grid(b: int, t: int, h: int, dtype: torch.dtype) -> PrefillGrid:
    """The grid of an MLA cached-prefill call, a pure function of its
    shapes: each of the ``b`` batch rows' ``t`` x ``h`` flattened (token,
    head) query rows in tiles of 64 (bf16: wgmma's M) or 40 (fp32), one CTA
    a tile.  Raises for shapes the kernel does not take."""
    if dtype not in DTYPES or not 1 <= b <= 65535 or t < 1 or h < 1:
        raise ValueError(f"flash_attention_mla kernel: B={b}, T={t}, H={h}, "
                         f"{dtype} not supported (B <= 65535, {DTYPES})")
    rows = WGMMA_TILE if dtype == torch.bfloat16 else ROWS_PER_CTA
    return PrefillGrid(-(-t * h // rows), rows, THREADS)


def _check(name, q_eff, q_rope, c_cache, r_cache, t_one: bool):
    """Shared validation of CUDA operands: (B, T, H, S)."""
    if q_eff.device.type != "cuda":
        raise ValueError(f"{name} kernel needs CUDA tensors, got "
                         f"{q_eff.device}")
    r_dim, dr = LATENT_DIMS
    if q_eff.dim() != 4 or c_cache.dim() != 3 or r_cache.dim() != 3:
        raise ValueError(f"{name} kernel: q_eff {tuple(q_eff.shape)}, caches "
                         f"{tuple(c_cache.shape)} / {tuple(r_cache.shape)} "
                         "are not [B, T, H, R] and [B, S, R] / [B, S, Dr]")
    b, t, h, r = q_eff.shape
    s = c_cache.shape[1]
    if q_rope.shape != (b, t, h, dr) or (r, c_cache.shape[2],
                                         r_cache.shape[2]) != (r_dim, r_dim,
                                                               dr) \
            or c_cache.shape[0] != b or r_cache.shape[:2] != (b, s) \
            or (t_one and t != 1) or (not t_one and t < 1):
        raise ValueError(f"{name} kernel: q_eff {tuple(q_eff.shape)}, q_rope "
                         f"{tuple(q_rope.shape)}, caches "
                         f"{tuple(c_cache.shape)} / {tuple(r_cache.shape)} "
                         f"(the kernel takes R={r_dim}, Dr={dr}"
                         + (", one query token)" if t_one else ")"))
    tensors = (q_eff, q_rope, c_cache, r_cache)
    if any(x.dtype != q_eff.dtype for x in tensors) \
            or q_eff.dtype not in DTYPES \
            or any(x.device != q_eff.device for x in tensors):
        raise ValueError(f"{name} kernel: dtypes "
                         f"{[str(x.dtype) for x in tensors]} on "
                         f"{[str(x.device) for x in tensors]} (need one of "
                         f"{DTYPES}, all alike, on one device)")
    esz = q_eff.element_size()
    if c_cache.stride(-1) != 1 or r_cache.stride(-1) != 1 \
            or (c_cache.data_ptr() | r_cache.data_ptr()) % 16 \
            or (c_cache.stride(0) | c_cache.stride(1) | r_cache.stride(0)
                | r_cache.stride(1)) * esz % 16:
        raise ValueError(f"{name} kernel: caches with strides "
                         f"{c_cache.stride()} / {r_cache.stride()} at "
                         f"{c_cache.data_ptr() % 16} / "
                         f"{r_cache.data_ptr() % 16} bytes past 16 (need "
                         "unit last strides and 16-byte aligned rows)")
    return b, t, h, s


def _vlen(x, device, b):
    """An int32 [B] tensor on the card; the serving path's own (already
    so) passes through without a copy."""
    if isinstance(x, torch.Tensor) and x.dtype == torch.int32 \
            and x.shape == (b,) and x.device == device:
        return x.contiguous()
    return torch.as_tensor(x, device=device).to(torch.int32).expand(
        b).contiguous()


def _strides(c_cache, r_cache):
    return (c_cache.stride(0), c_cache.stride(1), r_cache.stride(0),
            r_cache.stride(1))


def _form(name, q, q_rope, out, scale) -> str:
    """The launch name of ``name``'s form for these operands: the bf16
    tensor-core entry (which copies 16-byte chunks of q, q_rope and writes
    out in pairs: every pointer 16-byte aligned, and folds a positive scale
    into exp2) or the fp32 one.  Raises on what the bf16 form refuses."""
    if q.dtype != torch.bfloat16:
        return name
    if any(t.data_ptr() % 16 for t in (q, q_rope, out)) or not scale > 0:
        raise ValueError(f"{name} kernel (bf16): q_eff, q_rope and out must "
                         f"be 16-byte aligned and the scale positive, got "
                         f"{[t.data_ptr() % 16 for t in (q, q_rope, out)]} "
                         f"bytes past 16 and scale {scale}")
    return name + "_wgmma"


def prepare_decode(q_eff, q_rope, c_cache, r_cache, kv_valid_len, *,
                   scale: float):
    """Validate CUDA operands of the decode kernel, plan the split and
    allocate the output and the workspace.  Returns (launch arguments, out
    [B, 1, H, R]); :func:`launch` fills ``out``."""
    b, _, h, s = _check("flash_decode_mla", q_eff, q_rope, c_cache, r_cache,
                        True)
    dev = q_eff.device
    plan = decode_plan(b, h, s, q_eff.dtype, build.sm_count(dev))
    obs_kernels.record_autotune("mla_decode_plan",
                                (b, h, s, q_eff.dtype), plan)
    qc, qr = q_eff.contiguous(), q_rope.contiguous()
    out = torch.empty_like(qc)
    work = torch.empty(plan.workspace, dtype=torch.float32, device=dev)
    args = (_form("flash_decode_mla", qc, qr, out, scale), qc, qr, c_cache,
            r_cache, _vlen(kv_valid_len, dev, b), out, work,
            build.tickets(dev, b), b, h, s, plan.split, plan.splits,
            *_strides(c_cache, r_cache), float(scale))
    return args, out


def prepare_prefill(q_eff, q_rope, c_cache, r_cache, q_offset, kv_valid_len,
                    *, scale: float, causal: bool = True):
    """Validate CUDA operands of the prefill kernel and allocate the
    output.  Returns (launch arguments, out [B, T, H, R])."""
    b, t, h, s = _check("flash_attention_mla", q_eff, q_rope, c_cache,
                        r_cache, False)
    prefill_grid(b, t, h, q_eff.dtype)  # raises on what no grid covers
    dev = q_eff.device
    qc, qr = q_eff.contiguous(), q_rope.contiguous()
    out = torch.empty_like(qc)
    args = (_form("flash_attention_mla", qc, qr, out, scale), qc, qr,
            c_cache, r_cache, _vlen(q_offset, dev, b),
            _vlen(kv_valid_len, dev, b), out, b, t, h, s,
            *_strides(c_cache, r_cache), int(bool(causal)), float(scale))
    return args, out


def launch(args) -> None:
    """Launch a prepared kernel (counts one launch of it, under the entry
    point's name without its form: ``flash_decode_mla`` or
    ``flash_attention_mla``)."""
    name = args[0]
    build.call(name, _ARGTYPES[name], args[1:], source="flash_mla")
    counted = name.removesuffix("_wgmma")
    launches[counted] += 1
    obs_kernels.record_path(counted, "cuda")


def flash_decode_mla(q_eff, q_rope, c_cache, r_cache, kv_valid_len, *,
                     scale: float) -> torch.Tensor:
    """Launch the decode kernel on CUDA tensors: out [B, 1, H, R]."""
    args, out = prepare_decode(q_eff, q_rope, c_cache, r_cache, kv_valid_len,
                               scale=scale)
    launch(args)
    return out


def flash_attention_mla(q_eff, q_rope, c_cache, r_cache, q_offset,
                        kv_valid_len, *, scale: float,
                        causal: bool = True) -> torch.Tensor:
    """Launch the cached-prefill kernel on CUDA tensors: out
    [B, T, H, R]."""
    args, out = prepare_prefill(q_eff, q_rope, c_cache, r_cache, q_offset,
                                kv_valid_len, scale=scale, causal=causal)
    launch(args)
    return out
