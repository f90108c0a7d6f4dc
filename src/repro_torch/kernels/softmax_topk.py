"""Fused softmax + top-k (paper Algorithm 4): the CUDA kernel's wrapper,
its planner and its plain PyTorch version.

Replaces ``src/repro/kernels/softmax_topk.py:softmax_topk_pallas`` (the
``pallas_call`` at line 100).  The kernel (``csrc/softmax_topk.cu``) runs
in one launch: :func:`plan`, a pure function of the shapes, cuts each row
into S slices (one CTA each) so that rows × slices fill the card; a CTA
streams its slice once, keeping (m, d) and its top k, and the last CTA of a
row ⊕-merges the row's S partials in slice order behind a ticket counter
(``build.tickets``, one a 128-byte line).  Returns ``(vals [R, k] in x's
dtype, idx [R, k] int32, lse [R] float32)`` like the Pallas kernel, ties to
the lowest index.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.core.topk_fusion import SoftmaxTopK
from repro_torch.core.topk_fusion import softmax_topk as _softmax_topk_core
from repro_torch.kernels import build
from repro_torch.obs import kernels as obs_kernels

MAX_K = 32            # a warp's sorted list holds at most one entry a lane
VEC_BYTES = 16        # one vector load
WAVES = 2             # a split call aims at WAVES x the card's SMs in CTAs
MIN_SLICE_VECTORS = 128   # no slice shorter than this many 16-byte vectors
MIN_THREADS, MAX_THREADS = 64, 256
LONG_LOADS = 4        # vectors a thread loads at a time in long slices
#: The merging warp holds two slices' list heads a lane; its S·k
#: candidates (fp32 value, int32 index) then take at most 16 KB of shared
#: memory.
MAX_SLICES = 64
TICKET_STRIDE = 32    # ints between two rows' tickets (csrc kTicketStride)

#: Kernel launches since the last reset (the serving path's proof of route):
#: the MoE router's under a key of its own, every other caller's under
#: ``softmax_topk``.
launches = {"softmax_topk": 0, "softmax_topk_router": 0}

_C = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_C] + [_I] * 9 + [_C] * 7       # the stream last


class Plan(NamedTuple):
    """How the kernel takes rows of V entries."""
    slice: int        # entries of a slice (whole 16-byte vectors)
    slices: int       # S: CTAs a row (1: the CTA writes the row itself)
    threads: int      # threads a CTA
    loads: int        # 16-byte vectors a thread loads at a time (1 or 4)
    smem: int         # dynamic shared memory a CTA (the merge's lists)
    vec: int          # entries of one 16-byte vector

    @property
    def slice_vectors(self) -> int:
        return self.slice // self.vec


@functools.lru_cache(maxsize=256)
def plan(r: int, v: int, k: int, dtype: torch.dtype, sm_count: int) -> Plan:
    """The split of a call over ``r`` rows of ``v`` entries of ``dtype``
    (float32 or bfloat16), top ``k``, on a card of ``sm_count`` SMs: a pure
    function of these.

    Rows that reach ``WAVES`` × ``sm_count`` CTAs alone take one CTA each
    (S = 1: no partials, no merge), ``LONG_LOADS`` vectors a thread at a
    time over 64..256 threads.  Otherwise each row splits into slices of
    whole 16-byte vectors, the shortest that still give rows × slices ≥
    ``WAVES`` × ``sm_count`` CTAs, but no shorter than ``MIN_SLICE_VECTORS``
    vectors, in at most ``MAX_SLICES`` slices (so the S·k candidates fit
    the merging CTA's shared memory).  A slice of at most ``MAX_THREADS``
    vectors takes one vector a thread (the latency of one load and one
    selection), and a longer one is cut to that where this at most doubles
    the slices; else a thread loads ``LONG_LOADS`` at a time.  Raises for
    what the kernel does not take."""
    if dtype not in (torch.float32, torch.bfloat16) or r < 1 or v < 1 \
            or not 1 <= k <= MAX_K or sm_count < 1:
        raise ValueError(f"softmax_topk kernel: {r} rows of V={v} {dtype}, "
                         f"k={k} not supported (float32 or bfloat16, 1 <= k "
                         f"<= {MAX_K}, at least one row and entry)")
    vec = VEC_BYTES // dtype.itemsize
    nvec = -(-v // vec)
    want = -(-WAVES * sm_count // r)        # slices a row should take
    sv = nvec
    if want > 1:
        floor = max(MIN_SLICE_VECTORS, -(-nvec // MAX_SLICES))
        sv = max(-(-nvec // want), floor)
        short = max(MAX_THREADS, floor)      # one vector a thread, if it can
        if -(-nvec // short) <= 2 * -(-nvec // sv):
            sv = min(sv, short)
    slices = -(-nvec // sv)
    if slices == 1:
        sv = nvec
    loads = 1 if slices > 1 and sv <= MAX_THREADS else LONG_LOADS
    per = -(-sv // loads)
    threads = min(max(1 << max(0, (per - 1).bit_length()), MIN_THREADS),
                  MAX_THREADS)
    smem = 8 * slices * k if slices > 1 else 0
    return Plan(sv * vec, slices, threads, loads, smem, vec)


def softmax_topk_plain(x: torch.Tensor, k: int) -> SoftmaxTopK:
    """The plain PyTorch version (``core.topk_fusion.softmax_topk``)."""
    return _softmax_topk_core(x, k)


def prepare(x: torch.Tensor, k: int):
    """Validate a CUDA tensor x [..., V] (float32 or bfloat16), plan the
    split and allocate the outputs and scratch.  Returns (launch arguments,
    SoftmaxTopK of the outputs); :func:`launch` fills them.  Raises on
    another device or dtype, or on k > 32; any number of rows works (rows
    lie on grid.x)."""
    if x.device.type != "cuda":
        raise ValueError(f"softmax_topk kernel needs a CUDA tensor, got "
                         f"{x.device}")
    v = x.shape[-1]
    k = min(int(k), v)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"softmax_topk kernel takes 1 <= k <= {MAX_K} "
                         f"(got {k})")
    code = build.dtype_code(x)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, v).contiguous()
    r = x2.shape[0]
    key = (r, v, k, x.dtype, build.sm_count(x.device))
    p = plan(*key)
    obs_kernels.record_autotune("softmax_topk_plan", key, p)
    s = p.slices
    dev = x.device
    vals = torch.empty((r, k), dtype=x.dtype, device=dev)
    idx = torch.empty((r, k), dtype=torch.int32, device=dev)
    lse = torch.empty((r,), dtype=torch.float32, device=dev)
    part_f = torch.empty((r * s * (2 + k) if s > 1 else 0,),
                         dtype=torch.float32, device=dev)
    part_i = torch.empty((r * s * k if s > 1 else 0,), dtype=torch.int32,
                         device=dev)
    tickets = build.tickets(dev, r * TICKET_STRIDE) if s > 1 else part_i
    args = (x2, code, r, v, k, s, p.slice_vectors, p.threads, p.loads,
            p.smem, vals, idx, lse, part_f, part_i, tickets)
    return args, SoftmaxTopK(vals.reshape(*lead, k), idx.reshape(*lead, k),
                             lse.reshape(lead))


def launch(args, counter: str = "softmax_topk") -> None:
    """Launch the kernel on prepared arguments (counts one launch under
    ``counter``, a key of :data:`launches`)."""
    build.call("softmax_topk", _ARGTYPES, args)
    launches[counter] += 1
    obs_kernels.record_path(counter, "cuda")


def softmax_topk(x: torch.Tensor, k: int,
                 counter: str = "softmax_topk") -> SoftmaxTopK:
    """Launch the fused kernel on a CUDA tensor x [..., V], counted under
    ``counter``."""
    args, out = prepare(x, k)
    launch(args, counter)
    return out
