"""Fused softmax + top-k (paper Algorithm 4): the CUDA kernel's wrapper and
its plain PyTorch version.

Replaces ``src/repro/kernels/softmax_topk.py:softmax_topk_pallas`` (the
``pallas_call`` at line 100).  The kernel (``csrc/softmax_topk.cu``) runs in
two phases — per-(row, V-slice) partials of ``(m, d, top-k)``, then one
⊕-merge per row — and returns ``(vals [R, k] in x's dtype, idx [R, k] int32,
lse [R] float32)`` like the Pallas kernel, ties to the lowest index.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.topk_fusion import SoftmaxTopK
from repro_torch.core.topk_fusion import softmax_topk as _softmax_topk_core
from repro_torch.kernels import build

SLICE = 4096          # V-slice of one phase-one CTA
MAX_K = 32            # the register top-k list holds at most this many
_MAX_CANDIDATES = 6144  # S * k candidates in phase two's 48 KB of shared memory

#: Kernel launches since the last reset (the serving path's proof of route).
launches = {"softmax_topk": 0}

_C = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_C, _I, _I, _I, _I, _I, _C, _C, _C, _C, _C, _C]


def softmax_topk_plain(x: torch.Tensor, k: int) -> SoftmaxTopK:
    """The plain PyTorch version (``core.topk_fusion.softmax_topk``)."""
    return _softmax_topk_core(x, k)


def prepare(x: torch.Tensor, k: int):
    """Validate a CUDA tensor x [..., V] (float32 or bfloat16) and allocate
    the outputs and scratch.  Returns (launch arguments, SoftmaxTopK of the
    outputs); :func:`launch` fills them.  Raises on another device, dtype,
    on k > 32 or more V-slices than phase two's shared memory holds; any
    number of rows works (rows lie on grid.x)."""
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
    s = -(-v // SLICE)
    if s * k > _MAX_CANDIDATES:
        raise ValueError(f"softmax_topk kernel: shape {tuple(x.shape)} with "
                         f"k={k} exceeds its shared-memory limit")
    vals = torch.empty((r, k), dtype=x.dtype, device=x.device)
    idx = torch.empty((r, k), dtype=torch.int32, device=x.device)
    lse = torch.empty((r,), dtype=torch.float32, device=x.device)
    part_f = torch.empty((r * s * (2 + k),), dtype=torch.float32,
                         device=x.device)
    part_i = torch.empty((r * s * k,), dtype=torch.int32, device=x.device)
    args = (x2, code, r, v, k, SLICE, vals, idx, lse, part_f, part_i)
    return args, SoftmaxTopK(vals.reshape(*lead, k), idx.reshape(*lead, k),
                             lse.reshape(lead))


def launch(args) -> None:
    """Launch the kernel on prepared arguments (counts one launch)."""
    build.call("softmax_topk", _ARGTYPES, args)
    launches["softmax_topk"] += 1


def softmax_topk(x: torch.Tensor, k: int) -> SoftmaxTopK:
    """Launch the fused kernel on a CUDA tensor x [..., V]."""
    args, out = prepare(x, k)
    launch(args)
    return out
