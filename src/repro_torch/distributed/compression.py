"""Gradient compression: the port of ``src/repro/distributed/compression.py``
(``cast_grads`` at line 31, the int8 error-feedback forms at 41-96,
``int8_allreduce`` at 102-118).

1. **Reduced-precision reduction** (default bf16): gradients are cast to
   ``grad_reduce_dtype`` at the autodiff boundary, so the data-parallel
   all-reduce (``training/train_step.py``) moves half the bytes.  The train
   step casts even on one device, as the reference's does
   (``train_step.py:61``), so one device rounds the gradients as many do.
2. **int8 error-feedback compression** (opt-in, as in the reference): a
   per-tensor scale, values rounded half to even (``torch.round``, as
   ``jnp.round``) and clipped to ±127, and a persistent fp32 residual fed
   back into the next step.  ``int8_allreduce`` is the wire form over a
   process group: quantize locally, ``all_gather`` the int8 tensor and the
   fp32 scales, dequantize and average.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import tree

PyTree = Any


def cast_grads(grads: PyTree, dtype) -> PyTree:
    """``grads`` cast to ``dtype`` ("bfloat16", "float16"); float32 (or
    None) leaves them as they are."""
    if dtype in ("float32", "fp32", None):
        return grads
    dt = getattr(torch, dtype)
    return tree.map(lambda g: g.to(dt), grads)


# ---------------------------------------------------------------------------
# int8 error-feedback quantization.
# ---------------------------------------------------------------------------
def ef_init(params: PyTree) -> PyTree:
    """Zero error-feedback residuals shaped like the grads (fp32)."""
    return tree.map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _quantize(x: torch.Tensor):
    """(int8 values, fp32 scale): scale = max(max|x|, 1e-12) / 127."""
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_compress(grads: PyTree, errors: PyTree):
    """Quantize (grad + carried error); return (q, scales, new_errors),
    three trees like ``grads``."""
    qs, scales, new_err = [], [], []
    for g, e in zip(tree.leaves(grads), tree.leaves(errors)):
        x = g.float() + e
        q, scale = _quantize(x)
        qs.append(q)
        scales.append(scale)
        new_err.append(x - _dequantize(q, scale))
    return (tree.unflatten(grads, qs), tree.unflatten(grads, scales),
            tree.unflatten(grads, new_err))


def ef_decompress(qs: PyTree, scales: PyTree) -> PyTree:
    return tree.map(_dequantize, qs, scales)


def ef_roundtrip(grads: PyTree, errors: PyTree):
    """Compress → transport → decompress with error feedback, in place of
    the wire.  Returns (dequantized grads, new error state)."""
    qs, scales, new_err = ef_compress(grads, errors)
    return ef_decompress(qs, scales), new_err


# ---------------------------------------------------------------------------
# int8 all-reduce over a process group.
# ---------------------------------------------------------------------------
def int8_allreduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """Mean of ``x`` over the ranks of ``group`` with an int8 wire format:
    quantize locally, ``all_gather`` the int8 tensor and the fp32 scale,
    dequantize every rank's and average (in rank order)."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    q, scale = _quantize(x.float())
    qs = [torch.empty_like(q) for _ in range(n)]
    ss = [torch.empty_like(scale) for _ in range(n)]
    dist.all_gather(qs, q, group=group)        # int8 on the wire
    dist.all_gather(ss, scale.reshape(()), group=group)
    deq = torch.stack(qs).float() * torch.stack(ss).reshape(
        (-1,) + (1,) * x.dim())
    return deq.mean(dim=0)
