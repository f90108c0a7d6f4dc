"""Public library entry points of the port's kernels.

Port of ``src/repro/kernels/ops.py`` for the online softmax:
``online_softmax`` (line 66), ``online_normalizer`` (79) and the
differentiable ``softmax_topk`` (its custom VJP ``_softmax_topk2d``,
96-129), plus ``OnlineSoftmax``, the online softmax with a backward, which
``dispatch.online_softmax`` runs for a requires-grad CUDA input.  Each
takes any leading shape and works over the last axis.  The device picks
the route (``kernels.dispatch``): CUDA launches the kernel, the CPU runs
its plain version.

The reference's tile arguments (``r_blk``, ``v_blk``) and its autotuned
vocab block have no counterpart: they size TPU VMEM tiles, and the Hopper
kernels take whole rows.
"""
from __future__ import annotations

import torch

from repro_torch.core.topk_fusion import SoftmaxTopK
from repro_torch.kernels import dispatch


def online_softmax(x: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis, the exact online form (Algorithm 3)."""
    return dispatch.online_softmax(x, form="exact")


def online_normalizer(x: torch.Tensor):
    """(m, d) over the last axis, float32 (Algorithm 3 lines 1-6)."""
    return dispatch.online_normalizer(x)


class OnlineSoftmax(torch.autograd.Function):
    """``OnlineSoftmax.apply(x, form)``: the online softmax of x [..., V]
    in ``form`` with the softmax's backward.  The forward is the form's
    kernel on CUDA and its plain version on the CPU (``dispatch``'s device
    route, with grad off inside the forward) and saves y; the backward is
    dx = y ⊙ (g − Σ g·y) over the last axis, elementwise plus a row sum in
    plain PyTorch, in fp32 (fp64 for fp64 inputs)."""

    @staticmethod
    def forward(ctx, x, form="exact"):
        y = dispatch.online_softmax(x, form=form)
        ctx.dtype = x.dtype
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        y, = ctx.saved_tensors
        f = torch.promote_types(y.dtype, torch.float32)
        yf, gf = y.to(f), g.to(f)
        dx = yf * (gf - (gf * yf).sum(dim=-1, keepdim=True))
        return dx.to(ctx.dtype), None


class _SoftmaxTopK2d(torch.autograd.Function):
    """Fused softmax+top-k of x [R, V] with the reference's recompute-from-
    lse backward: the forward saves (x, values, indices, lse) and never
    stores the [R, V] softmax."""

    @staticmethod
    def forward(ctx, x, k, counter):
        vals, idx, lse = dispatch.softmax_topk(x, k, counter=counter)
        ctx.save_for_backward(x, vals, idx, lse)
        ctx.mark_non_differentiable(idx)
        return vals, idx, lse

    @staticmethod
    def backward(ctx, dvals, _didx, dlse):
        """∂/∂x of (values, lse): values_i = e^{x_{p_i} − lse},
        lse = logsumexp, so dx_j = softmax_j · (dlse − Σᵢ dvalᵢ·valᵢ) +
        [j = pᵢ]·dvalᵢ·valᵢ, with the softmax recomputed from the saved
        lse in one extra pass over x."""
        x, vals, idx, lse = ctx.saved_tensors
        s = torch.exp(x.float() - lse[:, None])                    # [R, V]
        dv_v = dvals.float() * vals.float()                        # [R, K]
        coeff = dlse.float() - dv_v.sum(dim=-1)                    # [R]
        dx = s * coeff[:, None]
        dx.scatter_add_(1, idx.long(), dv_v)
        return dx.to(x.dtype), None, None


def softmax_topk(x: torch.Tensor, k: int,
                 counter: str = "softmax_topk") -> SoftmaxTopK:
    """Fused softmax+top-k (Algorithm 4), differentiable in x through
    ``values`` and ``logsumexp``; its launch counted under ``counter``."""
    lead = x.shape[:-1]
    v = x.shape[-1]
    vals, idx, lse = _SoftmaxTopK2d.apply(x.reshape(-1, v), k, counter)
    kk = vals.shape[-1]
    return SoftmaxTopK(vals.reshape(*lead, kk), idx.reshape(*lead, kk),
                       lse.reshape(lead))
