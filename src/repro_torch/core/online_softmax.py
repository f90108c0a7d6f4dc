"""Online normalizer calculation for softmax (Milakov & Gimelshein, 2018):
the ``(m, d)`` running statistics and their ``⊕`` merge, in PyTorch.

Port of ``src/repro/core/online_softmax.py``: ``_rescale``/``combine``
(lines 38-55), ``identity_like`` (58), ``online_normalizer_scan`` (66, the
literal loop of Algorithm 3 lines 1-6), ``online_normalizer`` (88),
``online_normalizer_blocked`` (106), ``online_logsumexp`` (130),
``online_softmax`` (135), ``online_log_softmax`` (148), ``naive_softmax``
(157), ``safe_softmax`` (164) and ``ACCESSES_PER_ELEMENT`` (176).  The
reference's ``jit_online_softmax`` has no counterpart: PyTorch runs eagerly.

The identity of ``⊕`` is ``(-inf, 0)``; ``exp(-inf - -inf)`` is NaN in IEEE
arithmetic, so the rescale factor is pinned to 1 wherever ``m_old == m_new``,
and fully masked rows give ``d = 0`` and a softmax of 0, not NaN.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

Tensor = torch.Tensor
MD = Tuple[Tensor, Tensor]

NEG_INF = float("-inf")


def _f32(x: Tensor) -> Tensor:
    """Promote to at least float32 (float64 stays float64)."""
    return x if x.dtype == torch.float64 else x.float()


def _rescale(m_old: Tensor, m_new: Tensor) -> Tensor:
    """exp(m_old - m_new) with the -inf/-inf collision pinned to 1."""
    return torch.exp(torch.where(m_old == m_new, torch.zeros_like(m_old),
                                 m_old - m_new))


def combine(a: MD, b: MD) -> MD:
    """The paper's Eq. (4) ``⊕`` operator.

    (m_a, d_a) ⊕ (m_b, d_b) = (max(m_a, m_b), d_a·e^{m_a−m} + d_b·e^{m_b−m})
    """
    m_a, d_a = a
    m_b, d_b = b
    m = torch.maximum(m_a, m_b)
    d = d_a * _rescale(m_a, m) + d_b * _rescale(m_b, m)
    return m, d


def identity_like(shape, dtype=torch.float32, device=None) -> MD:
    """The ``⊕`` identity element, broadcast to ``shape``."""
    return (torch.full(shape, NEG_INF, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def online_normalizer_scan(x: Tensor) -> MD:
    """Sequential single-pass (m, d) over the last axis: Algorithm 3
    verbatim, one element at a time (the executable specification)."""
    xf = _f32(x)
    m, d = identity_like(xf.shape[:-1], dtype=xf.dtype, device=xf.device)
    for j in range(xf.shape[-1]):
        x_j = xf[..., j]
        m_j = torch.maximum(m, x_j)                                # line 4
        d = d * _rescale(m, m_j) + torch.exp(x_j - m_j)            # line 5
        m = m_j
    return m, d


def online_normalizer(x: Tensor, *, dim: int = -1,
                      where: Optional[Tensor] = None) -> MD:
    """(m, d) = (max x, Σ e^{x−m}) over ``dim``.  ``where`` masks elements
    out of both statistics (they behave as the ⊕ identity)."""
    xf = _f32(x)
    if where is not None:
        xf = xf.masked_fill(~where, NEG_INF)
    m = xf.amax(dim=dim)
    shifted = xf - m.unsqueeze(dim)
    e = torch.where(torch.isneginf(xf), torch.zeros_like(xf),
                    torch.exp(shifted))
    return m, e.sum(dim=dim)


def online_normalizer_blocked(x: Tensor, *, block: int, dim: int = -1) -> MD:
    """Explicit tiled ⊕ evaluation: reduce each block of ``block`` entries
    (the tail padded with -inf), then ⊕-merge the blocks."""
    x = torch.movedim(x, dim, -1)
    pad = -x.shape[-1] % block
    if pad:
        x = torch.nn.functional.pad(x, (0, pad), value=NEG_INF)
    xb = x.reshape(*x.shape[:-1], x.shape[-1] // block, block)
    m_b, d_b = online_normalizer(xb, dim=-1)        # per-block stats
    m = m_b.amax(dim=-1)
    d = (d_b * _rescale(m_b, m[..., None])).sum(dim=-1)
    return m, d


def online_logsumexp(x: Tensor, *, dim: int = -1,
                     where: Optional[Tensor] = None) -> Tensor:
    m, d = online_normalizer(x, dim=dim, where=where)
    return m + torch.log(d)


def online_softmax(x: Tensor, *, dim: int = -1,
                   where: Optional[Tensor] = None) -> Tensor:
    """Safe softmax computed with the online normalizer; a row with no
    unmasked finite entry gives 0 (d = 0), not NaN."""
    m, d = online_normalizer(x, dim=dim, where=where)
    xf = x.to(m.dtype)
    if where is not None:
        xf = xf.masked_fill(~where, NEG_INF)
    e = torch.where(torch.isneginf(xf), torch.zeros_like(xf),
                    torch.exp(xf - m.unsqueeze(dim)))
    denom = torch.where(d == 0, torch.ones_like(d), d).unsqueeze(dim)
    y = e / denom
    return y.to(x.dtype) if x.is_floating_point() else y


def online_log_softmax(x: Tensor, *, dim: int = -1) -> Tensor:
    lse = online_logsumexp(x, dim=dim)
    return (x.to(lse.dtype) - lse.unsqueeze(dim)).to(x.dtype)


def naive_softmax(x: Tensor, *, dim: int = -1) -> Tensor:
    """Algorithm 1 — two passes, numerically unsafe (overflow for x >~ 88)."""
    e = torch.exp(_f32(x))
    return (e / e.sum(dim=dim, keepdim=True)).to(x.dtype)


def safe_softmax(x: Tensor, *, dim: int = -1) -> Tensor:
    """Algorithm 2 — three passes (max, sum, normalize)."""
    xf = _f32(x)
    m = xf.amax(dim=dim, keepdim=True)
    e = torch.exp(xf - m)
    return (e / e.sum(dim=dim, keepdim=True)).to(x.dtype)


#: Loads + stores per input element, from the paper's own accounting
#: (§2-§4); ``chip_smoke.py`` sets the card's effective accesses per element
#: beside the online and safe entries.
ACCESSES_PER_ELEMENT = {
    "naive_softmax": 3,        # 2 loads + 1 store   (§2)
    "safe_softmax": 4,         # 3 loads + 1 store   (§2)
    "online_softmax": 3,       # 2 loads + 1 store   (§3)
    "safe_softmax_topk_unfused": 5,   # §4: safe softmax (4) + topk load (1)
    "online_softmax_topk_unfused": 4,  # §4
    "safe_softmax_topk_fused": 2,     # max pass + fused (d, topk) pass
    "online_softmax_topk_fused": 1,   # §4: single pass, Algorithm 4
}
