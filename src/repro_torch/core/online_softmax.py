"""Online normalizer calculation for softmax (Milakov & Gimelshein, 2018):
the ``(m, d)`` running statistics and their ``⊕`` merge, in PyTorch.

Port of ``src/repro/core/online_softmax.py`` (``_rescale``/``combine`` at
lines 38-57, ``online_normalizer`` at 88, ``safe_softmax`` at 164).  The
identity of ``⊕`` is ``(-inf, 0)``; ``exp(-inf - -inf)`` is NaN in IEEE
arithmetic, so the rescale factor is pinned to 1 wherever ``m_old == m_new``.
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


def safe_softmax(x: Tensor, *, dim: int = -1) -> Tensor:
    """Algorithm 2 — three passes (max, sum, normalize)."""
    xf = _f32(x)
    m = xf.amax(dim=dim, keepdim=True)
    e = torch.exp(xf - m)
    return (e / e.sum(dim=dim, keepdim=True)).to(x.dtype)
