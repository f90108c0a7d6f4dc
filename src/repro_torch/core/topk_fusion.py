"""Softmax + TopK (Algorithm 4 of the paper): the plain PyTorch form and the
Gumbel-max pick that serving samples with.

Port of ``src/repro/core/topk_fusion.py`` (``SoftmaxTopK`` at line 26,
``softmax_topk`` at 33, ``safe_softmax_then_topk`` at 84, ``gumbel_pick``
at 93, ``topk_sample`` at 105).
``softmax_topk`` is the plain version behind the fused CUDA kernel
``kernels/csrc/softmax_topk.cu``; ``topk_sample`` reaches that kernel (or
this plain version, on the CPU) through ``kernels.dispatch``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.online_softmax import online_normalizer, safe_softmax

Tensor = torch.Tensor


class SoftmaxTopK(NamedTuple):
    """Result of the fused computation (paper Eq. (5) applied to softmax(x))."""
    values: Tensor      # top-k softmax probabilities, descending
    indices: Tensor     # their indices in x (int64 here, int32 from the kernel)
    logsumexp: Tensor   # m + log d — the paper's (m_V, d_V) in log form


def topk_lowest_index(x: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """Top-k over the last axis with exact ties going to the lowest index,
    as ``lax.top_k`` orders them (``torch.topk`` does not promise an order
    among equal values).  A stable descending sort keeps equal values in
    index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def softmax_topk(x: Tensor, k: int) -> SoftmaxTopK:
    """Softmax+top-k over the last axis: (m, d) from one reduction, the top-k
    from the logits, probabilities ``exp(u - m) / d`` for the k survivors."""
    k = min(k, x.shape[-1])
    m, d = online_normalizer(x, dim=-1)
    vals, idx = topk_lowest_index(x, k)
    probs = torch.exp(vals.to(m.dtype) - m[..., None]) / d[..., None]
    return SoftmaxTopK(probs.to(x.dtype), idx, m + torch.log(d))


def safe_softmax_then_topk(x: Tensor, k: int) -> SoftmaxTopK:
    """The paper's unfused baseline: full safe softmax, then top-k (5
    accesses per element, §4)."""
    y = safe_softmax(x)
    vals, idx = topk_lowest_index(y, min(k, x.shape[-1]))
    m, d = online_normalizer(x, dim=-1)
    return SoftmaxTopK(vals, idx, m + torch.log(d))


def gumbel_pick(out: SoftmaxTopK, g: Tensor) -> Tensor:
    """Sample ∝ p_i from the K retained probs via Gumbel-max on log p.

    ``g`` is Gumbel noise shaped like ``out.values``; each row gets its own,
    so a row's token depends only on its logits and its noise.  Ties in
    ``argmax`` go to the first index, as ``jnp.argmax`` does."""
    logp = torch.log(torch.clamp(out.values.float(), min=1e-30))
    choice = torch.argmax(logp + g.to(logp.device, torch.float32), dim=-1)
    return torch.gather(out.indices, -1, choice[..., None])[..., 0]


def gumbel_noise(shape, generator: torch.Generator) -> Tensor:
    """Standard Gumbel draws: ``-log(E)`` with ``E ~ Exp(1)``, from an
    explicit generator (on the generator's device)."""
    e = torch.empty(shape, dtype=torch.float32, device=generator.device)
    return -torch.log(e.exponential_(generator=generator))


def topk_sample(x: Tensor, k: int, *, noise: Optional[Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> tuple[Tensor, Tensor]:
    """Sample a token per row from the fused top-k softmax (the serving
    fast path, paper §4): one pass over the vocabulary through
    ``dispatch.softmax_topk``, then Gumbel-max over the K survivors.
    Returns ``(token_ids, top_probs)``.

    The Gumbels are explicit: ``noise`` shaped like the top-k values (a
    test injects the reference's ``jax.random.gumbel`` draw here), or drawn
    from ``generator``.  ``jax.random`` keys are not reproduced."""
    from repro_torch.kernels import dispatch
    out = dispatch.softmax_topk(x, k)
    if noise is None:
        if generator is None:
            raise ValueError("topk_sample needs its Gumbels: pass noise or "
                             "a generator")
        noise = gumbel_noise(tuple(out.values.shape), generator)
    return gumbel_pick(out, noise), out.values
