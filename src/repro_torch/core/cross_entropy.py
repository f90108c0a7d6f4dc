"""Vocabulary-chunked online cross-entropy: the port of
``src/repro/core/cross_entropy.py``.

``loss_i = lse(h_i · W) − (h_i · W)[label_i]``.  The log-sum-exp streams the
vocabulary in chunks with the paper's online normaliser: a chunk's logits
are produced, folded into the running ``(m, d)`` with ⊕, and dropped, so the
[tokens × vocab] logit tensor never exists.  The backward re-streams the
chunks from the saved lse (the reference's custom VJP, lines 27-108, here a
``torch.autograd.Function``).  The chunk products are ``torch.matmul`` in
fp32, as the reference left them to XLA outside any kernel.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor
NEG_INF = float("-inf")


def _fwd_impl(hidden: Tensor, w: Tensor, labels: Tensor, num_chunks: int,
              z_loss: float):
    t = hidden.shape[0]
    c = w.shape[1] // num_chunks
    hf = hidden.float()
    m_run = torch.full((t,), NEG_INF, device=hidden.device)
    d_run = torch.zeros((t,), device=hidden.device)
    label_logit = torch.zeros((t,), device=hidden.device)
    for i in range(num_chunks):
        logits = hf @ w[:, i * c:(i + 1) * c].float()        # [T, c] transient
        # ⊕ fold (Algorithm 3, chunk-granular)
        m_new = torch.maximum(m_run, logits.amax(dim=-1))
        alpha = torch.exp(torch.where(m_run == m_new, torch.zeros_like(m_run),
                                      m_run - m_new))
        d_run = d_run * alpha + torch.exp(logits - m_new[:, None]).sum(-1)
        m_run = m_new
        # pick out the label logit if it lives in this chunk
        local = labels - i * c
        in_chunk = (local >= 0) & (local < c)
        picked = logits.gather(1, local.clamp(0, c - 1)[:, None])[:, 0]
        label_logit = torch.where(in_chunk, picked, label_logit)
    lse = m_run + torch.log(d_run)
    loss = lse - label_logit
    if z_loss:
        loss = loss + z_loss * lse.square()
    return loss, lse


class ChunkedSoftmaxXent(torch.autograd.Function):
    """Per-token CE loss [T] from hidden [T, D], head W [D, V], labels [T];
    the backward recomputes each chunk's softmax from the saved lse."""

    @staticmethod
    def forward(ctx, hidden, w, labels, num_chunks, z_loss):
        loss, lse = _fwd_impl(hidden, w, labels, num_chunks, z_loss)
        ctx.save_for_backward(hidden, w, labels, lse)
        ctx.num_chunks, ctx.z_loss = num_chunks, z_loss
        return loss

    @staticmethod
    def backward(ctx, dloss):
        hidden, w, labels, lse = ctx.saved_tensors
        z_loss = ctx.z_loss
        t, d = hidden.shape
        v = w.shape[1]
        c = v // ctx.num_chunks
        hf = hidden.float()
        dloss = dloss.float()
        # d loss_i / d logits_ij = softmax_ij − onehot(label)_ij (+ z-loss)
        zcoef = (1.0 + 2.0 * z_loss * lse) * dloss if z_loss else dloss
        rows = torch.arange(t, device=hidden.device)
        dh = torch.zeros((t, d), device=hidden.device)
        dw = torch.empty((d, v), device=hidden.device)
        for i in range(ctx.num_chunks):
            wc = w[:, i * c:(i + 1) * c].float()
            p = torch.exp(hf @ wc - lse[:, None])
            local = labels - i * c
            in_chunk = (local >= 0) & (local < c)
            onehot = torch.zeros_like(p)
            onehot[rows[in_chunk], local[in_chunk]] = 1.0
            dlogits = p * zcoef[:, None] - onehot * dloss[:, None]
            dh = dh + dlogits @ wc.T
            dw[:, i * c:(i + 1) * c] = hf.T @ dlogits
        return dh.to(hidden.dtype), dw.to(w.dtype), None, None, None


def chunked_cross_entropy(hidden: Tensor, w: Tensor, labels: Tensor, *,
                          num_chunks: int = 8, z_loss: float = 0.0) -> Tensor:
    """Per-token CE loss [T] from hidden [T, D], head W [D, V], labels [T].

    ``num_chunks`` is the vocab-streaming factor; V % num_chunks == 0 is
    required (configs guarantee it)."""
    assert w.shape[1] % num_chunks == 0, (tuple(w.shape), num_chunks)
    return ChunkedSoftmaxXent.apply(hidden, w, labels.long(), num_chunks,
                                    z_loss)


def full_cross_entropy(hidden: Tensor, w: Tensor, labels: Tensor, *,
                       z_loss: float = 0.0) -> Tensor:
    """The baseline that materializes all logits; autograd differentiates
    it."""
    logits = hidden.float() @ w.float()
    lse = torch.logsumexp(logits, dim=-1)
    loss = lse - logits.gather(1, labels.long()[:, None])[:, 0]
    if z_loss:
        loss = loss + z_loss * lse.square()
    return loss
