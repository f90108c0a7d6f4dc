"""Vocabulary-chunked online cross-entropy: the port of
``src/repro/core/cross_entropy.py``.

``loss_i = lse(h_i · W) − (h_i · W)[label_i]``.  The log-sum-exp streams the
vocabulary in chunks with the paper's online normaliser: a chunk's logits
are produced, folded into the running ``(m, d)`` with ⊕, and dropped, so the
[tokens × vocab] logit tensor never exists.  The backward re-streams the
chunks from the saved lse (the reference's custom VJP, lines 27-108, here a
``torch.autograd.Function``).  The chunk products are ``torch.matmul`` in
fp32, as the reference left them to XLA outside any kernel.

Under a vocabulary-sharded head (the model axis, ``distributed/
tensor_parallel.py``) each rank folds its own columns into ``(m_r, d_r)``
and its label logit, and the ⊕ merges the partials across ranks: a MAX and
two SUM all-reduces over [T]-sized statistics, the cross-device form of
Algorithm 3 that the reference leaves to XLA (its lines 11-13).
``merge_vocab_partials`` is that ⊕ over partials stacked [M, T] in one
process; ``vocab_parallel_cross_entropy`` its collective form.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor
NEG_INF = float("-inf")


def _rescale(m_old: Tensor, m_new: Tensor) -> Tensor:
    """exp(m_old − m_new), 1 where they are equal (so −inf gives no NaN)."""
    return torch.exp(torch.where(m_old == m_new, torch.zeros_like(m_old),
                                 m_old - m_new))


def vocab_shard_stats(hidden: Tensor, w: Tensor, labels: Tensor,
                      num_chunks: int):
    """Fold the columns of ``w`` [D, V'] chunk by chunk into the running
    ``(m, d)`` of hidden [T, D]'s logits, and pick each token's label logit
    where ``labels`` [T] (relative to column 0 of ``w``) falls among them,
    0 elsewhere.  Returns (m, d, label_logit), each [T] fp32."""
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
        d_run = d_run * _rescale(m_run, m_new) + torch.exp(
            logits - m_new[:, None]).sum(-1)
        m_run = m_new
        # pick out the label logit if it lives in this chunk
        local = labels - i * c
        in_chunk = (local >= 0) & (local < c)
        picked = logits.gather(1, local.clamp(0, c - 1)[:, None])[:, 0]
        label_logit = torch.where(in_chunk, picked, label_logit)
    return m_run, d_run, label_logit


def _loss(lse: Tensor, label_logit: Tensor, z_loss: float) -> Tensor:
    loss = lse - label_logit
    if z_loss:
        loss = loss + z_loss * lse.square()
    return loss


def _fwd_impl(hidden: Tensor, w: Tensor, labels: Tensor, num_chunks: int,
              z_loss: float):
    m, d, label_logit = vocab_shard_stats(hidden, w, labels, num_chunks)
    lse = m + torch.log(d)
    return _loss(lse, label_logit, z_loss), lse


def merge_vocab_partials(m: Tensor, d: Tensor, label_logit: Tensor):
    """The ⊕ of M vocabulary shards' statistics stacked [M, T]: (lse [T],
    label logit [T]); each token's label lies in one shard, the others
    give 0."""
    m_all = m.amax(0)
    d_all = (d * _rescale(m, m_all[None])).sum(0)
    return m_all + torch.log(d_all), label_logit.sum(0)


def vocab_shard_grads(hidden: Tensor, w: Tensor, labels: Tensor,
                      lse: Tensor, dloss: Tensor, num_chunks: int,
                      z_loss: float):
    """One shard's backward from the merged lse [T]: re-stream the columns
    of ``w`` [D, V'] (``labels`` relative to its column 0) and return (this
    shard's part of dh [T, D] fp32, dW [D, V'] fp32); the parts of dh over
    the shards sum to the whole."""
    t, d = hidden.shape
    v = w.shape[1]
    c = v // num_chunks
    hf = hidden.float()
    dloss = dloss.float()
    # d loss_i / d logits_ij = softmax_ij − onehot(label)_ij (+ z-loss)
    zcoef = (1.0 + 2.0 * z_loss * lse) * dloss if z_loss else dloss
    rows = torch.arange(t, device=hidden.device)
    dh = torch.zeros((t, d), device=hidden.device)
    dw = torch.empty((d, v), device=hidden.device)
    for i in range(num_chunks):
        wc = w[:, i * c:(i + 1) * c].float()
        p = torch.exp(hf @ wc - lse[:, None])
        local = labels - i * c
        in_chunk = (local >= 0) & (local < c)
        onehot = torch.zeros_like(p)
        onehot[rows[in_chunk], local[in_chunk]] = 1.0
        dlogits = p * zcoef[:, None] - onehot * dloss[:, None]
        dh = dh + dlogits @ wc.T
        dw[:, i * c:(i + 1) * c] = hf.T @ dlogits
    return dh, dw


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
        dh, dw = vocab_shard_grads(hidden, w, labels, lse, dloss,
                                   ctx.num_chunks, ctx.z_loss)
        return dh.to(hidden.dtype), dw.to(w.dtype), None, None, None


class VocabParallelXent(torch.autograd.Function):
    """Per-token CE loss [T] from hidden [T, D] (the same on every rank of
    ``group``), this rank's head columns ``w_local`` [D, V/M] starting at
    global column ``vocab_start``, and global labels [T].  Forward: the
    rank's ``vocab_shard_stats``, then the ⊕ over the group (``m`` a MAX
    all-reduce, ``d·exp(m_r − m)`` and the label logit SUM all-reduces), so
    every rank holds the same loss.  Backward: the rank re-streams its own
    columns with the merged lse; dW stays local and dh is summed over the
    group."""

    @staticmethod
    def forward(ctx, hidden, w_local, labels, vocab_start, group, num_chunks,
                z_loss):
        from repro_torch.distributed.tensor_parallel import all_reduce
        local = labels - vocab_start
        m_r, d_r, label_r = vocab_shard_stats(hidden, w_local, local,
                                              num_chunks)
        m = all_reduce(m_r.clone(), group, op="max")
        d = all_reduce(d_r * _rescale(m_r, m), group)
        label_logit = all_reduce(label_r, group)
        lse = m + torch.log(d)
        ctx.save_for_backward(hidden, w_local, local, lse)
        ctx.group, ctx.num_chunks, ctx.z_loss = group, num_chunks, z_loss
        return _loss(lse, label_logit, z_loss)

    @staticmethod
    def backward(ctx, dloss):
        from repro_torch.distributed.tensor_parallel import all_reduce
        hidden, w_local, local, lse = ctx.saved_tensors
        dh, dw = vocab_shard_grads(hidden, w_local, local, lse, dloss,
                                   ctx.num_chunks, ctx.z_loss)
        dh = all_reduce(dh, ctx.group)
        return (dh.to(hidden.dtype), dw.to(w_local.dtype), None, None, None,
                None, None)


def chunked_cross_entropy(hidden: Tensor, w: Tensor, labels: Tensor, *,
                          num_chunks: int = 8, z_loss: float = 0.0) -> Tensor:
    """Per-token CE loss [T] from hidden [T, D], head W [D, V], labels [T].

    ``num_chunks`` is the vocab-streaming factor; V % num_chunks == 0 is
    required (configs guarantee it)."""
    assert w.shape[1] % num_chunks == 0, (tuple(w.shape), num_chunks)
    return ChunkedSoftmaxXent.apply(hidden, w, labels.long(), num_chunks,
                                    z_loss)


def vocab_parallel_cross_entropy(hidden: Tensor, w_local: Tensor,
                                 labels: Tensor, *, vocab_start: int, group,
                                 num_chunks: int = 8,
                                 z_loss: float = 0.0) -> Tensor:
    """Per-token CE loss [T] under a vocabulary-sharded head: hidden [T, D]
    replicated over ``group``, this rank's columns ``w_local`` [D, V/M]
    from global column ``vocab_start``, global labels [T].  Every rank
    returns the same loss.  ``num_chunks`` divides V/M; the loss does not
    depend on it."""
    assert w_local.shape[1] % num_chunks == 0, (tuple(w_local.shape),
                                                num_chunks)
    return VocabParallelXent.apply(hidden, w_local, labels.long(),
                                   int(vocab_start), group, num_chunks,
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
