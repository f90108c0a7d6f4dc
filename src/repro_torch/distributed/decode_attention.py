"""Distributed decode attention and top-k: the paper's §3.1 ⊕ as collectives
over ``torch.distributed`` — the port of
``src/repro/distributed/decode_attention.py`` (``sharded_decode_attention``
at line 40, ``sharded_topk_sample`` at 93).

``sharded_decode_attention``: each rank holds its slice of the KV cache
along the sequence, [B_local, S / n, Hkv, D], and runs the local one-token
attention over it with its log-sum-exp (``dispatch.decode_attention_lse``:
on the card row 4's lse form, or 4q's for an int8 cache, on the CPU their
plain version).  The global result is the ⊕ of the partials, three
[B, Hq]-sized collectives over the sequence group:

    m* = max lse            w = e^{lse − m*} (0 where lse = −inf)
    d* = Σ w                o* = Σ o · w / d*

``merge_partials`` is the same arithmetic over partials stacked on a
leading axis in one process (the tests and the card's check merge N cache
slices with it); ``_merge`` is written once for both.

``sharded_topk_sample``: Algorithm 4 over a vocabulary split across ranks.
Each rank runs row 1 (``dispatch.softmax_topk``) on its slice, which gives
its top-k probabilities, indices and lse in one pass; the shard statistics
⊕-merge (the lse plays m and d is 1), the k candidates of every rank are
``all_gather``ed and the top k taken again; the Gumbel choice follows the
reference's lines 122-126.

Every rank of a group calls these functions with its own tensors: what the
reference's ``shard_map`` handed each shard, the port's caller holds.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core.topk_fusion import (SoftmaxTopK, gumbel_noise,
                                          gumbel_pick, topk_lowest_index)
from repro_torch.distributed import context

Tensor = torch.Tensor


def _weights(lse: Tensor, m: Tensor) -> Tensor:
    """e^{lse − m*} of each partial: 1 where lse = m* (the reference's
    ``_merge_scale``, which keeps −inf = −inf from giving NaN), 0 for a
    partial with no valid key (lse = −inf)."""
    w = torch.exp(torch.where(lse == m, torch.zeros_like(lse), lse - m))
    return torch.where(torch.isneginf(lse), torch.zeros_like(w), w)


def _merge(out: Tensor, lse: Tensor, pmax: Callable, psum: Callable,
           dtype: torch.dtype) -> Tensor:
    """The ⊕ of partials (out [..., B, 1, Hq, Dv], lse [..., B, Hq]) whose
    reductions ``pmax`` / ``psum`` run over a stacked axis or a process
    group; returns [B, 1, Hq, Dv] in ``dtype``.  The reference's lines
    68-77, the sums in fp32."""
    lse = lse.float()
    w = _weights(lse, pmax(lse))
    d = psum(w)
    o = psum(out.float() * w[..., None, :, None])
    return (o / d.clamp(min=1e-30)[..., None, :, None]).to(dtype)


def merge_partials(outs: Tensor, lses: Tensor) -> Tensor:
    """⊕ of N partial decodes in one process: ``outs`` [N, B, 1, Hq, Dv]
    and ``lses`` [N, B, Hq] (−inf for a slice with no valid key) →
    [B, 1, Hq, Dv] in ``outs``' dtype."""
    return _merge(outs, lses, lambda x: x.amax(0), lambda x: x.sum(0),
                  outs.dtype)


def _collective(op, group) -> Callable:
    import torch.distributed as dist

    def reduce(x):
        y = x.clone()
        dist.all_reduce(y, op=op, group=group)
        return y
    return reduce


def merge_collective(out: Tensor, lse: Tensor, group) -> Tensor:
    """⊕ of every rank's partial (out [B, 1, Hq, Dv], lse [B, Hq]) over
    ``group``: ``all_reduce`` MAX of the lse, then SUM of the weights and of
    the weighted outputs in fp32; the result in ``out``'s dtype."""
    import torch.distributed as dist
    return _merge(out, lse, _collective(dist.ReduceOp.MAX, group),
                  _collective(dist.ReduceOp.SUM, group), out.dtype)


def sharded_decode_attention(q: Tensor, k_cache: Tensor, v_cache: Tensor,
                             kv_valid_len, *, mesh, seq_axes: tuple,
                             batch_axes: tuple = ("data",),
                             chunk_size: int, scale: float,
                             k_scale: Optional[Tensor] = None,
                             v_scale: Optional[Tensor] = None) -> Tensor:
    """q [B_local, 1, Hq, D]; this rank's cache slice [B_local, S_local,
    Hkv, D] (int8 with ``k_scale`` / ``v_scale`` [B_local, S_local, Hkv]),
    the slice ``axis_index(seq_axes)`` of the sequence; ``kv_valid_len``
    the rows' global valid lengths.  Returns [B_local, 1, Hq, D] in q's
    dtype, the same on every rank of the sequence group.  The batch axes
    are the rows this rank already holds (``batch_axes`` names them, as in
    the reference's signature; nothing here reduces over them)."""
    from repro_torch.kernels import dispatch
    del batch_axes
    b, s_local = q.shape[0], k_cache.shape[1]
    start = context.axis_index(mesh, seq_axes) * s_local
    # the shard's valid keys, from the rows' global lengths
    vl = (torch.as_tensor(kv_valid_len, device=q.device).to(torch.int64)
          .expand(b) - start).clamp(0, s_local).to(torch.int32)
    out, lse = dispatch.decode_attention_lse(
        q, k_cache, v_cache, vl, chunk_size=min(chunk_size, s_local),
        scale=scale, k_scale=k_scale, v_scale=v_scale)
    return merge_collective(out, lse, context.group(mesh, seq_axes)
                            ).to(q.dtype)


def sharded_topk_sample(logits: Tensor, k: int, *, mesh,
                        batch_axes: tuple = ("data",),
                        vocab_axis: str = "model", temperature: float = 1.0,
                        noise: Optional[Tensor] = None,
                        generator: Optional[torch.Generator] = None):
    """Fused softmax + top-k + sample over a vocabulary split across the
    ``vocab_axis`` ranks: ``logits`` [B_local, V] are this rank's rows, of
    which it reads its slice ``[r·V/n, (r+1)·V/n)``.  Returns (tokens
    [B_local], probs [B_local, k]), the same on every rank of the vocabulary
    group.

    The Gumbels are ``noise`` [B_local, k] (a test injects the reference's
    here), or drawn from ``generator``, seeded alike on every rank: a draw
    for the whole batch, [B_local · n_batch, k], of which the rank takes its
    rows, so the tokens are those of one process sampling the whole batch
    with that generator."""
    import torch.distributed as dist
    from repro_torch.kernels import dispatch
    n = context.axis_size(mesh, vocab_axis)
    r = context.axis_index(mesh, vocab_axis)
    b, v = logits.shape
    if v % n:
        raise ValueError(f"sharded_topk_sample: vocabulary {v} does not split "
                         f"over {n} ranks of {vocab_axis!r}")
    v_local = v // n
    x = logits[:, r * v_local:(r + 1) * v_local].float()
    if temperature != 1.0:
        x = x / temperature
    local = dispatch.softmax_topk(x, k)            # row 1: Alg. 4 per shard
    group = context.group(mesh, vocab_axis)
    lse = local.logsumexp.float()
    m = _collective(dist.ReduceOp.MAX, group)(lse)
    w = _weights(lse, m)
    d = _collective(dist.ReduceOp.SUM, group)(w)
    # each shard's top-k on the global scale (× e^{lse − m*}), then the
    # candidates of every shard in shard order
    cand_v = local.values.float() * w[:, None]
    cand_i = local.indices.long() + r * v_local
    gathered_v = [torch.empty_like(cand_v) for _ in range(n)]
    gathered_i = [torch.empty_like(cand_i) for _ in range(n)]
    dist.all_gather(gathered_v, cand_v, group=group)
    dist.all_gather(gathered_i, cand_i, group=group)
    top_v, sel = topk_lowest_index(torch.cat(gathered_v, dim=-1), k)
    top_i = torch.gather(torch.cat(gathered_i, dim=-1), -1, sel)
    probs = top_v / d[:, None]
    if noise is None:
        if generator is None:
            raise ValueError("sharded_topk_sample needs its Gumbels: pass "
                             "noise or a generator")
        n_rows = context.axis_size(mesh, batch_axes)
        row0 = context.axis_index(mesh, batch_axes) * b
        noise = gumbel_noise((b * n_rows, k), generator)[row0:row0 + b]
    lse_g = m + torch.log(d.clamp(min=1e-30))
    tok = gumbel_pick(SoftmaxTopK(probs, top_i, lse_g), noise)
    return tok, probs
