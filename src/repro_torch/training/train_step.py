"""Train-step builder: loss → grads → cast → AdamW, the port of
``src/repro/training/train_step.py`` (``loss_for`` at line 28,
``make_train_step`` at 32, ``init_state`` at 67).

The loss is the family's (``loss_for``): an encoder-decoder's
``encdec.loss_fn`` over a batch ``{frames [B, S_enc, D], tokens,
labels}``, every other model's ``transformer.loss_fn`` (a VLM batch may
add ``patch_embeds`` [B, P, D]).  A leaf the loss does not reach (a VLM's
``mm_proj`` on a text-only batch) gets a zero gradient, as the
reference's ``jax.grad`` gives it.

With ``microbatches > 1`` each microbatch's gradients are cast to
``grad_reduce_dtype``, accumulated in fp32 and averaged (the reference's
``lax.scan``, here a loop); then, as with one microbatch, the gradients are
cast once more and AdamW updates the parameters in place.

Under a ``distributed.context.ShardContext`` whose data axes span more than
one rank, the step is data-parallel (the reference's pjit step over the
data axes): each rank holds its rows of the global batch and identical
parameters.  The loss is a masked mean over the rank's own valid labels
(``transformer.loss_fn``), so a plain average of the ranks' gradients is
not the global mean's whenever ranks mask different numbers of labels:
the ranks first all-reduce their counts of valid labels, each scales its
loss by ``local_count / global_count`` before the backward, and the
gradients are then summed over the data group, in the dtype ``cast_grads``
gave them, once after the microbatch loop.  The reported loss is the
global one (the scaled losses summed).  Clipping and AdamW run on the
reduced gradients, so the ranks stay identical.  An aux loss (MoE) enters
as the count-weighted mean of the ranks' aux terms.

Under a context whose mesh has a model axis, a dense decoder's state is
this rank's model-axis shards (``init_state`` draws the full tree from the
run's seed and keeps ``tensor_parallel.shard_tree`` of it), the loss runs
tensor-parallel (``transformer.loss_fn``), and the step runs as above on
the shards: ``_label_share`` and the gradient sum stay over the data axes,
and the global norm of AdamW's clipping sums the sharded leaves' squares
over the model group (``adamw.update(sharded=, group=)``).
"""
from __future__ import annotations

from typing import Any, Callable, Union

import torch

from repro_torch import tree
from repro_torch.configs.base import RunConfig
from repro_torch.distributed import compression, context
from repro_torch.distributed import tensor_parallel
from repro_torch.models import encdec, transformer
from repro_torch.optim import adamw

PyTree = Any


def loss_for(cfg) -> Callable:
    """The family's loss: ``encdec.loss_fn`` for an encoder-decoder, else
    ``transformer.loss_fn``."""
    return encdec.loss_fn if cfg.family == "encdec" else transformer.loss_fn


def init_for(cfg) -> Callable:
    """The family's init: ``encdec.init`` for an encoder-decoder, else
    ``transformer.init``."""
    return encdec.init if cfg.family == "encdec" else transformer.init


def _value_and_grad(params: PyTree, batch: dict, cfg, weight=None):
    """(loss, metrics, grads) of ``loss_for(cfg)``; grads is a tree like
    ``params`` in the parameters' dtypes, zeros where the loss does not
    reach a leaf.  ``weight`` (a scalar tensor) scales the loss before the
    backward, and the loss and metrics returned with it."""
    leaves = tree.leaves(params)
    loss, metrics = loss_for(cfg)(params, batch, cfg)
    if weight is not None:
        loss = loss * weight
        metrics = {k: v * weight for k, v in metrics.items()}
    grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree.unflatten(params, grads))


def make_train_step(run: RunConfig) -> Callable:
    """(params, opt_state, batch) → (params, opt_state, metrics); params and
    the optimizer's moments are updated in place."""
    cfg = run.model
    n_micro = run.parallel.microbatches
    reduce_dtype = run.parallel.grad_reduce_dtype

    def train_step(params, opt_state, batch):
        group = _data_group()
        # each rank's share of the global masked mean (None: one rank)
        weight = (None if group is None
                  else _label_share(batch["labels"], group))
        if n_micro == 1:
            loss, metrics, grads = _value_and_grad(params, batch, cfg, weight)
        else:
            micro = {k: v.reshape((n_micro, v.shape[0] // n_micro)
                                  + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            grads = tree.map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            losses, ms = [], []
            for i in range(n_micro):
                loss_i, m_i, g_i = _value_and_grad(
                    params, {k: v[i] for k, v in micro.items()}, cfg, weight)
                g_i = compression.cast_grads(g_i, reduce_dtype)
                grads = tree.map(lambda a, x: a + x.float(), grads, g_i)
                losses.append(loss_i)
                ms.append(m_i)
            grads = tree.map(lambda g: g / n_micro, grads)
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}
        grads = compression.cast_grads(grads, reduce_dtype)
        if group is not None:
            grads, loss, metrics = _all_reduce(grads, loss, metrics, group)
        params, opt_state, om = adamw.update(grads, opt_state, params,
                                             run.optimizer, **_norm_axis(cfg))
        return params, opt_state, {**metrics, **om, "loss_out": loss}

    return train_step


def _norm_axis(cfg) -> dict:
    """``adamw.update``'s ``sharded`` / ``group`` on the ambient model axis
    (the leaves' flags from the placements), {} without one."""
    shard = tensor_parallel.state_sharding(cfg)
    if shard is None:
        return {}
    return {"sharded": tensor_parallel.sharded_flags(shard.place, shard.axis),
            "group": context.group(shard.mesh, shard.axis)}


def _data_group():
    """The data-parallel process group of the ambient context, or None when
    there is no context or its data axes hold one rank."""
    ctx = context.get()
    if ctx is None or context.axis_size(ctx.mesh, ctx.par.data_axes) == 1:
        return None
    return context.group(ctx.mesh, ctx.par.data_axes)


def _label_share(labels: torch.Tensor, group) -> torch.Tensor:
    """``local_count / global_count`` of the valid labels (>= 0), the
    counts all-reduced over ``group`` (fp32; a global count of 0 counts
    as 1, as ``loss_fn`` clamps its own)."""
    import torch.distributed as dist
    local = (labels >= 0).sum().to(torch.float32).reshape(1)
    total = local.clone()
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return (local / total.clamp(min=1.0))[0]


def _all_reduce(grads, loss, metrics, group):
    """SUM of every gradient leaf in its own dtype, and of the scaled loss
    and metrics, over ``group``: the global masked mean's gradient and
    loss on every rank."""
    import torch.distributed as dist
    for g in tree.leaves(grads):
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=group)
    names = sorted(metrics)
    stats = torch.stack([loss.float()] + [metrics[k].float() for k in names])
    dist.all_reduce(stats, op=dist.ReduceOp.SUM, group=group)
    return grads, stats[0], {k: stats[i + 1] for i, k in enumerate(names)}


def init_state(run: RunConfig, *,
               device: Union[str, torch.device] = "cuda"):
    """(params, opt_state): weights from ``run.seed`` (``init_for``) whose
    leaves require grad, and a fresh AdamW state.  The weights are drawn
    where they train (``init(draw_device=device)``): a CPU draw of a
    full-width model takes over a minute (``tools/init_times.py``), so a
    card run draws other numbers from the same seed than a CPU run.  On
    the ambient model axis every rank draws the full tree and keeps its
    shards (``tensor_parallel.shard_tree``)."""
    params = init_for(run.model)(run.model, seed=run.seed, device=device,
                                 draw_device=device)
    shard = tensor_parallel.state_sharding(run.model)
    if shard is not None:
        params = tensor_parallel.shard_tree(params, shard.place, shard.mesh,
                                            shard.axis)
    params = tree.map(lambda p: p.requires_grad_(True), params)
    return params, adamw.init(params)
