"""Train-step builder: loss → grads → cast → AdamW, the port of
``src/repro/training/train_step.py`` (``make_train_step`` at line 32,
``init_state`` at 67).

With ``microbatches > 1`` each microbatch's gradients are cast to
``grad_reduce_dtype``, accumulated in fp32 and averaged (the reference's
``lax.scan``, here a loop); then, as with one microbatch, the gradients are
cast once more and AdamW updates the parameters in place.
"""
from __future__ import annotations

from typing import Any, Callable, Union

import torch

from repro_torch import tree
from repro_torch.configs.base import RunConfig
from repro_torch.distributed import compression
from repro_torch.models import transformer
from repro_torch.optim import adamw

PyTree = Any


def _value_and_grad(params: PyTree, batch: dict, cfg):
    """(loss, metrics, grads) of ``transformer.loss_fn``; grads is a tree
    like ``params`` in the parameters' dtypes."""
    loss, metrics = transformer.loss_fn(params, batch, cfg)
    grads = torch.autograd.grad(loss, tree.leaves(params))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree.unflatten(params, grads))


def make_train_step(run: RunConfig) -> Callable:
    """(params, opt_state, batch) → (params, opt_state, metrics); params and
    the optimizer's moments are updated in place."""
    cfg = run.model
    n_micro = run.parallel.microbatches
    reduce_dtype = run.parallel.grad_reduce_dtype

    def train_step(params, opt_state, batch):
        if n_micro == 1:
            loss, metrics, grads = _value_and_grad(params, batch, cfg)
        else:
            micro = {k: v.reshape((n_micro, v.shape[0] // n_micro)
                                  + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            grads = tree.map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            losses, ms = [], []
            for i in range(n_micro):
                loss_i, m_i, g_i = _value_and_grad(
                    params, {k: v[i] for k, v in micro.items()}, cfg)
                g_i = compression.cast_grads(g_i, reduce_dtype)
                grads = tree.map(lambda a, x: a + x.float(), grads, g_i)
                losses.append(loss_i)
                ms.append(m_i)
            grads = tree.map(lambda g: g / n_micro, grads)
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}
        grads = compression.cast_grads(grads, reduce_dtype)
        params, opt_state, om = adamw.update(grads, opt_state, params,
                                             run.optimizer)
        return params, opt_state, {**metrics, **om, "loss_out": loss}

    return train_step


def init_state(run: RunConfig, *,
               device: Union[str, torch.device] = "cuda"):
    """(params, opt_state): weights from ``run.seed`` whose leaves require
    grad, and a fresh AdamW state."""
    params = transformer.init(run.model, seed=run.seed, device=device)
    params = tree.map(lambda p: p.requires_grad_(True), params)
    return params, adamw.init(params)
