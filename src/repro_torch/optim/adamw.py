"""AdamW with decoupled weight decay, global-norm clipping and LR schedules:
the port of ``src/repro/optim/adamw.py`` with its numerics (lines 20-85).

* The moments are fp32 trees shaped like the parameters.
* The step counter is incremented before the schedule reads it.
* Weight decay applies only to leaves with ``ndim >= 2`` in the
  reference's layout, which stacks each segment's layers on a leading axis:
  there every per-layer leaf, norm scales included, has ``ndim >= 2``, and
  only the embedding-level vectors (``final_norm``) go undecayed.  The port
  keeps one dict per layer, so a leaf under ``layers/`` counts one more
  dimension (:func:`decays`).
* Each parameter is updated in fp32 and cast back to its dtype; there are no
  fp32 master weights (the reference keeps none).

Where the reference returned new trees, ``update`` writes the parameters and
the moments in place (they are the largest tensors of a run) and returns
them with a new state.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch import tree
from repro_torch.configs.base import OptimizerConfig

PyTree = Any


class AdamWState(NamedTuple):
    step: torch.Tensor      # int32 scalar
    mu: PyTree
    nu: PyTree


def init(params: PyTree) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    device = tree.leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=tree.map(zeros, params), nu=tree.map(zeros, params))


def schedule(step: torch.Tensor, cfg: OptimizerConfig) -> torch.Tensor:
    """Warmup + {cosine, linear, constant} decay, in fp32 on step's
    device."""
    step_f = step.float()
    warm = torch.clamp(step_f / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step_f - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    if cfg.schedule == "cosine":
        decay = 0.5 * (1 + torch.cos(math.pi * frac))
    elif cfg.schedule == "linear":
        decay = 1.0 - frac
    else:
        decay = torch.ones_like(frac)
    return cfg.lr * warm * decay


def global_norm(leaves: list) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(x.float().square()) for x in leaves))


def clip_by_global_norm(grads: PyTree, max_norm: float):
    gnorm = global_norm(tree.leaves(grads))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    return tree.map(lambda g: g * scale, grads), gnorm


#: The port's per-layer lists, which the reference stacks on a leading
#: layer axis: a decoder-only model's, and an encoder-decoder's two.
STACKED = ("layers/", "encoder/", "decoder/")


def decays(path: str, p: torch.Tensor) -> bool:
    """Whether weight decay applies to the leaf at ``path``: ndim >= 2 in
    the reference's stacked layout (a per-layer leaf counts its layer
    axis; zamba2's ``shared_attn`` block is unstacked in both packages, so
    its norms are not decayed)."""
    return p.ndim + path.startswith(STACKED) >= 2


def update(grads: PyTree, state: AdamWState, params: PyTree,
           cfg: OptimizerConfig):
    """One AdamW step, in place on ``params`` and the moments.  Returns
    (params, new state, {"grad_norm", "lr"})."""
    grads = tree.map(lambda g: g.float(), grads)
    if cfg.grad_clip > 0:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    else:
        gnorm = global_norm(tree.leaves(grads))
    step = state.step + 1
    lr = schedule(step, cfg)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    with torch.no_grad():
        for (path, p), m, v, g in zip(
                tree.leaves_with_path(params), tree.leaves(state.mu),
                tree.leaves(state.nu), tree.leaves(grads)):
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g.square())
            delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            if cfg.weight_decay and decays(path, p):
                delta = delta + cfg.weight_decay * p.float()
            p.copy_((p.float() - lr * delta).to(p.dtype))
    return params, AdamWState(step, state.mu, state.nu), \
        {"grad_norm": gnorm, "lr": lr}
