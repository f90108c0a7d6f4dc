"""The model axis executed: tensor-parallel training of a dense decoder.

The reference has no file for this: it annotates each parameter with its
placement (``src/repro/distributed/sharding.py:103-114``, ``param_sharding``)
and GSPMD inserts the collectives; in sequence mode it constrains q to its
rows and K/V to whole sequences (``src/repro/models/layers.py:212-240``,
``_constrain_seq_parallel`` and ``_maybe_expand_kv``), and under a
vocabulary-sharded head XLA merges the cross-entropy's partial ``(m, d)``
across devices (``src/repro/core/cross_entropy.py:11-13``).  This module
is what GSPMD does there, written out:

* the four collectives of the layers, each a ``torch.autograd.Function``
  with its backward beside its forward: ``copy_to_model`` (identity,
  all-reduce SUM backward: "f"), ``reduce_from_model`` (all-reduce SUM,
  identity backward: "g"), ``gather_rows`` (all-gather along T, the
  rank's own rows of the gradient backward) and ``gather_weight``
  (all-gather of a weight's sharded dim, the group's sum of the gradient
  then the rank's own shard backward);
* ``shard_tree`` / ``gather_tree``: a full parameter tree to this rank's
  model-axis shards (slices of the sharded dims), and back;
* ``model_axis(cfg)``: what the layers read, the ambient context's model
  axis with ``sharding.axis_rules``' placements for ``cfg``.

Activations between sublayers are replicated over the model group: every
model rank holds the whole ``[B_local, T, D]``.  A replicated parameter
that feeds rank-specific work passes through ``copy_to_model``, so its
gradient is summed over the group; a norm scale on a replicated
activation gets the same gradient on every rank without it.  Nothing
branches on the axis's size: a group of one runs the same code, which is
what one card runs.

Dense decoders only (``family == "dense"``).  Under a model axis of more
than one rank the other families raise ``NotImplementedError``, naming what
they lack (``MISSING``); at one rank they run their replicated code.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import context, sharding

PyTree = Any

#: What each family still lacks on the model axis.
MISSING = {
    "moe": "the experts' placements (expert / expert_ffn)",
    "mla": "MLA's low-rank attention projections",
    "ssm": "the recurrent blocks' inner dims (inner / inner_heads)",
    "hybrid": "the recurrent blocks' inner dims (inner / inner_heads)",
    "encdec": "the encoder-decoder's two stacks and cross-attention",
    "vlm": "the VLM's patch projection and patch positions",
}

#: Model-group collectives since the last ``reset_collectives`` (forward and
#: backward alike, the cross-entropy's included).
collectives = {"all_reduce": 0, "all_gather": 0}


def reset_collectives() -> None:
    for k in collectives:
        collectives[k] = 0


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``x`` reduced over ``group`` in place (SUM or MAX), counted."""
    import torch.distributed as dist
    dist.all_reduce(x, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM, group=group)
    collectives["all_reduce"] += 1
    return x


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's ``x`` concatenated along ``dim`` in rank order, counted."""
    import torch.distributed as dist
    x = x.contiguous()
    parts = [torch.empty_like(x)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    collectives["all_gather"] += 1
    return torch.cat(parts, dim)


class ModelAxis(NamedTuple):
    """The ambient model axis as the layers read it."""
    group: Any       # its process group
    index: int       # this rank's place on it
    size: int        # its ranks
    axis: str        # its mesh-axis name
    mode: str        # attention's: "heads" or "sequence"
    rules: dict      # logical axis → mesh axis (sharding.axis_rules)

    def shards(self, logical: str) -> bool:
        """Whether the placements shard ``logical`` over this axis."""
        return self.rules.get(logical) == self.axis


def model_axis(cfg: ModelConfig) -> Optional[ModelAxis]:
    """The ambient context's model axis for ``cfg``, or None: no context,
    a mesh without the axis, or another family than dense on a model axis
    of one rank.  Another family on more ranks raises."""
    ctx = context.get()
    if ctx is None or ctx.mesh is None or \
            ctx.par.model_axis not in ctx.mesh.mesh_dim_names:
        return None
    size = context.model_size(ctx)
    if cfg.family != "dense":
        if size > 1:
            raise NotImplementedError(
                f"the model axis ({size} ranks) runs dense decoders only: "
                f"{cfg.name} ({cfg.family}) lacks "
                f"{MISSING.get(cfg.family, 'its placements')}")
        return None
    par = sharding.derive_parallel(cfg, ctx.mesh, ctx.par)
    return ModelAxis(context.model_group(ctx), context.model_index(ctx),
                     size, par.model_axis, par.attn_mode,
                     sharding.axis_rules(cfg, par, ctx.mesh))


# ---------------------------------------------------------------------------
# the collectives of the layers
# ---------------------------------------------------------------------------
class _CopyToModel(torch.autograd.Function):
    """Forward: identity.  Backward: the gradient summed over the group
    (each rank's is its own work's part)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """Forward: the ranks' partial sums added.  Backward: identity (the
    sum's gradient reaches every part whole)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherRows(torch.autograd.Function):
    """Forward: the ranks' row blocks concatenated along ``dim``.
    Backward: the rank's own rows of the gradient (downstream replication
    makes the gradient whole and the same on every rank)."""

    @staticmethod
    def forward(ctx, x, dim, index, group):
        ctx.dim, ctx.index, ctx.rows = dim, index, x.shape[dim]
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.rows,
                        ctx.rows).contiguous(), None, None, None


class _GatherWeight(torch.autograd.Function):
    """Forward: a weight's shards concatenated along its sharded ``dim``.
    Backward: each rank's gradient of the whole weight summed over the
    group, and the rank's own shard of the sum kept."""

    @staticmethod
    def forward(ctx, w, dim, index, group):
        ctx.dim, ctx.index, ctx.n, ctx.group = dim, index, w.shape[dim], group
        return all_gather(w, dim, group)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce(g.contiguous().clone(), ctx.group)
        return g.narrow(ctx.dim, ctx.index * ctx.n,
                        ctx.n).contiguous(), None, None, None


def copy_to_model(x: torch.Tensor, tp: ModelAxis) -> torch.Tensor:
    return _CopyToModel.apply(x, tp.group)


def reduce_from_model(x: torch.Tensor, tp: ModelAxis) -> torch.Tensor:
    return _ReduceFromModel.apply(x, tp.group)


def gather_rows(x: torch.Tensor, dim: int, tp: ModelAxis) -> torch.Tensor:
    return _GatherRows.apply(x, dim, tp.index, tp.group)


def gather_weight(w: torch.Tensor, dim: int, tp: ModelAxis) -> torch.Tensor:
    return _GatherWeight.apply(w, dim, tp.index, tp.group)


# ---------------------------------------------------------------------------
# placements and trees
# ---------------------------------------------------------------------------
def param_axes(cfg: ModelConfig) -> PyTree:
    """The logical axes of a dense decoder's parameter tree
    (``transformer.init``'s layout), the reference's ``split_params`` axes
    without the stacked ``"layers"`` axis."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"placements of {cfg.name} ({cfg.family}): the model axis runs "
            f"dense decoders only; it lacks "
            f"{MISSING.get(cfg.family, 'its placements')}")
    mlp = {"w_up": ("embed", "ffn"), "w_down": ("ffn", "embed")}
    if cfg.act == "silu":
        mlp["w_gate"] = ("embed", "ffn")
    layer = {"ln1": ("embed",), "ln2": ("embed",),
             "attn": {"wq": ("embed", "qkv_out"), "wk": ("embed", "kv_out"),
                      "wv": ("embed", "kv_out"), "wo": ("qkv_out", "embed")},
             "mlp": mlp}
    axes = {"embed": ("vocab", "embed"), "final_norm": ("embed",),
            "layers": [layer] * cfg.num_layers}
    if not cfg.tie_embeddings:
        axes["head"] = ("embed", "vocab")
    return axes


def placements(cfg: ModelConfig, par, mesh) -> PyTree:
    """Each parameter's placement (``sharding.param_sharding``)."""
    return sharding.param_sharding(param_axes(cfg), cfg, par, mesh)


def _dim(placement: tuple, axis: str) -> Optional[int]:
    """The dimension ``placement`` shards over ``axis``, or None."""
    for i, entry in enumerate(placement):
        if entry == axis or (isinstance(entry, tuple) and axis in entry):
            return i
    return None


def _map(fn, tree: PyTree, place: PyTree) -> PyTree:
    """``fn(leaf, placement)`` over a parameter tree and its placements."""
    return sharding._map_leaves(fn, tree, place, is_leaf=torch.is_tensor)


def sharded_flags(place: PyTree, axis: str = "model") -> PyTree:
    """A tree of bools: whether each leaf is sharded over ``axis``."""
    return sharding._map_leaves(lambda p: _dim(p, axis) is not None, place,
                                is_leaf=sharding._is_leaf)


def shard_tree(params: PyTree, place: PyTree, mesh,
               axis: str = "model") -> PyTree:
    """This rank's shards of a full tree: each leaf sharded over ``axis``
    sliced to the rank's block of its sharded dim (a copy), the others
    kept.  ``requires_grad`` follows the leaf."""
    n = context.axis_size(mesh, axis)
    r = context.axis_index(mesh, axis)

    def cut(leaf, p):
        d = _dim(p, axis)
        if d is None:
            return leaf
        if leaf.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(leaf.shape)} does not split "
                             f"over {n} ranks")
        size = leaf.shape[d] // n
        out = leaf.detach().narrow(d, r * size, size).clone()
        return out.requires_grad_(leaf.requires_grad)
    return _map(cut, params, place)


def gather_tree(params: PyTree, place: PyTree, mesh,
                axis: str = "model") -> PyTree:
    """The full tree from every rank's shards (``shard_tree``'s inverse): a
    collective, so every rank of the axis calls it.  Leaves come back
    detached."""
    group = context.group(mesh, axis)

    def join(leaf, p):
        d = _dim(p, axis)
        leaf = leaf.detach()
        return leaf if d is None else all_gather(leaf, d, group)
    return _map(join, params, place)


class StateSharding(NamedTuple):
    """A training state's model-axis sharding: what the loop gathers
    before a checkpoint and shards after a restore."""
    place: PyTree
    mesh: Any
    axis: str = "model"

    def gather(self, state: dict) -> dict:
        """{"params", "opt"} with every sharded leaf (the parameters and
        AdamW's moments) gathered whole: a collective."""
        opt = state["opt"]
        return {"params": gather_tree(state["params"], self.place,
                                      self.mesh, self.axis),
                "opt": type(opt)(opt.step, *(gather_tree(
                    t, self.place, self.mesh, self.axis)
                    for t in (opt.mu, opt.nu)))}

    def shard(self, state: dict) -> dict:
        opt = state["opt"]
        return {"params": shard_tree(state["params"], self.place, self.mesh,
                                     self.axis),
                "opt": type(opt)(opt.step, *(shard_tree(
                    t, self.place, self.mesh, self.axis)
                    for t in (opt.mu, opt.nu)))}


def state_sharding(cfg: ModelConfig) -> Optional[StateSharding]:
    """The ambient model axis's ``StateSharding`` of ``cfg``, or None where
    ``model_axis`` gives None."""
    tp = model_axis(cfg)
    if tp is None:
        return None
    ctx = context.get()
    par = sharding.derive_parallel(cfg, ctx.mesh, ctx.par)
    return StateSharding(placements(cfg, par, ctx.mesh), ctx.mesh, tp.axis)
