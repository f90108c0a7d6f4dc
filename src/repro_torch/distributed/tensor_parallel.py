"""The model axis executed: tensor-parallel training of the dense, MoE,
MLA and recurrent decoders.

The reference has no file for this: it annotates each parameter with its
placement (``src/repro/distributed/sharding.py:103-114``, ``param_sharding``)
and GSPMD inserts the collectives; in sequence mode it constrains q to its
rows and K/V to whole sequences (``src/repro/models/layers.py:212-240``,
``_constrain_seq_parallel`` and ``_maybe_expand_kv``), and under a
vocabulary-sharded head XLA merges the cross-entropy's partial ``(m, d)``
across devices (``src/repro/core/cross_entropy.py:11-13``).  This module
is what GSPMD does there, written out:

* the collectives of the layers, each a ``torch.autograd.Function`` with
  its backward beside its forward: ``copy_to_model`` (identity,
  all-reduce SUM backward: "f"), ``reduce_from_model`` (all-reduce SUM,
  identity backward: "g"), ``sum_over_model`` (all-reduce SUM both ways:
  a sum whose result feeds rank-specific work, as the Mamba2 gated norm's
  sum of squares), ``gather_rows`` (all-gather along T, the rank's own
  rows of the gradient backward) and ``gather_weight`` (all-gather of a
  weight's sharded dim, the group's sum of the gradient then the rank's
  own shard backward);
* ``param_axes`` / ``param_shapes``: each leaf's logical axes (the
  reference's, without the stacked ``"layers"`` axis) and its shape, for
  the dense block, the MoE block (``expert`` / ``expert_ffn``), MLA's
  attention (``qkv_out`` columns), the Mamba2, mLSTM and sLSTM blocks
  (``inner`` / ``inner_heads``, the sLSTM's ``ffn``) and zamba2's shared
  block;
* ``placements`` (which refuses a sharded dim that does not split over
  the axis, naming the leaf), ``shard_tree`` / ``gather_tree``: a full
  parameter tree to this rank's model-axis shards (slices of the sharded
  dims), and back.  A packed leaf (``Halves``: Mamba2's ``w_zx`` = [z |
  x], the mLSTM's ``w_up`` = [xm | z]) is sharded per half, so rank r
  holds [first half's block r | second half's block r];
* ``model_axis(cfg)``: what the layers read, the ambient context's model
  axis with ``sharding.axis_rules``' placements for ``cfg``.

Activations between sublayers are replicated over the model group: every
model rank holds the whole ``[B_local, T, D]``.  A replicated tensor whose
gradient comes out rank-partial passes through ``copy_to_model`` once,
where it first feeds rank-specific work, so its gradient is summed over
the group; everything upstream of it then gets a whole gradient, the same
on every rank, and passes no second ``copy_to_model``.  A norm scale on a
replicated activation gets the same gradient on every rank without it.
Nothing branches on the axis's size: a group of one runs the same code,
which is what one card runs.

The dense, MoE, MLA and recurrent decoders run on the model axis at any
size, one rank included.  Under a model axis of more than one rank the
encoder-decoder and the VLM raise ``NotImplementedError``, naming what
they lack (``MISSING``); at one rank they run their replicated code.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import context, sharding

PyTree = Any

#: What each family still lacks on the model axis (the dense, MoE, MLA
#: and recurrent decoders lack nothing).
MISSING = {
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
    a mesh without the axis, or a family of ``MISSING`` (the
    encoder-decoder, the VLM) on a model axis of one rank.  Such a family
    on more ranks raises."""
    ctx = context.get()
    if ctx is None or ctx.mesh is None or \
            ctx.par.model_axis not in ctx.mesh.mesh_dim_names:
        return None
    size = context.model_size(ctx)
    if cfg.family in MISSING:
        if size > 1:
            raise NotImplementedError(
                f"the model axis ({size} ranks) runs the dense, MoE, MLA "
                f"and recurrent decoders only: {cfg.name} ({cfg.family}) "
                f"lacks {MISSING[cfg.family]}")
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


def sum_over_model(x: torch.Tensor, tp: ModelAxis) -> torch.Tensor:
    """The ranks' partials of ``x`` summed, where the sum feeds each rank's
    own work: its gradient is then rank-partial too, so the backward sums
    it over the group as well ("g" then "f": one all-reduce each way)."""
    return copy_to_model(reduce_from_model(x, tp), tp)


def gather_rows(x: torch.Tensor, dim: int, tp: ModelAxis) -> torch.Tensor:
    return _GatherRows.apply(x, dim, tp.index, tp.group)


def gather_weight(w: torch.Tensor, dim: int, tp: ModelAxis) -> torch.Tensor:
    return _GatherWeight.apply(w, dim, tp.index, tp.group)


# ---------------------------------------------------------------------------
# placements and trees
# ---------------------------------------------------------------------------
def _refuse(cfg: ModelConfig) -> None:
    if cfg.family in MISSING:
        raise NotImplementedError(
            f"placements of {cfg.name} ({cfg.family}): the model axis runs "
            f"the dense, MoE, MLA and recurrent decoders only; it lacks "
            f"{MISSING[cfg.family]}")


class Halves(tuple):
    """The axes, or the placement, of a packed leaf: two blocks side by
    side along its sharded dim (Mamba2's ``w_zx`` = [z | x], the mLSTM's
    ``w_up`` = [xm | z]), each split over the ranks on its own, so that
    ``chunk(2, dim)`` of a rank's shard gives its block of each.  A tuple
    in every other respect."""


def _layout(cfg: ModelConfig, leaf) -> PyTree:
    """``transformer.init``'s tree with ``leaf(axes, shape)`` at each
    leaf: the reference's logical axes (``mlp_init``, ``moe_init``,
    ``mla_init``, ``attention_init`` in ``src/repro/models/layers.py``,
    ``mamba2_init`` in ``ssm.py``, ``mlstm_block_init`` /
    ``slstm_block_init`` in ``xlstm.py``) without the stacked ``"layers"``
    axis, and the port's shapes (a ``{"scale"}`` norm dict of the
    reference's is its scale here).  A packed leaf's axes are
    ``Halves``."""
    _refuse(cfg)
    d, v = cfg.d_model, cfg.vocab_size
    if cfg.family in ("ssm", "hybrid"):
        return _recurrent_layout(cfg, leaf)

    def mlp(ff):
        p = {"w_up": leaf(("embed", "ffn"), (d, ff)),
             "w_down": leaf(("ffn", "embed"), (ff, d))}
        if cfg.act == "silu":
            p["w_gate"] = leaf(("embed", "ffn"), (d, ff))
        return p

    if cfg.mla is not None:
        m, h = cfg.mla, cfg.num_heads
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        attn = {"wdq": leaf(("embed", None), (d, m.q_lora_rank)),
                "q_norm": leaf(("embed",), (m.q_lora_rank,)),
                "wuq": leaf((None, "qkv_out"), (m.q_lora_rank, h * qk)),
                "wdkv": leaf(("embed", None),
                             (d, m.kv_lora_rank + m.qk_rope_head_dim)),
                "kv_norm": leaf(("embed",), (m.kv_lora_rank,)),
                "wuk": leaf((None, "qkv_out"),
                            (m.kv_lora_rank, h * m.qk_nope_head_dim)),
                "wuv": leaf((None, "qkv_out"),
                            (m.kv_lora_rank, h * m.v_head_dim)),
                "wo": leaf(("qkv_out", "embed"), (h * m.v_head_dim, d))}
    else:
        hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        attn = {"wq": leaf(("embed", "qkv_out"), (d, hq * hd)),
                "wk": leaf(("embed", "kv_out"), (d, hkv * hd)),
                "wv": leaf(("embed", "kv_out"), (d, hkv * hd)),
                "wo": leaf(("qkv_out", "embed"), (hq * hd, d))}
    layer = {"ln1": leaf(("embed",), (d,)), "attn": attn,
             "ln2": leaf(("embed",), (d,))}
    if cfg.moe is not None:
        mc = cfg.moe
        e, f = mc.pad_experts_to or mc.num_experts, mc.d_ff_expert
        layer["moe"] = {
            "router": leaf(("embed", None), (d, mc.num_experts)),
            "w_gate": leaf(("expert", "embed", "expert_ffn"), (e, d, f)),
            "w_up": leaf(("expert", "embed", "expert_ffn"), (e, d, f)),
            "w_down": leaf(("expert", "expert_ffn", "embed"), (e, f, d))}
        if mc.d_ff_shared:
            layer["moe"]["shared"] = mlp(mc.d_ff_shared)
    else:
        layer["mlp"] = mlp(cfg.d_ff)
    out = {"embed": leaf(("vocab", "embed"), (v, d))}
    if not cfg.tie_embeddings:
        out["head"] = leaf(("embed", "vocab"), (d, v))
    out["final_norm"] = leaf(("embed",), (d,))
    out["layers"] = [layer] * cfg.num_layers
    return out


def _recurrent_layout(cfg: ModelConfig, leaf) -> PyTree:
    """``_layout`` of xLSTM (``ssm``) and zamba2 (``hybrid``): each layer
    by its kind in stack order, and zamba2's ``"shared_attn"``, one dense
    layer's tree."""
    from repro_torch.models import transformer, xlstm
    d, v = cfg.d_model, cfg.vocab_size
    if cfg.ssm is not None:
        sc = cfg.ssm
        inner, n = sc.expand * d, sc.d_state
        h = inner // sc.head_dim
        block = {"w_zx": leaf(Halves(("embed", "inner")), (d, 2 * inner)),
                 "w_bc": leaf(("embed", None), (d, 2 * n)),
                 "w_dt": leaf(("embed", "inner_heads"), (d, h)),
                 "dt_bias": leaf(("inner_heads",), (h,)),
                 "a_log": leaf(("inner_heads",), (h,)),
                 "d_skip": leaf(("inner_heads",), (h,)),
                 "conv_x": leaf(("inner", None), (inner, sc.d_conv)),
                 "conv_b": leaf((None, None), (n, sc.d_conv)),
                 "conv_c": leaf((None, None), (n, sc.d_conv)),
                 "norm": leaf(("inner",), (inner,)),
                 "w_out": leaf(("inner", "embed"), (inner, d))}
        kinds = {"mamba": {"ln": leaf(("embed",), (d,)), "mamba": block}}
    else:
        xc = cfg.xlstm
        inner, hh = xc.expand * d, xc.num_heads
        dh, f = d // hh, xlstm._slstm_ffn(d)
        kinds = {
            "mlstm": {
                "norm": leaf(("embed",), (d,)),
                "w_up": leaf(Halves(("embed", "inner")), (d, 2 * inner)),
                "conv": leaf(("inner", None), (inner, xc.conv_width)),
                "wq": leaf(("inner", None), (inner, inner)),
                "wk": leaf(("inner", None), (inner, inner)),
                "wv": leaf(("inner", None), (inner, inner)),
                "w_if": leaf(("inner", None), (inner, 2 * hh)),
                "if_bias": leaf((None,), (2 * hh,)),
                "hnorm": leaf(("inner",), (inner,)),
                "w_down": leaf(("inner", "embed"), (inner, d))},
            "slstm": {
                "norm": leaf(("embed",), (d,)),
                "w_gates": leaf(("embed", None, None), (d, 4, d)),
                "r_weights": leaf((None, None, None, None),
                                  (4, hh, dh, dh)),
                "hnorm": leaf(("embed",), (d,)),
                "w_up1": leaf(("embed", "ffn"), (d, f)),
                "w_up2": leaf(("embed", "ffn"), (d, f)),
                "w_down": leaf(("ffn", "embed"), (f, d))}}
    out = {"embed": leaf(("vocab", "embed"), (v, d))}
    if not cfg.tie_embeddings:
        out["head"] = leaf(("embed", "vocab"), (d, v))
    out["final_norm"] = leaf(("embed",), (d,))
    if cfg.family == "hybrid":
        dense = _layout(cfg.replace(family="dense", ssm=None), leaf)
        out["shared_attn"] = dense["layers"][0]
    out["layers"] = [kinds[kind] for kind, idx, _ in
                     transformer.layer_plan(cfg) if idx is not None]
    return out


def param_axes(cfg: ModelConfig) -> PyTree:
    """The logical axes of a dense, MoE, MLA or recurrent decoder's
    parameter tree (``transformer.init``'s layout), the reference's
    ``split_params`` axes without the stacked ``"layers"`` axis."""
    return _layout(cfg, lambda axes, shape: axes)


def param_shapes(cfg: ModelConfig) -> PyTree:
    """The shape of each leaf of ``param_axes``' tree."""
    return _layout(cfg, lambda axes, shape: shape)


def check_splits(cfg: ModelConfig, place: PyTree, mesh,
                 axis: str = "model") -> None:
    """Raise ``ValueError`` where ``place`` shards a dim of ``cfg``'s
    parameters over ``axis`` that its size does not split into: the rules
    check the counts they read (heads, experts, d_ff, the vocabulary, the
    recurrent inner width) but not every leaf they shard
    (``expert_ffn``'s d_ff_expert, the shared expert's d_ff_shared under
    ``"ffn"``, MLA's H·(Dn+Dr) columns under ``qkv_out``, the sLSTM's ffn
    under ``"ffn"``, each half of a ``Halves`` leaf).  Every top-level
    leaf and dict is checked, and the first layer of each kind.  Also
    raise where ``inner`` shards and ``inner_heads`` does not: a Mamba2
    head's channels would be cut across ranks."""
    n = sharding.axis_sizes(mesh)[axis]
    bad = []

    def check(path, shape, p):
        dim = _dim(p, axis)
        parts = 2 * n if isinstance(p, Halves) else n
        if dim is not None and shape[dim] % parts:
            bad.append(f"{path} dim {dim} of {tuple(shape)}")
    shapes = param_shapes(cfg)
    for name in place:
        if name != "layers":
            _walk(check, name, shapes[name], place[name])
    kinds = set()
    for i, layer in enumerate(place["layers"]):
        kind = _kind(layer)
        if kind not in kinds:
            kinds.add(kind)
            _walk(check, f"layers/{i}", shapes["layers"][i], layer)
    if bad:
        raise ValueError(
            f"{cfg.name}: {'; '.join(bad)} does not split over the "
            f"{axis} axis's {n} ranks")
    if place["layers"] and "mamba" in place["layers"][0]:
        mamba = place["layers"][0]["mamba"]
        if _dim(mamba["w_zx"], axis) is not None and \
                _dim(mamba["w_dt"], axis) is None:
            sc = cfg.ssm
            raise ValueError(
                f"{cfg.name}: layers/0/mamba/w_zx splits its "
                f"{sc.expand * cfg.d_model} inner channels over the {axis} "
                f"axis's {n} ranks but its "
                f"{sc.expand * cfg.d_model // sc.head_dim} SSM heads "
                f"(layers/0/mamba/w_dt) do not split: a head's "
                f"{sc.head_dim} channels would be cut across ranks")


def _kind(layer: dict) -> tuple:
    """A layer's kind as its tree's shape (its keys, nested)."""
    return tuple((k, _kind(v) if isinstance(v, dict) else None)
                 for k, v in layer.items())


def _walk(fn, path: str, shapes: PyTree, place: PyTree) -> None:
    if isinstance(place, dict):
        for k in place:
            _walk(fn, f"{path}/{k}", shapes[k], place[k])
    else:
        fn(path, shapes, place)


def placements(cfg: ModelConfig, par, mesh) -> PyTree:
    """Each parameter's placement (``sharding.param_sharding``; a
    ``Halves`` leaf's a ``Halves`` placement), after ``check_splits``."""
    axes = param_axes(cfg)
    place = sharding._map_leaves(
        lambda p, a: Halves(p) if isinstance(a, Halves) else p,
        sharding.param_sharding(axes, cfg, par, mesh), axes,
        is_leaf=sharding._is_leaf)
    check_splits(cfg, place, mesh, par.model_axis)
    return place


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
    sliced to the rank's block of its sharded dim (a copy; a ``Halves``
    leaf the rank's block of each half, side by side), the others kept.
    ``requires_grad`` follows the leaf."""
    n = context.axis_size(mesh, axis)
    r = context.axis_index(mesh, axis)

    def cut(leaf, p):
        d = _dim(p, axis)
        if d is None:
            return leaf
        parts = leaf.detach().chunk(2, d) if isinstance(p, Halves) \
            else (leaf.detach(),)
        if leaf.shape[d] % (n * len(parts)):
            raise ValueError(f"dim {d} of {tuple(leaf.shape)} does not split "
                             f"over {n} ranks")
        size = parts[0].shape[d] // n
        out = torch.cat([x.narrow(d, r * size, size) for x in parts], d)
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
        if d is None:
            return leaf
        whole = all_gather(leaf, d, group)
        if not isinstance(p, Halves):
            return whole
        halves = [x.chunk(2, d) for x in whole.split(leaf.shape[d], d)]
        return torch.cat([h[0] for h in halves] + [h[1] for h in halves], d)
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
