"""Logical-axis → mesh-axis rules and the placements they give: the port of
``src/repro/distributed/sharding.py`` (``derive_parallel`` at line 39,
``axis_rules`` 54, ``param_sharding`` 103, ``add_data_axis`` 117,
``optimizer_sharding`` 143, ``fsdp_param_sharding`` 152, ``batch_spec``
163).

Pure functions of a config and the mesh's axis sizes.  A **placement** is a
tuple with one entry per dimension: a mesh axis, a tuple of axes, or None
(replicated along that dimension), the entries of the reference's
``PartitionSpec``, which writes a tuple of one axis as that axis.  The
reference wrapped each in a ``NamedSharding``; the
port has no such object to hold, so it returns the tuple.  ``mesh`` is a
``torch.distributed`` ``DeviceMesh`` or a plain ``{axis: size}`` dict (in
axis order), so placements can be computed without a process group.

Parameters are annotated with *logical* axes ("embed", "ffn", "heads",
"vocab", "expert", "inner", …), trees whose leaves are tuples of them, as
the reference's ``split_params`` gives.  The rules choose per
architecture:

* ``heads`` / ``kv_heads`` map to the model axis only when the head count
  divides it; otherwise attention runs sequence-parallel ("sequence"
  attn_mode): its weights still shard over ``qkv_out`` / ``kv_out`` when
  the model axis divides H·hd (Hkv·hd for ``kv_out``), and it is the
  activations that are resharded (q by rows, K/V whole);
* ``expert`` maps to the model axis when the (padded) expert count divides
  it, else the experts replicate and ``expert_ffn`` shards;
* ``vocab`` shards over the model axis when it divides.

The train step executes the data axes (``training/train_step.py``) and,
for a dense decoder, the model axis's entries of these placements
(``distributed/tensor_parallel.py``); the data axes inside a placement
(FSDP / ZeRO) are not executed yet.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

from repro_torch.configs.base import ModelConfig, ParallelConfig

PyTree = Any


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` (or of such a dict)."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}


def _map_leaves(fn: Callable, tree: PyTree, *rest: PyTree,
                is_leaf: Callable) -> PyTree:
    """``fn`` over corresponding leaves of dict / list trees whose leaves
    ``is_leaf`` picks (a placement or an axes tuple is a leaf, not a node)."""
    if is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, tree[k], *(r[k] for r in rest),
                               is_leaf=is_leaf) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, c, *(r[i] for r in rest),
                                      is_leaf=is_leaf)
                          for i, c in enumerate(tree))
    return fn(tree, *rest)


def _entry(axes: tuple):
    """A placement entry over ``axes``: one axis by its name, as
    ``PartitionSpec`` normalises it, several as a tuple."""
    return axes[0] if len(axes) == 1 else tuple(axes)


def _is_leaf(x) -> bool:
    """An axes tuple or a placement: a tuple of None, names, or tuples of
    names (a leaf, not a node, of the trees here)."""
    return isinstance(x, tuple) and all(
        a is None or isinstance(a, str)
        or (isinstance(a, tuple) and all(isinstance(n, str) for n in a))
        for a in x)


def derive_parallel(cfg: ModelConfig, mesh,
                    base: Optional[ParallelConfig] = None) -> ParallelConfig:
    """Pick the attention sharding mode valid for this arch and mesh."""
    sizes = axis_sizes(mesh)
    base = base or ParallelConfig(
        data_axes=tuple(a for a in sizes if a != "model"))
    mp = sizes[base.model_axis]
    attn_mode = "heads" if cfg.num_heads % mp == 0 else "sequence"
    return ParallelConfig(
        data_axes=base.data_axes, model_axis=base.model_axis,
        attn_mode=attn_mode, seq_sharded_norms=base.seq_sharded_norms,
        grad_reduce_dtype=base.grad_reduce_dtype,
        microbatches=base.microbatches)


def axis_rules(cfg: ModelConfig, par: ParallelConfig, mesh) -> dict:
    """Logical axis → mesh axis (or None) for this arch, mode and mesh."""
    mp = axis_sizes(mesh)[par.model_axis]
    m = par.model_axis
    heads = m if par.attn_mode == "heads" else None
    kv_heads = m if (par.attn_mode == "heads"
                     and cfg.num_kv_heads % mp == 0) else None
    expert = expert_ffn = None
    if cfg.moe is not None:
        e_pad = cfg.moe.pad_experts_to or cfg.moe.num_experts
        if cfg.moe.shard_mode == "expert" and e_pad % mp == 0:
            expert = m
        else:
            expert_ffn = m
    inner = m       # SSM / xLSTM inner channel dim (configs keep it divisible)
    if cfg.xlstm is not None and (cfg.xlstm.expand * cfg.d_model) % mp != 0:
        inner = None
    if cfg.ssm is not None and (cfg.ssm.expand * cfg.d_model) % mp != 0:
        inner = None
    inner_heads = None  # per-head SSM params are tiny; replicate
    hd = cfg.resolved_head_dim
    qkv_out = m if (cfg.num_heads * hd) % mp == 0 else None
    # kv projections: shardable when sequence-parallel (activations
    # resharded) or when the kv heads divide; replicated otherwise
    if par.attn_mode == "sequence":
        kv_out = m if (cfg.num_kv_heads * hd) % mp == 0 else None
    else:
        kv_out = m if cfg.num_kv_heads % mp == 0 else None
    sc = cfg.ssm
    if sc is not None and (sc.expand * cfg.d_model // sc.head_dim) % mp == 0:
        inner_heads = m       # SSM heads / states shard with the inner dim
    return {
        "embed": None,
        "ffn": m if cfg.d_ff % mp == 0 or cfg.d_ff == 0 else None,
        "vocab": m if cfg.vocab_size % mp == 0 else None,
        "heads": heads,
        "kv_heads": kv_heads,
        "qkv_out": qkv_out,
        "kv_out": kv_out,
        "expert": expert,
        "expert_ffn": expert_ffn,
        "inner": inner,
        "inner_heads": inner_heads,
        "layers": None,
        None: None,
    }


def param_sharding(axes_tree: PyTree, cfg: ModelConfig, par: ParallelConfig,
                   mesh) -> PyTree:
    """Each parameter's logical axes → its placement."""
    rules = axis_rules(cfg, par, mesh)
    return _map_leaves(lambda axes: tuple(rules.get(a) for a in axes),
                       axes_tree, is_leaf=_is_leaf)


def add_data_axis(spec: tuple, shape: tuple, mesh, par: ParallelConfig,
                  *, min_bytes: int = 1 << 20,
                  bytes_per_elem: int = 4) -> tuple:
    """ZeRO / FSDP-style extra sharding: the data axes on the first free
    dim divisible by the data-parallel degree, for leaves of at least
    ``min_bytes``; a leaf already data-sharded keeps its placement."""
    sizes = axis_sizes(mesh)
    n = 1
    for a in par.data_axes:
        n *= sizes[a]
    if n == 1:
        return spec
    size = bytes_per_elem
    for dim in shape:
        size *= int(dim)
    if size < min_bytes:
        return spec
    used = {a for part in spec if part
            for a in (part if isinstance(part, tuple) else (part,))}
    if used & set(par.data_axes):
        return spec
    parts = list(spec) + [None] * (len(shape) - len(spec))
    for i, dim in enumerate(shape):
        if parts[i] is None and dim % n == 0:
            parts[i] = _entry(par.data_axes)
            return tuple(parts)
    return spec


def optimizer_sharding(p_sh: PyTree, like: PyTree, mesh,
                       par: ParallelConfig) -> PyTree:
    """Placements of the fp32 optimizer moments: the parameter's plus the
    data axes.  ``like`` holds leaves with a ``shape`` (tensors, or
    tensors on the ``meta`` device)."""
    return _map_leaves(
        lambda sh, leaf: add_data_axis(sh, tuple(leaf.shape), mesh, par),
        p_sh, like, is_leaf=_is_leaf)


def fsdp_param_sharding(p_sh: PyTree, like: PyTree, mesh,
                        par: ParallelConfig, *,
                        min_bytes: int = 8 << 20) -> PyTree:
    """Fully-sharded parameters: bf16 leaves of at least ``min_bytes`` take
    the data axes too."""
    return _map_leaves(
        lambda sh, leaf: add_data_axis(sh, tuple(leaf.shape), mesh, par,
                                       min_bytes=min_bytes,
                                       bytes_per_elem=2),
        p_sh, like, is_leaf=_is_leaf)


def batch_spec(par: ParallelConfig) -> tuple:
    """The batch dim over all data axes (pod × data)."""
    return (_entry(par.data_axes),)
