"""Ambient sharding context for model and serving code: the port of
``src/repro/distributed/context.py`` (``ShardContext``, ``get``, ``use``,
lines 15-43).

The reference's ``jax.sharding.Mesh`` becomes a
``torch.distributed.device_mesh.DeviceMesh`` with dimension names
``("data", "model")`` (``launch/mesh.py`` builds it over the process group
already initialised); each axis's process group is ``group(ctx, name)``.
``None`` (unit tests, one process) means single-device semantics
everywhere.  Under a context, ``dispatch.sdpa(decode=True)`` sends the
one-token decode through the sequence-sharded ⊕ merge, the lockstep
``decode_step`` samples through the vocabulary-sharded Algorithm 4
(``distributed/decode_attention.py``), the train step all-reduces its
gradients over the data axes (``training/train_step.py``), and a dense
decoder's training forward runs tensor-parallel over the model axis
(``distributed/tensor_parallel.py``; ``model_group`` / ``model_index`` /
``model_size`` name that axis).
"""
from __future__ import annotations

import contextlib
from typing import Any, NamedTuple, Optional

from repro_torch.configs.base import ParallelConfig


class ShardContext(NamedTuple):
    mesh: Any                       # torch.distributed DeviceMesh
    par: ParallelConfig
    # mesh axes the decode KV cache's sequence dim is sharded over
    cache_seq_axes: tuple = ("model",)
    # mesh axes the batch dim is sharded over (() = replicated, e.g. batch 1)
    batch_axes: tuple = ("data",)


_CURRENT: Optional[ShardContext] = None


def get() -> Optional[ShardContext]:
    return _CURRENT


@contextlib.contextmanager
def use(ctx: Optional[ShardContext]):
    global _CURRENT
    prev = _CURRENT
    _CURRENT = ctx
    try:
        yield
    finally:
        _CURRENT = prev


def axis_size(mesh, axes) -> int:
    """Ranks along ``axes`` (a name or a tuple of names) of ``mesh``."""
    n = 1
    for a in ((axes,) if isinstance(axes, str) else axes):
        n *= mesh.size(mesh.mesh_dim_names.index(a))
    return n


def axis_index(mesh, axes) -> int:
    """This rank's index along ``axes``, row-major over them, as the
    reference's loop over ``jax.lax.axis_index`` composes it."""
    idx = 0
    for a in ((axes,) if isinstance(axes, str) else axes):
        dim = mesh.mesh_dim_names.index(a)
        idx = idx * mesh.size(dim) + mesh.get_local_rank(dim)
    return idx


def group(mesh, axes):
    """The process group of one axis of ``mesh`` (``mesh.get_group``).
    Collectives over several axes at once (the multi-pod mesh's pod ×
    data) are not executed yet and raise."""
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    if len(names) != 1:
        raise NotImplementedError(
            f"collectives over the mesh axes {names} at once are not "
            "ported: one axis a group")
    return mesh.get_group(names[0])


def model_group(ctx: ShardContext):
    """The process group of ``ctx``'s model axis."""
    return group(ctx.mesh, ctx.par.model_axis)


def model_index(ctx: ShardContext) -> int:
    """This rank's index along ``ctx``'s model axis."""
    return axis_index(ctx.mesh, ctx.par.model_axis)


def model_size(ctx: ShardContext) -> int:
    """Ranks along ``ctx``'s model axis."""
    return axis_size(ctx.mesh, ctx.par.model_axis)
