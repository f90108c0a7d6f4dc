"""Mesh builders: the port of ``src/repro/launch/mesh.py``
(``make_production_mesh``, ``make_debug_mesh``, lines 13-22).

Functions, not module-level constants: importing this module touches no
device and no process group.  Each builds a
``torch.distributed.device_mesh.DeviceMesh`` over the process group that
is already initialised (``init_device_mesh``), on ``"cuda"`` unless the
caller asks for the CPU (gloo).  A world size that does not match the
mesh raises.
"""
from __future__ import annotations


def _mesh(shape: tuple, names: tuple, device_type: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"mesh {dict(zip(names, shape))} needs {n} ranks, "
                         f"the process group has {world}")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16×16 = 256 ranks per pod; 2 pods = 512 ranks multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, names, device_type)


def make_debug_mesh(n_data: int = 2, n_model: int = 4, *,
                    device_type: str = "cuda"):
    """A small (data, model) mesh for tests and the card's world of 1."""
    return _mesh((n_data, n_model), ("data", "model"), device_type)
