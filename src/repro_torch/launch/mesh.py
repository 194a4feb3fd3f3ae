"""Mesh construction; PyTorch port of ``repro.launch.mesh``.

Single pod: (16, 16) = 256 ranks, dims (data, model).
Multi-pod : (2, 16, 16) = 512 ranks, dims (pod, data, model) — ``pod`` is
the outer data-parallel dim.

Functions, not module-level constants: importing this module touches no
process-group state.  Each returns a ``DeviceMesh`` over the ranks of the
default process group (``torch.distributed``; ``init_device_mesh``
starts it from the environment where it is not yet started), on CUDA
unless the caller passes ``device_type="cpu"`` (gloo ranks).  The
Trainer's mesh branch takes these meshes (``Trainer(mesh=...)``).
"""
from __future__ import annotations

import math

import torch.distributed as dist


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _mesh(device_type: str, shape, names):
    import torch
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    n = math.prod(shape)
    if _world() == n:
        return init_device_mesh(device_type, shape, mesh_dim_names=names)
    return DeviceMesh(device_type, torch.arange(n).view(shape),
                      mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """(data 16, model 16), or with ``multi_pod`` (pod 2, data 16, model
    16), over the first 256 or 512 ranks; raises ``RuntimeError`` when
    the world is smaller."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    if _world() < n:
        raise RuntimeError(f"need {n} ranks, have {_world()}: start "
                           f"{n} processes in one process group")
    return _mesh(device_type, shape, names)


def make_host_mesh(model: int = 1, device_type: str = "cuda"):
    """(data world / model, model) over every rank of the world — tests
    and examples."""
    n = _world()
    assert n % model == 0
    return _mesh(device_type, (n // model, model), ("data", "model"))
