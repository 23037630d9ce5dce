"""Mesh construction over ``torch.distributed``.

The port of the JAX package's ``launch/mesh.py``.  Each function builds a
``DeviceMesh`` over the ranks of the default process group, which the
caller has initialised (``launch/train.py`` does, from
``COORDINATOR_ADDRESS``); every rank calls it.  The device type is
``"cuda"`` unless the caller names ``"cpu"``, and a ``"cuda"`` mesh needs
NCCL: nothing falls back to ``gloo``.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_auto_mesh(shape, axes, device_type: str = "cuda") -> DeviceMesh:
    """A mesh of ``shape`` named ``axes`` over ranks ``0 .. prod(shape)``,
    row-major."""
    if device_type == "cuda" and "nccl" not in str(dist.get_backend()):
        raise RuntimeError(f"a cuda mesh needs NCCL; the default group runs "
                           f"{dist.get_backend()}")
    n = math.prod(shape)
    return DeviceMesh(device_type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """(16, 16) as (data, model), or (2, 16, 16) with a leading "pod" data
    parallel axis: 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    if world_size() < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} ranks, found {world_size()}: start {n} "
            f"processes with COORDINATOR_ADDRESS, RANK and WORLD_SIZE set")
    return make_auto_mesh(shape, axes, device_type)


def make_host_mesh(device_type: str = "cuda") -> DeviceMesh:
    """Every rank of the job (tests / examples): N×1 (data, model)."""
    return make_auto_mesh((world_size(), 1), ("data", "model"), device_type)
