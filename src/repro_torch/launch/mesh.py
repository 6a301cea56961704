"""Production meshes (the port of the JAX package's ``launch/mesh.py``).

Defined as FUNCTIONS (never module-level constants): importing this module
touches no process-group state.  Each builds a `DeviceMesh` over the
default process group, which the caller initialises (the dry-run uses a
fake one, `launch/dryrun.py`).

Shapes, kept from the JAX package so that every config's
``rules_overrides`` (chosen for a 16-way model axis) and the per-device
shard shapes carry over:
  single pod : (16, 16)    dims ("data", "model")        = 256 ranks
  multi-pod  : (2, 16, 16) dims ("pod", "data", "model") = 512 ranks
The "pod" dim is pure data parallelism (its only traffic is the periodic
parameter average, `train/compression.py`); "model" carries the TP/EP/SP
collectives.
"""
from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"the {'multi-pod' if multi_pod else 'single-pod'} "
                         f"mesh {shape} needs {math.prod(shape)} ranks; the "
                         f"process group has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(data: int = 1, model: int = 1, *,
                   device_type: str = "cuda"):
    """Small ("data", "model") mesh over the ranks that exist (CPU tests,
    examples): each dim is cut to what the world size allows, and the
    mesh covers data × model ranks, which must be all of them."""
    n = dist.get_world_size()
    data = min(data, n)
    model = min(model, max(1, n // data))
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=("data", "model"))


def mesh_devices(mesh) -> int:
    return int(mesh.size())


def validate_mesh(mesh) -> None:
    names = mesh.mesh_dim_names
    assert "data" in names and "model" in names, names
