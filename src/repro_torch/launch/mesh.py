"""Production mesh construction.

Port of ``repro.launch.mesh``.  Functions, not module constants, so that
importing this module makes no process group: the caller initializes
``torch.distributed`` (its address, world size and rank) first, and each
function raises unless it has.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.distributed import sharding


def _mesh(shape: tuple, axes: tuple, device: str) -> DeviceMesh:
    sharding.require_group("make mesh")
    world = dist.get_world_size()
    n = 1
    for s in shape:
        n *= s
    if n != world:
        raise ValueError(f"a {shape} mesh needs {n} ranks; the world has "
                         f"{world}")
    return DeviceMesh(device, torch.arange(world).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device: str = "cuda") -> DeviceMesh:
    """16x16 = 256 ranks per pod; multi_pod adds a leading 2-pod axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def make_host_mesh(device: str = "cuda") -> DeviceMesh:
    """Every rank of the world on one 'data' axis (tests / examples)."""
    sharding.require_group("make_host_mesh")
    return _mesh((dist.get_world_size(),), ("data",), device)


def make_mesh(shape: tuple, axes: tuple, device: str = "cuda") -> DeviceMesh:
    """A mesh of ``shape`` named ``axes`` over the whole world, ranks in
    row-major order (e.g. (2, 2) over ("data", "model"))."""
    return _mesh(tuple(shape), tuple(axes), device)
