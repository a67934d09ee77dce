"""Mesh construction (port of the reference package's ``launch/mesh.py``,
on ``torch.distributed``).  Functions, not module constants: importing
this module touches no device and no process group.

A mesh is a :class:`~torch.distributed.device_mesh.DeviceMesh` over the
default process group, which the caller starts first (NCCL on the card,
gloo on the CPU, the ``fake`` backend for the dry-run's 256 or 512
ranks).  Meshes are on ``cuda`` unless the caller passes
``device_type="cpu"``.
"""
from __future__ import annotations

from typing import Tuple

from repro_torch.models.partition import AxisInfo


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], *,
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default group
    (its world size must equal the product of ``shape``)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """Single pod: (data=16, model=16) = 256 ranks.  Multi-pod: (pod=2,
    data=16, model=16) = 512 ranks.  Only the dry-run's fake group has
    that many."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)


def make_axis_info(mesh, *, shard_batch: bool = True) -> AxisInfo:
    names = tuple(mesh.mesh_dim_names)
    data = tuple(n for n in names if n in ("pod", "data"))
    return AxisInfo(mesh=mesh, data=data, model="model",
                    shard_batch=shard_batch)


def make_host_mesh(shape: Tuple[int, ...] = (1, 1),
                   axes: Tuple[str, ...] = ("data", "model"), *,
                   device_type: str = "cuda"):
    """A small mesh over however many ranks the group has (the tests'
    gloo worlds, one card's world of 1)."""
    return make_mesh(shape, axes, device_type=device_type)
