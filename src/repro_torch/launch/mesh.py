"""Mesh builders (the reference's ``launch/mesh.py``) over
``torch.distributed.device_mesh.init_device_mesh``.

Functions, not module-level constants: importing this module touches no
process group.  A mesh spans the ranks of the default process group, which the
caller initialises (``torch.distributed.init_process_group``: NCCL on the
cards, gloo for CPU ranks).  Shapes: 16x16 = 256 devices per pod, multi-pod =
2x16x16 = 512 devices with a leading "pod" axis riding the slower links.  A
mesh never falls back to a smaller one: with too few ranks it raises.
"""

from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _mk(shape, axes, device_type: str) -> DeviceMesh:
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != n:
        raise RuntimeError(
            f"mesh {tuple(shape)} needs {n} ranks, found {have} -- start one "
            "process per device and call torch.distributed.init_process_group "
            "(world_size, rank and a tcp:// address) first")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mk(shape, axes, device_type)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *,
              device_type: str = "cuda") -> DeviceMesh:
    return _mk(shape, axes, device_type)


def make_host_mesh(data: int | None = None, model: int = 1, *,
                   device_type: str = "cuda") -> DeviceMesh:
    """``(data, model)`` mesh over every rank of the process group (tests,
    examples, one card)."""
    n = dist.get_world_size() if dist.is_initialized() else 0
    data = data or max(n // model, 1)
    return _mk((data, model), ("data", "model"), device_type)
