"""Meshes over the current ``torch.distributed`` group.

The reference lays its mesh over devices; the port lays it over the ranks
of the default group, one process a rank, row-major (the last axis varies
fastest), in the order the reference's mesh lists its devices.  Shapes:

    single-pod:  (16, 16)      axes ("data", "model")          = 256 ranks
    multi-pod:   (2, 16, 16)   axes ("pod", "data", "model")   = 512 ranks

``make_mesh(pods, data, model)`` drops the ``pod`` axis for one pod, as the
reference does.  Every rank of the group must call these functions in the
same order: each builds the mesh's subgroups (one for each axis, one for
``("pod", "data")``), and ``torch.distributed.new_group`` is collective.
A group whose size is not the product of the axes raises ``ValueError``.
"""

from __future__ import annotations

import datetime
from typing import Dict, Sequence

import torch.distributed as dist

from ..distributed.process_group import GROUP_TIMEOUT_S
from ..distributed.sharding import Mesh


def _mesh_over_group(shape: Sequence[int], axes: Sequence[str]) -> Mesh:
    if not dist.is_initialized():
        raise RuntimeError("a mesh lays its axes over the default "
                           "torch.distributed group: initialise it first")
    world, rank = dist.get_world_size(), dist.get_rank()
    n = 1
    for s in shape:
        n *= s
    if n != world:
        raise ValueError(f"mesh {dict(zip(axes, shape))} needs {n} ranks, "
                         f"the group has {world}")
    mesh = Mesh(dict(zip(axes, shape)), rank)
    groups: Dict = {}
    timeout = datetime.timedelta(seconds=GROUP_TIMEOUT_S)
    keys = list(axes)
    if "pod" in axes:
        keys.append(("pod", "data"))
    for key in keys:
        if mesh.axis_size(key) == 1:
            continue
        for ranks in mesh.subgroup_ranks(key).values():
            group = dist.new_group(ranks, timeout=timeout)   # collective
            if rank in ranks:
                groups[key] = group
    mesh.groups = groups
    return mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh_over_group(shape, axes)


def make_mesh(pods: int, data: int, model: int) -> Mesh:
    """The elastic-scale mesh: any (pods, data, model) factorization whose
    product matches the group's size."""
    if min(pods, data, model) < 1:
        raise ValueError(f"mesh axes must be >= 1, got {(pods, data, model)}")
    if pods > 1:
        return _mesh_over_group((pods, data, model), ("pod", "data", "model"))
    return _mesh_over_group((data, model), ("data", "model"))


def mesh_chips(mesh) -> int:
    n = 1
    for v in mesh.shape.values():
        n *= v
    return n
