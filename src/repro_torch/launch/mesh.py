"""Meshes over the current ``torch.distributed`` group.

The reference lays its mesh over devices; the port lays it over the ranks
of the default group, one process a rank, row-major (the last axis varies
fastest), in the order the reference's mesh lists its devices.  Shapes:

    single-pod:  (16, 16)      axes ("data", "model")          = 256 ranks
    multi-pod:   (2, 16, 16)   axes ("pod", "data", "model")   = 512 ranks

``make_mesh(pods, data, model)`` drops the ``pod`` axis for one pod, as the
reference does.  ``counting_mesh(shape, rank)`` is one rank of such a mesh
with no group at all: its subgroups are ``process_group.CountingGroup``
stand-ins, so a step run on it records its collectives and sends nothing
(the dry run, ``launch/dryrun.py``).  Every rank of the group must call these functions in the
same order: each builds the mesh's subgroups (one for each axis and one
for each combination of axes that a profile's batch or ZeRO rules name),
and ``torch.distributed.new_group`` is collective.  A mesh runs under the
default rules; ``mesh.with_rules(rules_for(arch, profile))`` is the same
ranks and groups under a profile's (``launch/specs.py``).
A group whose size is not the product of the axes raises ``ValueError``.
"""

from __future__ import annotations

import datetime
from typing import Dict, Sequence

import torch.distributed as dist

from ..distributed.process_group import GROUP_TIMEOUT_S, CountingGroup
from ..distributed.sharding import Mesh


#: the combinations of axes that the profiles' batch and ZeRO rules name
#: (``launch/specs.py::PROFILES``): baseline's batch, dp_sp's ZeRO axes
#: and its batch
COMBINED_AXES = (("pod", "data"), ("data", "model"), ("pod", "data", "model"))


def _subgroup_keys(shape: Dict[str, int]) -> list:
    """The mesh's subgroups, in one order on every rank: one for each axis
    of more than one rank, then one for each of ``COMBINED_AXES`` that
    keeps more than one such axis (in the mesh's order; on (2, 1, 2)
    ``("pod", "data", "model")`` is ``("pod", "model")``)."""
    keys = [a for a, n in shape.items() if n > 1]
    for combo in COMBINED_AXES:
        key = tuple(a for a in combo if shape.get(a, 1) > 1)
        if len(key) > 1 and key not in keys:
            keys.append(key)
    return keys


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
    for key in _subgroup_keys(mesh.shape):
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


def counting_mesh(shape, rank: int = 0) -> Mesh:
    """Rank ``rank`` of a mesh of ``shape`` whose subgroups record their
    collectives and send nothing: ``shape`` is ``{axis: size}``, or the
    sizes of ``(data, model)`` or ``(pod, data, model)``."""
    if not isinstance(shape, dict):
        shape = tuple(shape)
        if len(shape) not in (2, 3):
            raise ValueError(f"a mesh shape is (data, model) or (pod, data, "
                             f"model), got {shape}")
        names = ("data", "model") if len(shape) == 2 else \
            ("pod", "data", "model")
        shape = dict(zip(names, shape))
    mesh = Mesh(shape, rank)
    mesh.groups = {key: CountingGroup(mesh.axis_size(key),
                                      mesh.axis_index(key))
                   for key in _subgroup_keys(mesh.shape)}
    return mesh


def mesh_chips(mesh) -> int:
    n = 1
    for v in mesh.shape.values():
        n *= v
    return n
