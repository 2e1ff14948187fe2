"""Process grids and block distributions for the linalg algorithms.

The counterpart of the reference's meshes.  A :class:`Grid` is a
``(layers, rows, cols)`` process grid — the paper's 2D grid plus the 2.5D
replication axis ``c`` — on one of two backends (``linalg.collectives``):

* **stacked** (no group): every rank lives in one process on one device,
  and a distributed operand is one tensor of shape ``(c, g, g, rb, cb)``,
  rank ``(l, i, j)`` owning block ``[l, i, j]``.  Entries of ``devices``
  may repeat one device (``[cuda:0] * 8``); ranks on several devices in
  one process are not a backend of the port.
* **group** (``group=`` a ``torch.distributed`` process group of the whole
  world): each process is one rank, grid rank k the group's rank k, and
  holds only its own block, shaped ``(1, 1, 1, rb, cb)``.  Ranks of the
  group beyond the grid's take no part in it (``Grid.member``).

2D grids have ``c = 1``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..devices import canonical, default_devices
from ..distributed.process_group import stages, to_device, to_host
from .collectives import STACKED, coords_of, subgroups

#: partition of a matrix over (rows, cols), replicated over the layers —
#: the reference's ``P("row", "col")``
BLOCK = ("row", "col")
#: rows over the flattened (lyr, row) axis, columns over cols — the
#: reference's ``P(("lyr", "row"), "col")`` (2.5D trsm's B and X)
ROWS_OVER_LAYERS = (("lyr", "row"), "col")


@dataclasses.dataclass(frozen=True)
class Grid:
    """A (layers, rows, cols) process grid: stacked on one device, or this
    process's rank ``rank`` of ``group`` on ``device``."""

    layers: int
    rows: int
    cols: int
    device: torch.device
    group: Optional[object] = None
    rank: int = 0
    comm: object = dataclasses.field(default=STACKED, compare=False,
                                     repr=False)

    @property
    def shape(self):
        return (self.layers, self.rows, self.cols)

    @property
    def size(self) -> int:
        return self.layers * self.rows * self.cols

    @property
    def member(self) -> bool:
        """Whether this process holds a rank of the grid (always, stacked)."""
        return self.group is None or self.rank < self.size

    @property
    def coords(self):
        """This process's (lyr, row, col) on a group grid."""
        return coords_of(self.rank, self.shape)


def make_grid_mesh(rows: int, cols: int, layers: int = 1,
                   devices: Optional[Sequence] = None, *,
                   group=None) -> Grid:
    """The grid of the calling process.

    Without ``group``, every rank stacked on the one device that
    ``devices`` (one entry a rank; default the current CUDA device) repeats.
    With ``group``, ``devices`` lists the group's ranks' devices (default:
    each on the current CUDA device) and the grid is this process's rank,
    its coordinates and its device; the grid's subgroups are created here,
    so every rank of the group makes this call, with the same shape."""
    n = rows * cols * layers
    if group is not None:
        rank = dist.get_rank(group)
        world = dist.get_world_size(group)
        devices = (list(devices) if devices is not None
                   else default_devices() * world)
        if len(devices) < world:
            raise ValueError(f"need a device for each of {world} ranks, "
                             f"have {len(devices)}")
        comm = subgroups(group, (layers, rows, cols))["comm"]
        return Grid(layers, rows, cols, canonical(devices[rank]), group,
                    rank, comm)
    devices = list(devices) if devices is not None else default_devices()
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    devs = {canonical(d) for d in devices[:n]}
    if len(devs) != 1:
        raise NotImplementedError(
            f"ranks on several devices ({sorted(map(str, devs))}) in one "
            "process: the stacked backend holds every rank on one device; "
            "repeat one device to stack them, or run one process a rank "
            "with group=")
    return Grid(layers, rows, cols, devs.pop())


def distribute(x: torch.Tensor, grid: Grid, spec=BLOCK) -> torch.Tensor:
    """Block-distribute a global matrix over the grid's ranks: the stacked
    ``(c, g, g, rb, cb)`` tensor on the grid's device, or, on a group grid,
    this rank's block shaped ``(1, 1, 1, rb, cb)`` (every rank holds the
    global matrix, as the reference's ``device_put`` of a global array)."""
    x = torch.as_tensor(x, device=grid.device)
    if spec not in (BLOCK, ROWS_OVER_LAYERS):
        raise ValueError(f"unknown partition {spec!r}")
    c, r, q = grid.shape
    rows, cols = x.shape
    split = c * r if spec == ROWS_OVER_LAYERS else r
    if rows % split or cols % q:
        raise ValueError(f"{tuple(x.shape)} does not divide over "
                         f"{split} x {q} blocks")
    if grid.group is not None:
        if not grid.member:
            raise ValueError(f"rank {grid.rank} is not on the {grid.shape} "
                             "grid")
        l, i, j = grid.coords
        bi = l * r + i if spec == ROWS_OVER_LAYERS else i
        rb, cb = rows // split, cols // q
        return x[bi * rb:(bi + 1) * rb, j * cb:(j + 1) * cb].reshape(
            1, 1, 1, rb, cb).contiguous()
    blocks = x.reshape(split, rows // split, q, cols // q).transpose(1, 2)
    if spec == ROWS_OVER_LAYERS:
        return blocks.reshape(c, r, q, rows // split, cols // q).contiguous()
    # replicated over the layers: every layer owns its own copy
    return blocks.unsqueeze(0).expand(c, *blocks.shape).contiguous()


def collect(xs: torch.Tensor, grid: Grid, spec=BLOCK) -> torch.Tensor:
    """The global matrix of a distributed operand (the inverse of
    :func:`distribute`; a layer-replicated operand is read from layer 0).
    On a group grid the ranks' blocks are all-gathered, so every rank of
    the grid gets the global matrix."""
    c, r, q = grid.shape
    rb, cb = xs.shape[-2:]
    if grid.group is not None:
        xs = _gather(xs, grid).reshape(c, r, q, rb, cb)
    if spec == ROWS_OVER_LAYERS:
        blocks = xs.reshape(c * r, q, rb, cb)
    elif spec == BLOCK:
        blocks = xs[0]
    else:
        raise ValueError(f"unknown partition {spec!r}")
    return blocks.transpose(1, 2).reshape(blocks.shape[0] * rb, q * cb)


def _gather(x: torch.Tensor, grid: Grid) -> torch.Tensor:
    """Every grid rank's block, in grid-rank order, on every grid rank;
    the host seconds count on the rank's ``comm.wait_s``."""
    t0 = time.perf_counter()
    sub = subgroups(grid.group, grid.shape)["grid"]
    staged = stages(grid.group, x)
    block = (to_host(x.contiguous()) if staged else x.contiguous()).reshape(
        x.shape[-2:])
    out = torch.empty((grid.size, *block.shape), dtype=block.dtype,
                      device=block.device, pin_memory=staged)
    with torch.profiler.record_function("comm_wait"):
        dist.all_gather(list(out.unbind(0)), block, group=sub)
    out = to_device(out, x.device) if staged else out
    grid.comm.wait_s += time.perf_counter() - t0
    return out


def grid_size(grid: Grid) -> int:
    return grid.rows


def n_layers(grid: Grid) -> int:
    return grid.layers
