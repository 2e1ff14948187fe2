"""Process grids and block distributions for the linalg algorithms.

The counterpart of the reference's meshes.  A :class:`Grid` is a
``(layers, rows, cols)`` process grid — the paper's 2D grid plus the 2.5D
replication axis ``c`` — whose ranks all live in one process on one device:
a distributed operand is one tensor of shape ``(c, g, g, rb, cb)``, rank
``(l, i, j)`` owning block ``[l, i, j]``.  2D grids have ``c = 1``.  Entries
of ``devices`` may repeat one device (``[cuda:0] * 8``); ranks spread over
several devices need the ``torch.distributed`` backend of a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from ..devices import canonical, default_devices

#: partition of a matrix over (rows, cols), replicated over the layers —
#: the reference's ``P("row", "col")``
BLOCK = ("row", "col")
#: rows over the flattened (lyr, row) axis, columns over cols — the
#: reference's ``P(("lyr", "row"), "col")`` (2.5D trsm's B and X)
ROWS_OVER_LAYERS = (("lyr", "row"), "col")


@dataclasses.dataclass(frozen=True)
class Grid:
    """A (layers, rows, cols) process grid stacked on one device."""

    layers: int
    rows: int
    cols: int
    device: torch.device

    @property
    def shape(self):
        return (self.layers, self.rows, self.cols)


def make_grid_mesh(rows: int, cols: int, layers: int = 1,
                   devices: Optional[Sequence] = None) -> Grid:
    n = rows * cols * layers
    devices = list(devices) if devices is not None else default_devices()
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    devs = {canonical(d) for d in devices[:n]}
    if len(devs) != 1:
        raise NotImplementedError(
            f"ranks on several devices ({sorted(map(str, devs))}) need the "
            "torch.distributed backend, a later slice of the port; repeat "
            "one device to stack every rank on it")
    return Grid(layers, rows, cols, devs.pop())


def distribute(x: torch.Tensor, grid: Grid, spec=BLOCK) -> torch.Tensor:
    """Block-distribute a global matrix over the grid's ranks: returns the
    stacked ``(c, g, g, rb, cb)`` tensor on the grid's device."""
    x = torch.as_tensor(x, device=grid.device)
    if spec not in (BLOCK, ROWS_OVER_LAYERS):
        raise ValueError(f"unknown partition {spec!r}")
    c, r, q = grid.shape
    rows, cols = x.shape
    split = c * r if spec == ROWS_OVER_LAYERS else r
    if rows % split or cols % q:
        raise ValueError(f"{tuple(x.shape)} does not divide over "
                         f"{split} x {q} blocks")
    blocks = x.reshape(split, rows // split, q, cols // q).transpose(1, 2)
    if spec == ROWS_OVER_LAYERS:
        return blocks.reshape(c, r, q, rows // split, cols // q).contiguous()
    # replicated over the layers: every layer owns its own copy
    return blocks.unsqueeze(0).expand(c, *blocks.shape).contiguous()


def collect(xs: torch.Tensor, grid: Grid, spec=BLOCK) -> torch.Tensor:
    """The global matrix of a stacked operand (the inverse of
    :func:`distribute`; a layer-replicated operand is read from layer 0)."""
    c, r, q = grid.shape
    rb, cb = xs.shape[-2:]
    if spec == ROWS_OVER_LAYERS:
        blocks = xs.reshape(c * r, q, rb, cb)
    elif spec == BLOCK:
        blocks = xs[0]
    else:
        raise ValueError(f"unknown partition {spec!r}")
    return blocks.transpose(1, 2).reshape(blocks.shape[0] * rb, q * cb)


def grid_size(grid: Grid) -> int:
    return grid.rows


def n_layers(grid: Grid) -> int:
    return grid.layers
