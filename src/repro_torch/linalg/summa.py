"""SUMMA on a process grid (executable counterpart of §V models).

Per step k: the owners of A's k-th block column broadcast their block along
grid rows, the owners of B's k-th block row broadcast along grid columns,
then every rank accumulates a local product.  The broadcast is a
select-and-reduce (mask the owner, sum over the axis).

2.5D: c layers each execute the contiguous chunk of s = g/c of the g steps
(offset l*s), partial C summed over the layer axis.

The overlap variants start the broadcasts of step k+1's panels before the
product of step k and wait for them after it; the serialized variants
broadcast them after it.  The collectives come from the grid's backend
(``grid.comm``).
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from .grid import Grid, grid_size, n_layers

MatMul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _default_mm(a, b):
    return torch.matmul(a, b)


def _panels_start(comm, a, b, k):
    """Start the select-and-reduce broadcasts of A's block-col k and B's
    block-row k."""
    return comm.bcast_start(a, "col", k), comm.bcast_start(b, "row", k)


def _summa_body(a, b, *, comm, steps: int, layers: int, s: int,
                local_mm: MatMul, overlap: bool):
    base = comm.axis_index("lyr", a) * s if layers > 1 else 0
    c = None
    if overlap:
        ha, hb = _panels_start(comm, a, b, base)
        ap, bp = comm.wait(ha), comm.wait(hb)
        for k in range(steps):
            if k + 1 < steps:
                # prefetch the panels for k+1 before this step's product
                ha, hb = _panels_start(comm, a, b, base + k + 1)
            prod = local_mm(ap, bp)
            c = prod if c is None else c + prod
            if k + 1 < steps:
                ap, bp = comm.wait(ha), comm.wait(hb)
    else:
        for k in range(steps):
            if c is not None:
                (c,) = comm.barrier(c)
            ap = comm.bcast_from(a, "col", base + k)
            bp = comm.bcast_from(b, "row", base + k)
            prod = local_mm(ap, bp)
            c = prod if c is None else c + prod
    if layers > 1:
        c = comm.psum(c, "lyr")
    return c


def _make(grid: Grid, *, overlap: bool, local_mm: Optional[MatMul] = None):
    g = grid_size(grid)
    layers = n_layers(grid)
    if layers > 1 and g % layers != 0:
        raise ValueError(f"layers c={layers} must divide grid g={g}")
    s = g // layers if layers > 1 else g
    return functools.partial(_summa_body, comm=grid.comm, steps=s,
                             layers=layers, s=s,
                             local_mm=local_mm or _default_mm,
                             overlap=overlap)


def make(grid: Grid, variant: str, *, local_mm: Optional[MatMul] = None):
    """Reusable executor: distributed (A, B) -> distributed C for the
    given variant (the 2d/2.5d split is carried by the grid's layer
    axis)."""
    return _make(grid, overlap=variant.endswith("ovlp"), local_mm=local_mm)


def summa_2d(A, B, *, grid: Grid, local_mm: Optional[MatMul] = None):
    return _make(grid, overlap=False, local_mm=local_mm)(A, B)


def summa_2d_ovlp(A, B, *, grid: Grid, local_mm: Optional[MatMul] = None):
    return _make(grid, overlap=True, local_mm=local_mm)(A, B)


def summa_25d(A, B, *, grid: Grid, local_mm: Optional[MatMul] = None):
    return _make(grid, overlap=False, local_mm=local_mm)(A, B)


def summa_25d_ovlp(A, B, *, grid: Grid, local_mm: Optional[MatMul] = None):
    return _make(grid, overlap=True, local_mm=local_mm)(A, B)
