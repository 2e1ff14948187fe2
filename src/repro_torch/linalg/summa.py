"""SUMMA on a stacked-rank grid (executable counterpart of §V models).

Per step k: the owners of A's k-th block column broadcast their block along
grid rows, the owners of B's k-th block row broadcast along grid columns,
then every rank accumulates a local product.  The broadcast is a
select-and-reduce (mask the owner, sum over the axis).

2.5D: c layers each execute the contiguous chunk of s = g/c of the g steps
(offset l*s), partial C summed over the layer axis.

The overlap variants fetch the panels for step k+1 before the product of
step k; the serialized variants fetch them after it.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from .collectives import axis_index, barrier, bcast_from, psum
from .grid import Grid, grid_size, n_layers

MatMul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _default_mm(a, b):
    return torch.matmul(a, b)


def _panels(a, b, k):
    """Select-and-reduce broadcasts of A's block-col k / B's block-row k."""
    return bcast_from(a, "col", k), bcast_from(b, "row", k)


def _summa_body(a, b, *, steps: int, layers: int, s: int,
                local_mm: MatMul, overlap: bool):
    base = axis_index("lyr", a) * s if layers > 1 else 0
    c = None
    if overlap:
        ap, bp = _panels(a, b, base)
        for k in range(steps):
            if k + 1 < steps:
                # prefetch the panels for k+1 before this step's product
                ap_nxt, bp_nxt = _panels(a, b, base + k + 1)
            prod = local_mm(ap, bp)
            c = prod if c is None else c + prod
            if k + 1 < steps:
                ap, bp = ap_nxt, bp_nxt
    else:
        for k in range(steps):
            if c is not None:
                (c,) = barrier(c)
            ap, bp = _panels(a, b, base + k)
            prod = local_mm(ap, bp)
            c = prod if c is None else c + prod
    if layers > 1:
        c = psum(c, "lyr")
    return c


def _make(grid: Grid, *, overlap: bool, local_mm: Optional[MatMul] = None):
    g = grid_size(grid)
    layers = n_layers(grid)
    if layers > 1 and g % layers != 0:
        raise ValueError(f"layers c={layers} must divide grid g={g}")
    s = g // layers if layers > 1 else g
    return functools.partial(_summa_body, steps=s, layers=layers, s=s,
                             local_mm=local_mm or _default_mm,
                             overlap=overlap)


def make(grid: Grid, variant: str, *, local_mm: Optional[MatMul] = None):
    """Reusable executor: stacked (A, B) -> stacked C for the given variant
    (the 2d/2.5d split is carried by the grid's layer axis)."""
    return _make(grid, overlap=variant.endswith("ovlp"), local_mm=local_mm)


def summa_2d(A, B, *, grid: Grid, local_mm: Optional[MatMul] = None):
    return _make(grid, overlap=False, local_mm=local_mm)(A, B)


def summa_2d_ovlp(A, B, *, grid: Grid, local_mm: Optional[MatMul] = None):
    return _make(grid, overlap=True, local_mm=local_mm)(A, B)


def summa_25d(A, B, *, grid: Grid, local_mm: Optional[MatMul] = None):
    return _make(grid, overlap=False, local_mm=local_mm)(A, B)


def summa_25d_ovlp(A, B, *, grid: Grid, local_mm: Optional[MatMul] = None):
    return _make(grid, overlap=True, local_mm=local_mm)(A, B)
