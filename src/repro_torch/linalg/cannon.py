"""Cannon's matrix-multiplication algorithm on a stacked-rank grid.

Executable counterparts of the paper's models (§V-A):

* ``cannon_2d``        — p = g*g ranks, initial skew + g-step shift loop.
* ``cannon_2d_ovlp``   — same, but the step-(i+1) shifts are started before
  the step-i product and waited for after it: the group backend's ranks
  overlap them with the product; the stacked backend computes them at once,
  so the work and its order are the same.
* ``cannon_25d``/``_ovlp`` — c replication layers; each layer executes a
  contiguous chunk of s = g/c of the g shift steps starting from its own
  skew offset, partial C combined with a sum over the layer axis (the
  model's ``T_reduce`` term).  Inputs arrive replicated over layers.

The initial skew (block (i,j) -> (i, j-i)) is rank-dependent, but it is a
fixed permutation of the flattened (lyr, row, col) grid: one index gather
stacked, one exchange a rank on a group.  The collectives come from the
grid's backend (``grid.comm``).

All local products go through ``local_mm`` so the matmul kernel
(repro_torch.kernels.matmul) can be swapped in for ``torch.matmul``.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from .grid import Grid, grid_size, n_layers

MatMul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _default_mm(a, b):
    return torch.matmul(a, b)


def _skew_perm(g: int, axis_is_row: bool, offset_sign: int, extra: int = 0,
               layers: int = 1, s: int = 1):
    """Permutation of the flattened (lyr, row, col) grid implementing the
    Cannon skew: A block (i, j) -> (i, j - i - l*s); B block (i, j) ->
    (i - j - l*s, j).  ``offset_sign`` folds direction."""
    perm = []
    for l in range(layers):
        for i in range(g):
            for j in range(g):
                src = (l * g + i) * g + j
                off = (i if axis_is_row else j) + l * s
                if axis_is_row:
                    dst = (l * g + i) * g + ((j - off) % g)
                else:
                    dst = (l * g + ((i - off) % g)) * g + j
                perm.append((src, dst))
    return perm


def _cannon_body(a, b, *, comm, g: int, steps: int, layers: int, s: int,
                 local_mm: MatMul, overlap: bool):
    a = comm.permute_grid(a, _skew_perm(g, True, 1, layers=layers, s=s))
    b = comm.permute_grid(b, _skew_perm(g, False, 1, layers=layers, s=s))
    c = None
    for step in range(steps):
        more = step + 1 < steps
        if overlap:
            # comm for step+1 is started before (and independent of) this
            # step's product, and waited for after it
            if more:
                a_nxt = comm.shift_start(a, "col")
                b_nxt = comm.shift_start(b, "row")
            prod = local_mm(a, b)
            if more:
                a, b = comm.wait(a_nxt), comm.wait(b_nxt)
        else:
            prod = local_mm(a, b)
            if more:
                # serialized: the shifts wait for the product
                a, b, prod = comm.barrier(a, b, prod)
                a, b = comm.shift(a, "col"), comm.shift(b, "row")
        c = prod if c is None else c + prod
    if layers > 1:
        c = comm.psum(c, "lyr")
    return c


def _make(grid: Grid, *, overlap: bool, local_mm: Optional[MatMul] = None):
    g = grid_size(grid)
    c_layers = n_layers(grid)
    if c_layers > 1 and g % c_layers != 0:
        raise ValueError(f"layers c={c_layers} must divide grid g={g}")
    s = g // c_layers if c_layers > 1 else g
    return functools.partial(_cannon_body, comm=grid.comm, g=g, steps=s,
                             layers=c_layers, s=s,
                             local_mm=local_mm or _default_mm,
                             overlap=overlap)


def make(grid: Grid, variant: str, *, local_mm: Optional[MatMul] = None):
    """Reusable executor: distributed (A, B) -> distributed C for the
    given variant (the 2d/2.5d split is carried by the grid's layer
    axis)."""
    return _make(grid, overlap=variant.endswith("ovlp"), local_mm=local_mm)


def cannon_2d(A, B, *, grid: Grid, local_mm: Optional[MatMul] = None):
    """C = A @ B on a (row, col) grid; A, B block-distributed."""
    return _make(grid, overlap=False, local_mm=local_mm)(A, B)


def cannon_2d_ovlp(A, B, *, grid: Grid, local_mm: Optional[MatMul] = None):
    return _make(grid, overlap=True, local_mm=local_mm)(A, B)


def cannon_25d(A, B, *, grid: Grid, local_mm: Optional[MatMul] = None):
    """C = A @ B on a (lyr, row, col) grid; operands replicated over
    layers; each layer computes s = g/c of the shift steps."""
    return _make(grid, overlap=False, local_mm=local_mm)(A, B)


def cannon_25d_ovlp(A, B, *, grid: Grid, local_mm: Optional[MatMul] = None):
    return _make(grid, overlap=True, local_mm=local_mm)(A, B)
