"""Distributed Cholesky factorization  A = L L^T  (right-looking, blocked).

Executable counterpart of the §V-style models (the paper models Cholesky
with the same methodology; only Cannon/TRSM equations are printed).

2D: per block-column j on a (row, col) grid:
  1. factor the diagonal block (owner of (j,j); select-and-reduce bcast),
  2. panel solve on column-j owners:  L_ij = A_ij L_jj^{-T},
  3. broadcast the panel along rows; broadcast the *transposed* panel along
     columns (one joint-grid permutation moves block (k,j) -> (j,k)),
  4. trailing update  A_ik -= L_ij L_kj^T  for i,k > j.

2.5D: A replicated over c layers; the trailing update is column-striped
across layers (layer l owns trailing columns with col % c == l) into a
layer-local accumulator; the pivot column is combined with a sum over the
layer axis right before it is factored (the model's ``layer_reduce``
term).  Panel work is replicated across layers — communication, not flops,
is what 2.5D saves.

The serialized variants put a barrier between the panel broadcasts and the
trailing update.  The overlap variants look ahead: the first collective of
step j+1 (2D: the row broadcast of the diagonal block; 2.5D: the layers'
sum of the pivot column's updates) reads only the ranks of column j+1.  A
rank outside that column starts it before its own step-j product and waits
for it after; a rank of that column runs its product first.  So on the
group backend every other rank's product overlaps the pivot column's; the
stacked backend runs every product first, in the serialized order.  The
collectives come from the grid's backend (``grid.comm``).

Every rank computes its local solve and product even where the masks
discard the result (as the reference does): at p = 1 that is a full-size
panel solve and a full-size trailing product besides the factor.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from .grid import Grid, grid_size, n_layers

MatMul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
#: local diagonal factor hook: A_jj -> L_jj (lower Cholesky factor)
Chol = Callable[[torch.Tensor], torch.Tensor]
#: local panel solve hook: (A, L_jj) -> A L_jj^{-T}
PanelSolve = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _default_mm(a, b):
    return torch.matmul(a, b)


def _default_chol(a):
    return torch.linalg.cholesky(a)


def _default_panel_solve(a, ljj):
    """A L_jj^{-T}: solve X L_jj^T = A (L_jj^T upper-triangular)."""
    return torch.linalg.solve_triangular(ljj.mT, a, upper=True, left=False)


def _transpose_perm(g: int, layers: int = 1):
    perm = []
    for l in range(layers):
        for i in range(g):
            for j in range(g):
                perm.append(((l * g + i) * g + j, (l * g + j) * g + i))
    return perm


def _chol_body(a, *, comm, g: int, layers: int, local_mm: MatMul,
               local_chol: Chol, local_solve: PanelSolve, overlap: bool):
    row = comm.axis_index("row", a)
    col = comm.axis_index("col", a)
    lyr = comm.axis_index("lyr", a) if layers > 1 else 0
    tperm = _transpose_perm(g, layers)

    def pivot_start(j, acc):
        """Start step j's first collective; only column j's ranks' values
        reach its result."""
        if layers > 1:
            # combine the pivot column's partial updates across layers
            return comm.psum_start(torch.where(col == j, acc, 0), "lyr")
        return comm.bcast_start(a - acc, "row", j)

    def pivot(j, handle, acc):
        """Step j's effective matrix and its diagonal block, everywhere."""
        if layers > 1:
            pivot_fix = comm.wait(handle)
            a_eff = a - torch.where(col == j, pivot_fix, 0)
            return a_eff, comm.bcast_from(comm.bcast_from(a_eff, "row", j),
                                          "col", j)
        return a - acc, comm.bcast_from(comm.wait(handle), "col", j)

    acc = torch.zeros_like(a)
    l_acc = torch.zeros_like(a)
    handle = pivot_start(0, acc)
    for j in range(g):
        more = j + 1 < g
        # 1. diagonal factor
        a_eff, ajj = pivot(j, handle, acc)
        ljj = local_chol(ajj)
        # 2. panel solve: L_ij = A_ij L_jj^{-T}
        panel = local_solve(a_eff, ljj)
        lj = torch.where((col == j) & (row > j), panel, 0)
        lj = lj + torch.where((col == j) & (row == j), ljj, 0)
        # 3. panel along rows; transposed panel along columns
        lj_row = comm.psum(lj, "col")
        ljT = comm.permute_grid(lj, tperm)
        lkj = comm.psum(torch.where(row == j, ljT, 0), "row")
        if not overlap:
            acc, lj_row, lkj = comm.barrier(acc, lj_row, lkj)
        # look-ahead: outside column j+1, step j+1's first collective does
        # not wait for this rank's product
        ahead = overlap and more and not comm.computes_first(col == j + 1)
        if ahead:
            handle = pivot_start(j + 1, acc)
        # 4. trailing update
        upd = local_mm(lj_row, lkj.mT)
        trailing = (row > j) & (col > j)
        if layers > 1:
            trailing = trailing & ((col % layers) == lyr)
        acc = acc + torch.where(trailing, upd, 0)
        l_acc = torch.where(col == j, lj_row, l_acc)
        if more and not ahead:
            handle = pivot_start(j + 1, acc)
    if layers > 1:
        # All layers computed identical panels; select layer 0's copy via a
        # reduction over the layer axis — the model's gather_L term.
        l_acc = comm.psum(torch.where(lyr == 0, l_acc, 0), "lyr")
    # mask strictly-upper blocks and the upper triangle of diagonal blocks
    l_acc = torch.where(row == col, torch.tril(l_acc), l_acc)
    return torch.where(row < col, 0, l_acc)


def _make(grid: Grid, *, overlap: bool, local_mm: Optional[MatMul] = None,
          local_chol: Optional[Chol] = None,
          local_solve: Optional[PanelSolve] = None):
    return functools.partial(_chol_body, comm=grid.comm, g=grid_size(grid),
                             layers=n_layers(grid),
                             local_mm=local_mm or _default_mm,
                             local_chol=local_chol or _default_chol,
                             local_solve=local_solve or _default_panel_solve,
                             overlap=overlap)


def make(grid: Grid, variant: str, *, local_mm: Optional[MatMul] = None,
         local_chol: Optional[Chol] = None,
         local_solve: Optional[PanelSolve] = None):
    """Reusable executor: distributed A -> distributed L for the given
    variant (the 2d/2.5d split is carried by the grid's layer axis)."""
    return _make(grid, overlap=variant.endswith("ovlp"), local_mm=local_mm,
                 local_chol=local_chol, local_solve=local_solve)


def cholesky_2d(A, *, grid: Grid, local_mm: Optional[MatMul] = None,
                local_chol: Optional[Chol] = None,
                local_solve: Optional[PanelSolve] = None):
    """L with A = L L^T; A block-distributed on (row, col)."""
    return make(grid, "2d", local_mm=local_mm, local_chol=local_chol,
                local_solve=local_solve)(A)


def cholesky_2d_ovlp(A, *, grid: Grid, local_mm: Optional[MatMul] = None,
                     local_chol: Optional[Chol] = None,
                     local_solve: Optional[PanelSolve] = None):
    return make(grid, "2d_ovlp", local_mm=local_mm, local_chol=local_chol,
                local_solve=local_solve)(A)


def cholesky_25d(A, *, grid: Grid, local_mm: Optional[MatMul] = None,
                 local_chol: Optional[Chol] = None,
                 local_solve: Optional[PanelSolve] = None):
    """2.5D on a (lyr, row, col) grid; A replicated over layers."""
    return make(grid, "2.5d", local_mm=local_mm, local_chol=local_chol,
                local_solve=local_solve)(A)


def cholesky_25d_ovlp(A, *, grid: Grid, local_mm: Optional[MatMul] = None,
                      local_chol: Optional[Chol] = None,
                      local_solve: Optional[PanelSolve] = None):
    return make(grid, "2.5d_ovlp", local_mm=local_mm, local_chol=local_chol,
                local_solve=local_solve)(A)
