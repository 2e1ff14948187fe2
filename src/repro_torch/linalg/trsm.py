"""Distributed triangular solve  X * U = B  (U upper-triangular).

Executable counterpart of the paper's §V-B models.

2D (``trsm_2d``): right-looking over block columns on a (row, col) grid.
Per block-column j:
  1. broadcast U_jj (select-and-reduce over both axes — the model's
     ``T_bcast_sync`` along columns),
  2. local triangular solve on the owners of X's column j,
  3. broadcast the solved X_:j along grid rows (``T_bcast`` distance 1),
  4. broadcast U_j,: along grid columns and update the trailing matrix.

2.5D (``trsm_25d``): the paper replicates U across c layers and *scatters
the rows of X* among them — rows of X are independent, so each layer runs
the 2D algorithm on its row slice with its own (row, col) sub-grid; B and X
are partitioned over the flattened (lyr, row) axis.

Overlap variants start the broadcast of the *next* U blocks before the
trailing update and wait for it after (the paper's Pthread-dedicated-to-comm
trick); the serialized variants broadcast them after it.  U_jj is the
column-j block of the broadcast row panel U_j,:, so one row broadcast
serves both.  The collectives come from the grid's backend
(``grid.comm``).

The executable versions use r=1 block-cyclic factor (one block per process
per dimension); the performance models support general r.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from .grid import Grid, grid_size

MatMul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
#: local solve hook: (B, U) -> X with X U = B (U upper-triangular); the
#: trsm kernel plugs in here via the tuner dispatch layer.
SolveXU = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _default_mm(a, b):
    return torch.matmul(a, b)


def _solve_xu(b, u):
    """Local X U = B  =>  X = B U^{-1} (U upper)."""
    return torch.linalg.solve_triangular(u, b, upper=True, left=False)


def _trsm_body(u, b, *, comm, g: int, local_mm: MatMul,
               local_solve: SolveXU, overlap: bool):
    col = comm.axis_index("col", b)
    b_cur, x_acc = b, torch.zeros_like(b)
    # U_j,: (block row j) to all rows, and U_jj, its column-j block, to
    # everyone
    upan = comm.bcast_from(u, "row", 0)
    ujj = comm.bcast_from(upan, "col", 0)
    for j in range(g):
        more = j + 1 < g
        # 2. local solve for the owners of column j
        xj = torch.where(col == j, local_solve(b_cur, ujj), 0)
        # 3. broadcast X_:j along rows
        xj_b = comm.psum(xj, "col")
        if overlap:
            # prefetch the next U panel during the update
            if more:
                upan_nxt = comm.bcast_start(u, "row", j + 1)
        else:
            b_cur, x_acc, xj_b = comm.barrier(b_cur, x_acc, xj_b)
        # 4. trailing update: B_:k -= X_:j @ U_jk for k > j
        upd = local_mm(xj_b, upan)
        b_cur = torch.where(col > j, b_cur - upd, b_cur)
        x_acc = torch.where(col == j, xj_b, x_acc)
        if more:
            upan = (comm.wait(upan_nxt) if overlap
                    else comm.bcast_from(u, "row", j + 1))
            ujj = comm.bcast_from(upan, "col", j + 1)
    return x_acc


def _make_2d(grid: Grid, *, overlap: bool, local_mm: Optional[MatMul] = None,
             local_solve: Optional[SolveXU] = None):
    # 2.5D needs nothing more: U arrives replicated over the layers and B/X
    # rows scattered over (lyr, row), so each layer solves its own rows
    return functools.partial(_trsm_body, comm=grid.comm, g=grid_size(grid),
                             local_mm=local_mm or _default_mm,
                             local_solve=local_solve or _solve_xu,
                             overlap=overlap)


def make(grid: Grid, variant: str, *, local_mm: Optional[MatMul] = None,
         local_solve: Optional[SolveXU] = None):
    """Reusable executor: distributed (U, B) -> distributed X for the
    given variant (the 2d/2.5d split is carried by the grid's layer
    axis)."""
    return _make_2d(grid, overlap=variant.endswith("ovlp"),
                    local_mm=local_mm, local_solve=local_solve)


def trsm_2d(U, B, *, grid: Grid, local_mm: Optional[MatMul] = None,
            local_solve: Optional[SolveXU] = None):
    """Solve X U = B; U and B block-distributed on (row, col)."""
    return _make_2d(grid, overlap=False, local_mm=local_mm,
                    local_solve=local_solve)(U, B)


def trsm_2d_ovlp(U, B, *, grid: Grid, local_mm: Optional[MatMul] = None,
                 local_solve: Optional[SolveXU] = None):
    return _make_2d(grid, overlap=True, local_mm=local_mm,
                    local_solve=local_solve)(U, B)


def trsm_25d(U, B, *, grid: Grid, local_mm: Optional[MatMul] = None,
             local_solve: Optional[SolveXU] = None):
    """2.5D: grid (lyr, row, col); U replicated per layer, B rows
    scattered across layers."""
    return _make_2d(grid, overlap=False, local_mm=local_mm,
                    local_solve=local_solve)(U, B)


def trsm_25d_ovlp(U, B, *, grid: Grid, local_mm: Optional[MatMul] = None,
                  local_solve: Optional[SolveXU] = None):
    return _make_2d(grid, overlap=True, local_mm=local_mm,
                    local_solve=local_solve)(U, B)
