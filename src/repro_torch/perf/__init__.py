"""repro_torch.perf — the composable cost-IR behind every performance model.

The paper's methodology (§IV-V) builds every algorithm model from three
ingredients — local-routine times ``T_rout``, calibrated transfers
``T_comm`` / ``T_comm_sync``, and analytic collective schedules — combined
by sequencing, loops, and max-overlap.  This package makes that composition
first-class:

  expr.py      symbolic scenario parameters (n, p, c, r, q, d) and the
               closed-form sums that collapse triangular loops
  ir.py        the node set: Compute, P2P, SyncP2P, Collective, Seq,
               Loop, Overlap — and Program, a registered model
  evaluate.py  the evaluator: calibration applied in exactly one place,
               est_Cal / est_NoCal / est_ideal chosen by EvalOptions,
               vectorized over numpy grids of scenarios
  models.py    the paper's 16 variants + LU 2D/2.5D as IR programs

Scalar call sites keep working through ``repro_torch.core.algorithms`` shims;
batch consumers (``core.predictor``, ``repro_torch.tuner``) evaluate whole
scenario grids in one pass via ``evaluate_program`` /
``PerfModelRegistry.evaluate_grid``.
"""

from .expr import (C, D, Expr, N, P, Param, Q, R, T, as_expr, floor, fmax,
                   fmin, rint, sqrt, sum_decreasing, sum_squares, where)
from .ir import (COLLECTIVE_KINDS, Collective, Compute, Loop, Node, Overlap,
                 P2P, Program, Seq, SyncP2P)
from .evaluate import (EVAL_MODES, CollectiveStep, EvalOptions, EvalResult,
                       MODEL_VERSION, PhaseCost, collective_schedule,
                       evaluate_program)
from .models import PROGRAMS, USEFUL_FLOPS, build_programs, lu_2d, lu_25d
# kernel imports repro_torch.core.machine; keep it LAST so the attributes above
# exist if core's import of this package re-enters mid-initialization.
from .kernel import (ALGO_KERNELS, CANDIDATE_SIZES, KERNEL_DIMS, KernelModel,
                     KernelPhases, KernelWork, MIN_TILE, TilePlan,
                     VMEM_BUDGET, candidate_tiles, heuristic_matmul_blocks,
                     heuristic_plan, itemsize_of, kernel_work, tiles_for_plan)

__all__ = [
    "C", "D", "Expr", "N", "P", "Param", "Q", "R", "T", "as_expr", "floor",
    "fmax", "fmin", "rint", "sqrt", "sum_decreasing", "sum_squares", "where",
    "COLLECTIVE_KINDS", "Collective", "Compute", "Loop", "Node", "Overlap",
    "P2P", "Program", "Seq", "SyncP2P",
    "EVAL_MODES", "CollectiveStep", "EvalOptions", "EvalResult",
    "MODEL_VERSION", "PhaseCost", "collective_schedule", "evaluate_program",
    "PROGRAMS", "USEFUL_FLOPS", "build_programs", "lu_2d", "lu_25d",
    "ALGO_KERNELS", "CANDIDATE_SIZES", "KERNEL_DIMS", "KernelModel",
    "KernelPhases", "KernelWork", "MIN_TILE", "TilePlan", "VMEM_BUDGET",
    "candidate_tiles", "heuristic_matmul_blocks", "heuristic_plan",
    "itemsize_of", "kernel_work", "tiles_for_plan",
]
