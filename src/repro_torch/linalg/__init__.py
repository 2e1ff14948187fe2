"""Executable distributed dense linear algebra on a stacked-rank grid — the
paper's benchmark applications: Cannon, SUMMA, TRSM, Cholesky in 2D / 2.5D,
with and without communication overlapping.

Two API levels:

* **explicit** — the per-variant functions below (``cannon_2d`` ...) take
  stacked operands (``distribute``) and a grid you built;
* **model-guided** — ``matmul`` / ``trsm`` / ``cholesky`` take global
  tensors, consult ``repro_torch.tuner`` for the best (variant, c, grid,
  local kernel) on the given devices, and execute it (plans are cached
  persistently under ``artifacts/plans_torch/``).

Both levels run stacked (every rank in this process) or, with a
``torch.distributed`` group (``group=`` / ``make_grid_mesh(...,
group=)``), with each rank a process of the group (``collectives.py``).
"""

from .grid import (BLOCK, ROWS_OVER_LAYERS, Grid, collect, distribute,
                   make_grid_mesh)
from .cannon import cannon_2d, cannon_2d_ovlp, cannon_25d, cannon_25d_ovlp
from .summa import summa_2d, summa_2d_ovlp, summa_25d, summa_25d_ovlp
from .trsm import trsm_2d, trsm_2d_ovlp, trsm_25d, trsm_25d_ovlp
from .cholesky import (cholesky_2d, cholesky_2d_ovlp, cholesky_25d,
                       cholesky_25d_ovlp)

ALGORITHMS = {
    ("cannon", "2d"): cannon_2d,
    ("cannon", "2d_ovlp"): cannon_2d_ovlp,
    ("cannon", "2.5d"): cannon_25d,
    ("cannon", "2.5d_ovlp"): cannon_25d_ovlp,
    ("summa", "2d"): summa_2d,
    ("summa", "2d_ovlp"): summa_2d_ovlp,
    ("summa", "2.5d"): summa_25d,
    ("summa", "2.5d_ovlp"): summa_25d_ovlp,
    ("trsm", "2d"): trsm_2d,
    ("trsm", "2d_ovlp"): trsm_2d_ovlp,
    ("trsm", "2.5d"): trsm_25d,
    ("trsm", "2.5d_ovlp"): trsm_25d_ovlp,
    ("cholesky", "2d"): cholesky_2d,
    ("cholesky", "2d_ovlp"): cholesky_2d_ovlp,
    ("cholesky", "2.5d"): cholesky_25d,
    ("cholesky", "2.5d_ovlp"): cholesky_25d_ovlp,
}


# -- model-guided entry points (lazy imports: repro_torch.tuner imports this
# package's submodules, so binding at call time avoids the cycle) ----------

def matmul(A, B, **kwargs):
    """C = A @ B via the tuner-selected Cannon/SUMMA variant and grid.

    Keyword args: ``devices`` (``torch.device`` per rank; default the
    current CUDA device, and no CPU fallback), ``tuner``, ``local_kernel``
    ("pallas": the CUDA kernels / "jnp": torch.matmul and torch.linalg),
    ``group`` (ranks as processes of that group); see
    ``repro_torch.tuner.dispatch.matmul``.
    """
    from ..tuner import dispatch
    return dispatch.matmul(A, B, **kwargs)


def trsm(U, B, **kwargs):
    """Solve X U = B (U upper-triangular) via the tuner-selected variant.

    Note: shadows the ``repro_torch.linalg.trsm`` *module* as a package
    attribute; the per-variant functions stay importable from the module
    (``from repro_torch.linalg.trsm import trsm_2d``) and above.
    """
    from ..tuner import dispatch
    return dispatch.trsm(U, B, **kwargs)


def cholesky(A, **kwargs):
    """L with A = L L^T (A SPD) via the tuner-selected variant."""
    from ..tuner import dispatch
    return dispatch.cholesky(A, **kwargs)
