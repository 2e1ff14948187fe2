"""Scalar shims over the cost-IR algorithm models (paper §V).

.. deprecated::
   The 16 closed-form model functions that used to live here
   (``cannon_2d`` ... ``cholesky_25d_ovlp``) are now *authored* as
   declarative cost-IR programs in ``repro_torch.perf.models`` and *evaluated*
   by ``repro_torch.perf.evaluate`` — vectorized over scenario grids for batch
   consumers, scalar here.  The module-level functions, ``MODELS`` and
   ``evaluate`` remain as thin shims for one release so existing call
   sites keep working; new code should use
   ``repro_torch.tuner.PerfModelRegistry.evaluate_grid`` or
   ``repro_torch.perf.evaluate_program`` directly.

The transcription deviations from the printed paper (2.5D step count,
TRSM update multiplicity, collective volumes, overlap thread accounting)
are documented in DESIGN.md §1 and pinned by the golden fixtures in
``tests/golden/model_values.json``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

from ..perf import EvalOptions, PROGRAMS, evaluate_program
from ..perf.models import USEFUL_FLOPS  # noqa: F401  (re-export, back-compat)
from .perfmodel import CommModel, ComputeModel


@dataclasses.dataclass
class AlgoContext:
    comm: CommModel
    comp: ComputeModel

    @property
    def threads(self) -> int:
        return self.comp.machine.threads_per_unit


@dataclasses.dataclass
class ModelResult:
    """Estimated seconds, with a comm/comp decomposition.

    ``comm``/``comp`` are the *serialized* sums of each class of term;
    ``total`` accounts for overlap (max-composition), so
    ``total <= comm + comp`` always holds.  ``terms`` is the scalar
    back-compat view of the structured per-phase breakdown
    (``repro_torch.perf.EvalResult.phases``).
    """

    total: float
    comm: float
    comp: float
    terms: Dict[str, float]
    algo: str = ""
    variant: str = ""
    n: int = 0
    p: int = 0
    c: int = 1
    r: int = 1


def pct_of_peak(ctx: AlgoContext, res: ModelResult) -> float:
    """Percentage of machine peak achieved (the paper's reporting metric)."""
    flops = USEFUL_FLOPS[res.algo](res.n)
    peak = res.p * ctx.comp.machine.peak_flops_per_unit
    return 100.0 * flops / (res.total * peak)


def result_from_eval(program, res, n, p, c, r, idx=None) -> ModelResult:
    """Convert one perf.EvalResult cell to the legacy ModelResult, echoing
    only the tuning parameters the model reads.  ``idx`` selects one cell
    of a vectorized result; ``None`` reads a 0-d (scalar) result."""
    pick = float if idx is None else (lambda a: float(a[idx]))
    return ModelResult(
        pick(res.total), pick(res.comm), pick(res.comp),
        {name: pick(ph.exposed) for name, ph in res.phases.items()},
        algo=program.algo, variant=program.variant, n=n, p=p,
        c=c if program.uses_c else 1, r=r if program.uses_r else 1)


def scalar_shim(program) -> "ModelFn":
    def fn(ctx: AlgoContext, n: int, p: int,
           c: int = program.default_c, r: int = program.default_r,
           options: Optional[EvalOptions] = None) -> ModelResult:
        res = evaluate_program(program, ctx, n, p, c, r, options=options)
        return result_from_eval(program, res, n, p, c, r)

    fn.__name__ = f"{program.algo}_{program.variant}".replace(".", "")
    fn.__doc__ = (f"Deprecated shim: scalar evaluation of the "
                  f"({program.algo}, {program.variant}) cost-IR program.")
    fn.program = program
    return fn


ModelFn = Callable[..., ModelResult]

#: (algo, variant) -> scalar shim over the registered cost-IR program
MODELS: Dict[tuple[str, str], ModelFn] = {
    key: scalar_shim(prog) for key, prog in PROGRAMS.items()
}

# Deprecated module-level names, kept for one release.
cannon_2d = MODELS[("cannon", "2d")]
cannon_2d_ovlp = MODELS[("cannon", "2d_ovlp")]
cannon_25d = MODELS[("cannon", "2.5d")]
cannon_25d_ovlp = MODELS[("cannon", "2.5d_ovlp")]
summa_2d = MODELS[("summa", "2d")]
summa_2d_ovlp = MODELS[("summa", "2d_ovlp")]
summa_25d = MODELS[("summa", "2.5d")]
summa_25d_ovlp = MODELS[("summa", "2.5d_ovlp")]
trsm_2d = MODELS[("trsm", "2d")]
trsm_2d_ovlp = MODELS[("trsm", "2d_ovlp")]
trsm_25d = MODELS[("trsm", "2.5d")]
trsm_25d_ovlp = MODELS[("trsm", "2.5d_ovlp")]
cholesky_2d = MODELS[("cholesky", "2d")]
cholesky_2d_ovlp = MODELS[("cholesky", "2d_ovlp")]
cholesky_25d = MODELS[("cholesky", "2.5d")]
cholesky_25d_ovlp = MODELS[("cholesky", "2.5d_ovlp")]
lu_2d = MODELS[("lu", "2d")]
lu_25d = MODELS[("lu", "2.5d")]

#: the paper's algorithm/variant matrix (LU is a beyond-paper addition and
#: is deliberately not listed here; enumerate the registry for everything)
ALGOS = ("cannon", "summa", "trsm", "cholesky")
VARIANTS = ("2d", "2d_ovlp", "2.5d", "2.5d_ovlp")


def evaluate(ctx: AlgoContext, algo: str, variant: str, n: int, p: int,
             c: int = 1, r: int = 1,
             options: Optional[EvalOptions] = None) -> ModelResult:
    """Scalar evaluation of one registered model.  ``options`` selects the
    estimator flavor (est_Cal / est_NoCal / est_ideal) without rebuilding
    the context — see :class:`repro_torch.perf.EvalOptions`."""
    return MODELS[(algo, variant)](ctx, n, p, c=c, r=r, options=options)
