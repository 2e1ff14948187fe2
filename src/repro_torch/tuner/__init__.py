"""repro_torch.tuner — model-guided autotuning dispatch.

The paper's headline application, closed end-to-end: the analytic
performance models (``repro_torch.core``) select the 2D/2.5D ±overlap
variant, replication factor and grid for a scenario, and the executable
stacked-rank algorithms (``repro_torch.linalg``) run the winner with the
hand-written CUDA kernels (``repro_torch.kernels``) as local compute.

Layout:
  registry.py   PerfModelRegistry — one query surface over the algorithm
                models, collective models, and machine surfaces
  plan.py       ExecutionPlan + persistent JSON PlanCache
                (artifacts/plans_torch/)
  autotune.py   Tuner — feasible-grid enumeration + model selection +
                LM-layer consultations (fsdp layout, prefill chunking)
  dispatch.py   linalg.matmul/trsm/cholesky execution of resolved plans
"""

from .registry import (DEFAULT_REGISTRY, MachineSurface, PerfModelRegistry,
                       build_default_registry, machine_for_platform)
from .plan import (ExecutionPlan, PlanCache, default_plan_dir,
                   machine_fingerprint, plan_key)
from .autotune import OP_ALGOS, Tuner, default_tuner, feasible_grids

__all__ = [
    "DEFAULT_REGISTRY", "MachineSurface", "PerfModelRegistry",
    "build_default_registry", "machine_for_platform",
    "ExecutionPlan", "PlanCache", "default_plan_dir", "machine_fingerprint",
    "plan_key",
    "OP_ALGOS", "Tuner", "default_tuner", "feasible_grids",
]
