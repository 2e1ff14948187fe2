"""repro_torch.core — the paper's contribution: contention-calibrated
performance models for distributed dense linear algebra (and, beyond the
paper, for LM train steps on TPU-like meshes).

Layout:
  machine.py      machine constants (Hopper Cray XE6, TPU v5e, CPU host,
                  NVIDIA H100 SXM)
  perfmodel.py    alpha-beta + calibration-factor primitives (paper §IV)
  collectives.py  analytic collective models (paper §V, scalar closed forms)
  algorithms.py   scalar shims over the cost-IR algorithm models (§V);
                  the models themselves are authored in repro_torch.perf.models
  calibration.py  portable benchmarks + fitting (paper §IV, Figs. 1-4):
                  routine efficiency timed on the device (CUDA events),
                  the measured profile, the paper fits
  paper_data.py   the paper's published Tables II-V
  predictor.py    variant selection + prediction tables (paper §VI),
                  batched through the vectorized cost-IR evaluator
  fitting.py      least-squares helpers behind the efficiency curves
  lm_model.py     the methodology applied to LM train steps (beyond-paper;
                  its C surfaces come from ``repro_torch.sim``)

The ping and contention benchmarks wait for the multi-GPU backend.

The cost-IR itself (nodes, symbolic scenario parameters, the vectorized
evaluator) lives in the sibling package ``repro_torch.perf``.
"""

from .machine import (CPU_HOST, H100_SXM, HOPPER, KernelConstants, MACHINES,
                      TPU_V5E, Machine)
from .perfmodel import (CalibrationTable, CommModel, ComputeModel,
                        EfficiencyCurve, IdentityCalibration,
                        ParametricCalibration)
from .algorithms import (ALGOS, VARIANTS, AlgoContext, ModelResult, evaluate,
                         pct_of_peak)
from .predictor import best_variant, prediction_table, select

__all__ = [
    "CPU_HOST", "H100_SXM", "HOPPER", "KernelConstants", "MACHINES",
    "TPU_V5E", "Machine",
    "CalibrationTable", "CommModel", "ComputeModel", "EfficiencyCurve",
    "IdentityCalibration", "ParametricCalibration",
    "ALGOS", "VARIANTS", "AlgoContext", "ModelResult", "evaluate",
    "pct_of_peak", "best_variant", "prediction_table", "select",
]
