"""repro_torch — the PyTorch/CUDA port of the model-guided distributed dense
linear algebra package.

Layout (each module mirrors its counterpart in the reference package):
  core/, perf/    the analytic performance models and the cost-IR (copies)
  tuner/          plans (Tuner, ExecutionPlan, plan cache) and dispatch
  kernels/        the hand-written CUDA kernels for Hopper (sm_90a), each
                  beside its plain PyTorch version
  linalg/         the 16 Cannon/SUMMA/TRSM/Cholesky variants on a
                  single-process stacked-rank grid or, with ``group=``,
                  on ranks that are processes of a torch.distributed group
  distributed/    spawning such ranks; staging through host memory
  devices.py      torch.device discovery (no CPU fallback)

Entry points: ``repro_torch.linalg.matmul / trsm / cholesky``.
"""
