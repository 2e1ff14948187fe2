"""The paper's algorithms, executable: run 2D vs 2.5D Cannon / TRSM /
Cholesky on a stacked grid and check them against numpy — then ask the
performance model which variant a Cray XE6 or a TPU pod should use.

    PYTHONPATH=src python -m repro_torch.examples.linalg_25d_demo [--device cpu]

Where the reference forces 8 host devices, the port stacks the ranks of a
grid on one device (``devices=[device] * p``).  At n = 64 every local
block is below the kernels' thresholds (128), so the products and solves
run their plain versions, on the card as on the CPU; the advice at the
end is host arithmetic.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..linalg import (BLOCK, ROWS_OVER_LAYERS, cannon_2d, cannon_25d,
                      cholesky_25d, collect, distribute, trsm_25d)
from ..linalg.grid import make_grid_mesh
from . import add_device_argument, device_for


def host(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device_argument(ap)
    args = ap.parse_args(argv)
    device = device_for(args.device)

    n = 64
    rng = np.random.default_rng(0)
    a = rng.standard_normal((n, n)).astype(np.float32)
    b = rng.standard_normal((n, n)).astype(np.float32)
    A = torch.from_numpy(a).to(device)
    B = torch.from_numpy(b).to(device)

    grid2 = make_grid_mesh(2, 2, devices=[device] * 4)
    grid3 = make_grid_mesh(2, 2, layers=2, devices=[device] * 8)
    C2 = host(collect(cannon_2d(distribute(A, grid2), distribute(B, grid2),
                                grid=grid2), grid2))
    C25 = host(collect(cannon_25d(distribute(A, grid3, BLOCK),
                                  distribute(B, grid3, BLOCK), grid=grid3),
                       grid3))
    ref = a @ b
    print(f"cannon 2D err {np.abs(C2-ref).max():.2e} | "
          f"2.5D (c=2) err {np.abs(C25-ref).max():.2e}")

    u = (np.triu(rng.standard_normal((n, n))) + 3 * np.eye(n)).astype(
        np.float32)
    U = torch.from_numpy(u).to(device)
    X = host(collect(trsm_25d(distribute(U, grid3, BLOCK),
                              distribute(B, grid3, ROWS_OVER_LAYERS),
                              grid=grid3), grid3, ROWS_OVER_LAYERS))
    print(f"trsm 2.5D err {np.abs(X @ u - b).max():.2e}")

    spd = (a @ a.T + n * np.eye(n)).astype(np.float32)
    L = host(collect(cholesky_25d(distribute(torch.from_numpy(spd).to(
        device), grid3, BLOCK), grid=grid3), grid3))
    print(f"cholesky 2.5D err {np.abs(L @ L.T - spd).max():.2e}")

    # model-guided dispatch: the tuner picks variant + grid + kernels,
    # executes, and caches the plan under artifacts/plans_torch/
    from .. import linalg
    from ..tuner import default_tuner
    C = host(linalg.matmul(A, B, devices=[device]))
    plan = default_tuner().plan("matmul", n, devices=[device])
    print(f"\ntuner dispatch: {plan.algo}/{plan.variant} p={plan.p} "
          f"c={plan.c} kernel={plan.local_kernel} "
          f"err {np.abs(C-ref).max():.2e} "
          f"(predicted {plan.predicted['total']*1e3:.2f} ms)")

    # and the model's advice for real machines
    from ..core import AlgoContext, CommModel, ComputeModel, TPU_V5E
    from ..core.calibration import hopper_fitted_ctx
    from ..core.perfmodel import TPU_EFFICIENCY
    from ..core.predictor import select
    from ..sim import derive_calibration, v5e_pod_topology
    ctx_h = hopper_fitted_ctx()
    ch = select(ctx_h, "cholesky", 65536, 4096)
    print(f"\nHopper @24k cores, cholesky n=65536 -> "
          f"{ch.result.variant} (c={ch.result.c}, {ch.pct_peak:.1f}% peak)")
    cal = derive_calibration(v5e_pod_topology(), ps=[64, 256],
                             distances=[1, 4, 16])
    ctx_t = AlgoContext(CommModel(TPU_V5E, cal),
                        ComputeModel(TPU_V5E, TPU_EFFICIENCY))
    ch = select(ctx_t, "cholesky", 131072, 256)
    print(f"v5e pod (256 chips), cholesky n=131072 -> "
          f"{ch.result.variant} (c={ch.result.c}, {ch.pct_peak:.1f}% peak)")


if __name__ == "__main__":
    main()
