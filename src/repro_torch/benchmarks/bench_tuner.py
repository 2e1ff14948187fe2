"""Tuner dispatch benchmark on 8 ranks stacked on one device
(``[device] * 8`` in one process).

    python -m repro_torch.benchmarks.bench_tuner [--device cuda|cpu] [--n N]

Measures the three costs the autotuning layer introduces or removes:

* model evaluation (cold plan: enumerate grids + evaluate variants),
* plan-cache hit latency (in-memory and from-disk JSON),
* end-to-end dispatch overhead of ``linalg.matmul`` over invoking the
  pre-built executor directly,

plus the model-predicted and measured speedup of the auto-selected variant
against the worst feasible one — the paper's variant-selection payoff —
and (``model_eval`` key, also emitted as ``BENCH_model_eval.json``) the
throughput of one vectorized cost-IR pass over a >=200-scenario
``(n, p, c)`` grid versus the same grid evaluated with per-scenario
scalar calls.

Prints a single JSON object on the last stdout line.
"""

import dataclasses
import json
import sys
import tempfile
import time
from typing import Optional

import numpy as np


def _best_of(fn, reps: int = 5) -> float:
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def bench_model_eval(tuner) -> dict:
    """Vectorized-vs-scalar model-evaluation throughput on a Hopper-scale
    scenario grid (pure numpy model math, no device)."""
    reg = tuner.registry
    ctx = reg.context("hopper-cray-xe6")
    ns = np.array([4096.0, 8192.0, 16384.0, 32768.0, 65536.0, 131072.0,
                   262144.0, 524288.0])
    ps = np.array([16.0, 64.0, 256.0, 1024.0, 4096.0, 16384.0, 65536.0])
    cs = np.array([1.0, 2.0, 4.0, 8.0])
    Ng, Pg, Cg = (a.ravel() for a in np.meshgrid(ns, ps, cs, indexing="ij"))
    out = {"scenarios": int(Ng.size), "models": {}}
    for algo, variant in (("cannon", "2.5d_ovlp"), ("summa", "2.5d"),
                          ("trsm", "2.5d"), ("cholesky", "2.5d_ovlp"),
                          ("lu", "2.5d")):
        vec_s = _best_of(lambda: reg.evaluate_grid(
            ctx, algo, variant, Ng, Pg, Cg, 2.0), reps=3)
        scal_s = _best_of(lambda: [
            reg.evaluate(ctx, algo, variant, int(n), int(p), c=int(c), r=2)
            for n, p, c in zip(Ng, Pg, Cg)], reps=3)
        out["models"][f"{algo}/{variant}"] = {
            "vectorized_us": vec_s * 1e6,
            "scalar_loop_us": scal_s * 1e6,
            "speedup": scal_s / vec_s,
        }
    speedups = [m["speedup"] for m in out["models"].values()]
    out["min_speedup"] = min(speedups)
    out["geomean_speedup"] = float(np.exp(np.mean(np.log(speedups))))
    return out


def main(device: str = "cuda", n: Optional[int] = None) -> dict:
    """``device``: the 8 stacked ranks' device (``"cuda"``: the current
    card; no CPU fallback).  ``n``: the matrix size (default 256, the
    reference's)."""
    import torch
    from .. import linalg
    from ..devices import canonical, default_devices
    from ..linalg.grid import BLOCK, make_grid_mesh
    from ..tuner import PlanCache, Tuner
    from ..tuner import dispatch as disp

    dev = default_devices()[0] if device == "cuda" else canonical(device)
    devices = [dev] * 8

    def ready(x):
        """``x``, once the device has finished the work queued on it."""
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return x

    plan_dir = tempfile.mkdtemp(prefix="plans-")
    n = 256 if n is None else int(n)
    out = {"n": n, "devices": len(devices)}

    # --- model evaluation vs cache hit ------------------------------------
    tuner = Tuner(cache=PlanCache(plan_dir))
    out["model_eval_us"] = _best_of(
        lambda: tuner.plan("matmul", n, devices=devices, use_cache=False)) * 1e6
    plan = tuner.plan("matmul", n, devices=devices)      # populate the cache
    out["cache_hit_mem_us"] = _best_of(
        lambda: tuner.plan("matmul", n, devices=devices)) * 1e6

    cold = Tuner(cache=PlanCache(plan_dir))              # fresh process stand-in
    out["cache_hit_disk_us"] = _best_of(
        lambda: (cold.cache.clear_memory(),
                 cold.plan("matmul", n, devices=devices))) * 1e6
    if cold.stats["model_evals"] != 0:
        raise RuntimeError("disk hit must skip the models")

    # --- dispatch overhead -------------------------------------------------
    rng = np.random.default_rng(0)
    A, B = (torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32))
            .to(dev) for _ in range(2))
    ready(linalg.matmul(A, B, tuner=tuner, devices=devices))  # warm
    total = _best_of(lambda: ready(
        linalg.matmul(A, B, tuner=tuner, devices=devices)))
    devs = disp._resolve(devices, plan.p)
    grid = make_grid_mesh(plan.g, plan.g, layers=plan.c, devices=devs)
    fn = disp._executor(plan, grid)
    m = disp._round_up(n, plan.g)
    Ad = linalg.distribute(disp._pad_zero(A, m, m), grid, BLOCK)
    Bd = linalg.distribute(disp._pad_zero(B, m, m), grid, BLOCK)
    ready(fn(Ad, Bd))
    raw = _best_of(lambda: ready(fn(Ad, Bd)))
    out["exec_us"] = raw * 1e6
    out["dispatch_total_us"] = total * 1e6
    out["dispatch_overhead_us"] = max(0.0, (total - raw) * 1e6)

    # --- auto-selected vs worst feasible variant ---------------------------
    from ..tuner.autotune import feasible_grids
    ctx = tuner.registry.context(plan.machine)
    worst_plan, worst_total = None, -1.0
    for algo in ("cannon", "summa"):
        for p, c, g in feasible_grids(len(devices), algo):
            kind = "2d" if c == 1 else "2.5d"
            for variant in tuner.registry.variants(algo):
                if not variant.startswith(kind):
                    continue
                res = tuner.registry.evaluate(ctx, algo, variant, n, p, c=c)
                if res.total > worst_total:
                    worst_total = res.total
                    worst_plan = dataclasses.replace(
                        plan, algo=algo, variant=variant, p=p, c=c, g=g,
                        predicted={"total": res.total, "comm": res.comm,
                                   "comp": res.comp})
    out["predicted_speedup_auto_vs_worst"] = worst_total / plan.predicted["total"]
    ready(disp.execute(worst_plan, A, B, devices=devices))
    worst_meas = _best_of(lambda: ready(
        disp.execute(worst_plan, A, B, devices=devices)))
    out["measured_speedup_auto_vs_worst"] = worst_meas / total
    out["auto"] = f"{plan.algo}/{plan.variant} p={plan.p} c={plan.c}"
    out["worst"] = f"{worst_plan.algo}/{worst_plan.variant} p={worst_plan.p} c={worst_plan.c}"

    # --- vectorized vs scalar model-evaluation throughput ------------------
    out["model_eval"] = bench_model_eval(tuner)
    return out


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--n", type=int, default=None)
    args = ap.parse_args()
    print(json.dumps(main(args.device, args.n)))
    sys.stdout.flush()
