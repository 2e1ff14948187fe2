"""Kernel-tier microbenchmark of the port: K1's measured tile sweep ->
constants refit -> model-guided tile choice (the reference's
``benchmarks/bench_kernels.py``, with its three stages).

    python -m repro_torch.benchmarks.bench_kernels [--device cuda|cpu] [--n N]

1. sweep matmul plan tiles at one n x n x n fp32 product, one plan for
   each of K1's CTA tiles (``kernels/matmul/ops.py::cta_tile``), the
   heuristic default among them; on the card each is timed with CUDA
   events after a warm call, the best of ``RUNS`` runs of ``REPS``
   launches; on the CPU (plain versions: every plan runs the same code)
   with the host clock.  Each time is recorded through
   ``telemetry.kernel_timer`` with the seed model's prediction attached;
2. ``refit_kernels`` fits a revision of the machine's kernel constants to
   the recorded sweep;
3. the refitted :class:`~repro_torch.perf.kernel.KernelModel` shortlists
   the plans within ``SHORTLIST_SLACK`` of its fitted best (the default
   always among them) and the measured best of the shortlist is chosen:
   ``tuned_over_default`` is the default's time over the chosen one's,
   at least 1 by construction.

Stages 2 and 3 are :func:`choose_tile`, pure arithmetic on the measured
times.  The machine is ``h100-sxm`` on ``cuda``, registered in a registry
of its own with ``core.machine.H100_KERNEL_SEED`` (``H100_SXM`` itself
carries no kernel constants), and ``cpu-host`` on ``cpu``, as in the
reference.  The trsm and Cholesky baselines time the port's blocked
wrappers (K1-K3 on the card) at the same n.  The JSON keeps the
reference's keys, except that ``family_interpret_us`` is ``family_us``
beside a ``device`` field (a card time is not an interpret-path time) and
each sweep row names its ``cta_tile``.

Prints a single JSON object on the last stdout line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

#: (bm, bn, bk) plans, one for each of K1's CTA tiles (halved, clamped:
#: 64x64, 64x128, 128x64, 128x128, 256x64, 256x128); bk is the heuristic's
#: 512 throughout, since K1's ring depth does not follow it
SWEEP_TILES = [
    (128, 128, 512),
    (128, 256, 512),
    (256, 128, 512),
    (256, 256, 512),   # the heuristic default
    (512, 128, 512),
    (512, 256, 512),
]

#: fitted-time slack for the model shortlist (stage two measures these)
SHORTLIST_SLACK = 1.25

#: the product's edge when ``main`` is given none: the card's, and the
#: reference's interpret-path edge on the CPU
N_CARD, N_CPU = 4096, 512

#: the card's timing: best of RUNS runs of REPS launches, after a warm call
RUNS, REPS = 3, 5

MACHINES = {"cuda": "h100-sxm", "cpu": "cpu-host"}


def _plan(t: Tuple[int, int, int]):
    from ..perf.kernel import TilePlan
    return TilePlan.make("matmul", bm=t[0], bn=t[1], bk=t[2])


def _registry(device: str):
    """A fresh default registry; on ``cuda`` its ``h100-sxm`` carries the
    kernel-tier seed."""
    from ..core.machine import H100_KERNEL_SEED
    from ..tuner.registry import build_default_registry
    reg = build_default_registry()
    if device == "cuda":
        surface = reg.machine(MACHINES["cuda"])
        reg.register_machine(
            dataclasses.replace(surface.machine,
                                kernel_constants=H100_KERNEL_SEED),
            surface.efficiency, surface.calibration, overwrite=True)
    return reg


def _seconds(fn, device: str) -> float:
    """The best time of one call of ``fn`` after a warm one: CUDA events
    over REPS launches, the best of RUNS, on the card; the host clock on
    the CPU."""
    import torch
    fn()
    if device != "cuda":
        best = float("inf")
        for _ in range(RUNS):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        return best
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(RUNS):
        start.record()
        for _ in range(REPS):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3 / REPS)
    return best


def choose_tile(measured: Dict[tuple, float], registry, machine: str, n: int,
                itemsize: int) -> dict:
    """Stages 2 and 3 on a measured sweep (plan tuple -> seconds, the
    heuristic default among the plans): the sweep recorded (one
    ``kernel:matmul`` record a plan, its seconds under ``execute``, the
    seed model's prediction attached), the refit applied to ``registry``,
    the fitted times, the shortlist, the chosen plan and
    ``tuned_over_default``."""
    from ..perf.kernel import KernelModel, heuristic_plan
    from ..telemetry import kernel_timer, refit_kernels
    machine0 = registry.machine(machine).machine
    model0 = KernelModel(machine0)
    records = []
    for t, secs in measured.items():
        pt = kernel_timer("matmul", (n, n, n), _plan(t), dtype="float32",
                          machine=machine, itemsize=itemsize,
                          predicted={"total": model0.time(
                              "matmul", (n, n, n), _plan(t), itemsize)})
        pt.add("execute", secs)
        records.append(pt.record())
    refit = refit_kernels(records, registry, machine)
    machine1 = refit.apply(registry)
    model1 = KernelModel(machine1)
    fitted = {t: model1.time("matmul", (n, n, n), _plan(t), itemsize)
              for t in measured}
    default = heuristic_plan("matmul", (n, n, n), itemsize)
    default_t = (default["bm"], default["bn"], default["bk"])
    best_fit = min(fitted.values())
    shortlist = sorted(t for t, s in fitted.items()
                       if s <= SHORTLIST_SLACK * best_fit)
    if default_t not in shortlist:
        shortlist.append(default_t)       # the stand-down option always runs
    chosen = min(shortlist, key=lambda t: measured[t])
    return {"refit": refit, "machine0": machine0,
            "machine1": machine1, "fitted": fitted, "default": default_t,
            "shortlist": shortlist, "chosen": chosen,
            "ratio": measured[default_t] / measured[chosen]}


def _tile(t: Sequence[int]) -> dict:
    return {"bm": t[0], "bn": t[1], "bk": t[2]}


def _operands(torch, n: int, dev):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((n, n))
    b = rng.standard_normal((n, n))
    u = np.triu(rng.standard_normal((n, n))) + 40 * np.eye(n)
    spd = a @ a.T + n * np.eye(n)
    return tuple(torch.tensor(x, dtype=torch.float32, device=dev)
                 for x in (a, b, u, spd))


def main(device: str = "cuda", n: Optional[int] = None) -> dict:
    import torch
    from ..kernels import cholesky, matmul, trsm
    from ..kernels.matmul import cta_tile
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench_kernels: no CUDA device (pass "
                           "device='cpu' to run the plain versions)")
    n = n or (N_CARD if device == "cuda" else N_CPU)
    machine = MACHINES[device]
    itemsize = 4
    a, b, u, spd = _operands(torch, n, torch.device(device))
    registry = _registry(device)

    # -- stage 1: the measured sweep ---------------------------------------
    measured = {t: _seconds(lambda tp=_plan(t): matmul(a, b, tiles=tp),
                            device) for t in SWEEP_TILES}
    # -- stages 2 and 3: the refit and the model-guided choice -------------
    res = choose_tile(measured, registry, machine, n, itemsize)
    fitted, shortlist = res["fitted"], res["shortlist"]
    rows: List[dict] = [
        {"tile": _tile(t), "cta_tile": list(cta_tile(_plan(t))),
         "measured_us": measured[t] * 1e6, "fitted_us": fitted[t] * 1e6,
         "in_shortlist": t in shortlist}
        for t in SWEEP_TILES]

    # the family baselines, through the port's wrappers at n
    family_us = {
        "matmul": measured[res["default"]] * 1e6,
        "trsm": _seconds(lambda: trsm(u, a), device) * 1e6,
        "cholesky": _seconds(lambda: cholesky(spd), device) * 1e6,
    }

    refit = res["refit"]
    kc0 = res["machine0"].kernel_constants
    kc1 = res["machine1"].kernel_constants
    return {
        "machine": machine,
        "n": n,
        "itemsize": itemsize,
        "sweep": rows,
        "default_tile": _tile(res["default"]),
        "chosen_tile": _tile(res["chosen"]),
        "shortlist_size": len(shortlist),
        "tuned_over_default": res["ratio"],
        "refit": {
            "compute_scale": refit.compute_scale,
            "loop_scale": refit.loop_scale,
            "n_rows": refit.n_rows,
            "revision": res["machine1"].revision,
            "overhead_factor": [kc0.overhead_factor, kc1.overhead_factor],
            "loop_overhead": [kc0.loop_overhead, kc1.loop_overhead],
        },
        "family_us": family_us,
        "device": (torch.cuda.get_device_name(0) if device == "cuda"
                   else "cpu"),
    }


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--n", type=int, default=None)
    args = ap.parse_args()
    print(json.dumps(main(device=args.device, n=args.n)))
