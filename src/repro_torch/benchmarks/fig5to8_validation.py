"""Paper Figs. 5-8 analog on the port: model estimates against *measured*
runs of the 2D variants, over a ``torch.distributed`` group.  This is the
end-to-end validation of the method:

  1. benchmark the machine (the Fig. 1, 2 and 3-4 ingredients) -> model
     parameters;
  2. run each 2D variant on a g x g grid of ranks through the hand-written
     kernels (K1-K3), measure its wall time;
  3. compare est_Cal with est_NoCal (the paper's point: the calibration
     factor is what makes the estimates rank the variants).

    python -m repro_torch.benchmarks.fig5to8_validation \\
        [--device cuda|cpu] [--world 4] [--n N] [--backend gloo|nccl]

``world`` ranks are spawned (``repro_torch.distributed.spawn``), g =
isqrt(world), and the world must be square.  The compute benchmark runs on
rank 0 alone while the others wait, and its peak is divided by the number
of ranks that share that rank's device: under gloo every rank runs on
``cuda:0`` (or the CPU), so the measured peak is split P ways, as the
reference splits its one core among its host devices; with a card a rank
(NCCL) it is not split.  The model's profile is the device's
(``tuner.registry.machine_for_platform``: ``cpu-host`` or ``h100-sxm``)
with the measured peak, the fitted efficiency curves, and the latency,
inverse bandwidth and contention factors measured over this group.

Transport caveat: on one card all ranks time-slice the card and gloo stages
every block through pinned host memory, so the measured walls are of that
transport, not of NVLink; what is validated is the method, on it.

Operands (seed 0, as the reference's): A, B standard normal, SPD = A A^T +
n I, and the triangle U = triu(R, 1) / sqrt(n) + 4 I.  The reference's
U = triu(R) + 3 I is ill-conditioned beyond measure: its solve exceeds 1e32
at n = 1024 and overflows fp32 from about n = 1400, so no residual could be
checked there; the time of a solve does not depend on its values.

Prints rank 0's JSON: the reference's keys, plus ``transport``, ``device``
and ``world``, the fitted ``compute_curves`` (every estimate can be rebuilt
from the JSON alone), and per variant ``rel_residual`` (the collected
output against the library on rank 0) and ``launches`` (each rank's K1, K2
and K3 launches over the variant's calls), and ``calibration_launches``
(each rank's launches in the routine benchmark: rank 0 alone runs it).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
from typing import Optional

from .common import WORD_BYTES

#: the kernels of the linalg path, by their launch counters
PATH_KERNELS = ("matmul_cuda", "trsm_diag_cuda", "cholesky_block_cuda")


def compute_sizes(nb: int) -> tuple:
    """The routine benchmark's sizes for local blocks of ``nb`` rows: 128,
    256, ... below ``nb``, then ``nb`` (at least two sizes)."""
    sizes, s = [], 128
    while s < nb:
        sizes.append(s)
        s *= 2
    sizes.append(nb)
    if len(sizes) < 2:
        sizes = [max(1, nb // 2), nb]
    return tuple(sizes)


def _grid_side(world: int) -> int:
    g = math.isqrt(world)
    if g * g != world:
        raise ValueError(f"fig5to8 runs a g x g grid: world {world} is not "
                         "a square")
    return g


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _measure(fn, dev, group, reps: int) -> float:
    """One untimed call, then the best of ``reps``: each call starts after
    a barrier and ends in a synchronize; its wall is the slowest rank's."""
    import torch
    import torch.distributed as dist
    from ..distributed.process_group import host_or_device
    fn()
    _sync(dev)
    best = float("inf")
    for _ in range(reps):
        dist.barrier(group)
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        wall = torch.tensor([time.perf_counter() - t0], dtype=torch.float64,
                            device=host_or_device(group, dev))
        dist.all_reduce(wall, op=dist.ReduceOp.MAX, group=group)
        best = min(best, float(wall.item()))
    return best


def _library(op: str, args):
    import torch
    if op == "matmul":
        return torch.matmul(*args)
    if op == "trsm":
        u, b = args
        return torch.linalg.solve_triangular(u, b, upper=True, left=False)
    return torch.linalg.cholesky(args[0])


def _compute_model(machine, sizes, dev, group, shared: int):
    """Rank 0's measured ComputeModel on every rank, its peak divided by
    the ``shared`` ranks on its device; the other ranks wait."""
    import torch.distributed as dist
    from ..core.calibration import measured_compute_model
    from ..distributed.process_group import host_or_device
    box = [None]
    if dist.get_rank(group) == 0:
        box[0] = measured_compute_model(machine, sizes=sizes, device=dev,
                                        route="kernels")
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0),
                               group=group,
                               device=host_or_device(group, dev))
    comp = box[0]
    return dataclasses.replace(comp, machine=dataclasses.replace(
        comp.machine,
        peak_flops_per_unit=comp.machine.peak_flops_per_unit / shared,
        threads_per_unit=1))


def _launches(before: dict, group) -> list:
    """Each rank's launches of the path's kernels since ``before``."""
    import torch.distributed as dist
    from .. import kernels
    after = kernels.launches()
    mine = {k: after[k] - before[k] for k in PATH_KERNELS}
    every = [None] * dist.get_world_size(group)
    dist.all_gather_object(every, mine, group=group)
    return every


def measure_links(group, dev, g: int):
    """Step 1's link part over ``group``: (L, beta) fitted to the ping, and
    the contention table at distances 1 and max(2, g), in words of
    ``WORD_BYTES``.  Returns (L, beta, CalibrationTable, its factors)."""
    from ..core import CalibrationTable
    from ..core.calibration import (bench_contention, bench_ping,
                                    fit_alpha_beta)
    p2d = g * g
    # include small messages so the latency intercept is identifiable
    ping = bench_ping(sizes_words=(64, 1 << 10, 1 << 14, 1 << 18, 1 << 21),
                      word_bytes=WORD_BYTES, reps=7, group=group, device=dev)
    L, beta = fit_alpha_beta(ping)
    # contention: measured factor at two distances -> small table
    words = 1 << 19
    ideal = L + beta * words
    avg, mx = {}, {}
    for d in (1, max(2, g)):
        wall = bench_contention(p2d, d, words=words, word_bytes=WORD_BYTES,
                                group=group, device=dev)
        avg[float(d)] = max(1.0, wall / ideal)
        mx[(float(p2d), float(d))] = max(1.0, wall / ideal)
    return L, beta, CalibrationTable(avg=avg, mx=mx,
                                     extrapolation_degree=1), avg


def measure(rank: int, world: int, device, n: Optional[int] = None,
            reps: int = 3, backend: str = "gloo") -> dict:
    """One rank's part: steps 1-3.  Every rank returns the same numbers but
    ``rel_residual``, which rank 0 alone computes (None elsewhere)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from .. import kernels
    from ..core import AlgoContext, CommModel, evaluate
    from ..core.calibration import _ieee_fp32
    from ..core.machine import MACHINES
    from ..distributed import devices_for
    from ..linalg import ALGORITHMS, collect, distribute, make_grid_mesh
    from ..perf import EvalOptions
    from ..tuner.dispatch import _local_hooks
    from ..tuner.registry import machine_for_platform

    group = dist.group.WORLD
    dev = torch.device(device)
    g = _grid_side(world)
    p2d = g * g
    n = 512 * g if n is None else int(n)
    place = devices_for(dev.type, backend)
    shared = sum(1 for r in range(world) if place(r) == place(rank))

    with _ieee_fp32():
        # --- 1. machine parameters (the portable benchmarks) ---------------
        before = kernels.launches()
        comp = _compute_model(MACHINES[machine_for_platform(dev.type)],
                              compute_sizes(n // g), dev, group, shared)
        calibration_launches = _launches(before, group)
        L, beta, cal, avg = measure_links(group, dev, g)
        machine = dataclasses.replace(comp.machine, latency=L,
                                      inv_bandwidth=beta)
        comp = dataclasses.replace(comp, machine=machine)
        # One context; est_Cal vs est_NoCal are evaluation options, not
        # rebuilt calibration surfaces.
        ctx_cal = AlgoContext(CommModel(machine, cal), comp)

        # --- 2. run + 3. compare -------------------------------------------
        grid = make_grid_mesh(g, g, devices=[place(r) for r in range(world)],
                              group=group)
        rng = np.random.default_rng(0)
        host = {"A": rng.standard_normal((n, n)).astype(np.float32),
                "B": rng.standard_normal((n, n)).astype(np.float32)}
        host["U"] = (np.triu(rng.standard_normal((n, n)), 1) / math.sqrt(n)
                     + 4.0 * np.eye(n)).astype(np.float32)
        glob = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        del host
        glob["SPD"] = glob["A"] @ glob["A"].mT
        glob["SPD"].diagonal().add_(float(n))
        args = {"matmul": ("A", "B"), "trsm": ("U", "B"),
                "cholesky": ("SPD",)}
        blocks = {k: distribute(v, grid) for k, v in glob.items()}
        if rank != 0:
            del glob

        results = {}
        for (algo, variant), alg_fn in ALGORITHMS.items():
            if variant.startswith("2.5d"):
                continue   # 2D grid here; 2.5D needs c > 1 layers of ranks
            op = "matmul" if algo in ("cannon", "summa") else algo
            ops = [blocks[k] for k in args[op]]
            hooks = _local_hooks(algo, "pallas")

            def call():
                return alg_fn(*ops, grid=grid, **hooks)

            before = kernels.launches()
            meas = _measure(call, dev, group, reps)
            launches = _launches(before, group)
            out = collect(call(), grid)
            _sync(dev)
            rel = None
            if rank == 0:
                want = _library(op, [glob[k] for k in args[op]])
                rel = float((out - want).abs().max() / want.abs().max())
                del want
            del out
            est_c = evaluate(ctx_cal, algo, variant, n, p2d, r=1).total
            est_n = evaluate(ctx_cal, algo, variant, n, p2d, r=1,
                             options=EvalOptions("nocal")).total
            results[f"{algo}_{variant}"] = {
                "measured_s": meas, "est_cal_s": est_c, "est_nocal_s": est_n,
                "cal_rel_err": abs(est_c - meas) / meas,
                "nocal_rel_err": abs(est_n - meas) / meas,
                "rel_residual": rel, "launches": launches,
            }

    cal_errs = [v["cal_rel_err"] for v in results.values()]
    nocal_errs = [v["nocal_rel_err"] for v in results.values()]
    return {"n": n, "p": p2d,
            "machine_peak_per_unit": machine.peak_flops_per_unit,
            "latency_s": L, "beta": beta,
            "measured_factors": {str(k): v for k, v in avg.items()},
            "compute_curves": {rout: {"eff_max": c.eff_max, "n0": c.n0}
                               for rout, c in comp.efficiency.items()},
            "calibration_launches": calibration_launches,
            "results": results,
            "geomean_rel_err_cal": float(np.exp(np.mean(np.log(
                np.maximum(cal_errs, 1e-9))))),
            "geomean_rel_err_nocal": float(np.exp(np.mean(np.log(
                np.maximum(nocal_errs, 1e-9)))))}


def main(world: int = 4, n: Optional[int] = None, device: str = "cuda",
         backend: str = "gloo", reps: int = 3) -> dict:
    from ..devices import device_kind_of
    from ..distributed import devices_for, transport
    from .common import run_group_bench
    _grid_side(world)
    out = run_group_bench(measure, world, device, backend,
                          args=(n, reps, backend))
    out.update(transport=transport(backend, device), world=world,
               device=device_kind_of(devices_for(device, backend)(0)))
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--n", type=int, default=None,
                    help="matrix size (default 512 * isqrt(world))")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    args = ap.parse_args()
    print(json.dumps(main(args.world, args.n, args.device, args.backend)))
