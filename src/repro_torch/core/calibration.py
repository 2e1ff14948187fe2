"""Portable benchmarks + fitting for the model parameters (paper §IV).

Three benchmark families, mirroring the paper:

1. ``bench_routines`` — local-routine efficiency (paper Fig. 1): times each
   BLAS-like routine over block sizes on one device and fits an
   ``EfficiencyCurve`` per routine.  On a CUDA device each call is timed by
   CUDA events on the device's stream; ``route="kernels"`` times what the
   port's dispatch runs with ``local_kernel="pallas"`` (the hand-written
   kernels K1-K3), ``route="library"`` the ``torch.linalg`` routines.
2. ``bench_ping`` — the LogP latency/bandwidth benchmark (paper Fig. 2).
3. ``bench_contention`` — the paper's contention micro-benchmark
   (Figs. 3-4).

Ping and contention run over a ``torch.distributed`` group (``group=``),
each process one rank (``repro_torch.distributed.spawn``), and return the
same value on every rank.  What they measure is the group's transport: on
a gloo group CUDA tensors are staged through pinned host memory
(``distributed.process_group.stages``), and the staging is part of the
time.  Without a group they refuse: stacked ranks share one device's
memory and have no link between them.

``measured_compute_model`` turns a routine benchmark into a fitted
``ComputeModel`` (the peak re-measured as the best dgemm rate), and
``register_measured_profile`` registers it as a new revision of the
machine's profile, which re-keys the tuner's plan cache.

``fit_hopper_calibration`` recovers the paper's (unpublished) calibration
surface by fitting ``ParametricCalibration`` to the paper's *published*
Cannon predictions (Table II) — then §Paper-validation checks the fit
transfers to SUMMA/TRSM/Cholesky (Tables III-V), which is the paper's own
claim that one set of benchmarked parameters predicts all algorithms.
These fits are pure numpy and identical to the reference package's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from .. import paths
from . import algorithms as alg
from .fitting import multistart_nelder_mead
from .machine import H100_SXM, HOPPER, Machine
from .paper_data import CORE_COUNTS, PAPER_TABLES
from .perfmodel import (CommModel, ComputeModel, EfficiencyCurve,
                        HOPPER_EFFICIENCY, ParametricCalibration,
                        ROUTINE_FLOPS)

ROUTES = ("kernels", "library")


# ---------------------------------------------------------------------------
# 1. Local routine efficiency (paper Fig. 1)
# ---------------------------------------------------------------------------


def _time_call(fn: Callable, *args, reps: int = 3, device=None) -> float:
    """Best of ``reps`` timed calls, in seconds; the caller has made the
    warm-up call.  On a CUDA device each call is timed by a pair of CUDA
    events on the device's current stream; on the CPU by the host
    clock."""
    import torch
    cuda = device is not None and torch.device(device).type == "cuda"
    best = float("inf")
    for _ in range(reps):
        if cuda:
            stream = torch.cuda.current_stream(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            fn(*args)
            end.record(stream)
            end.synchronize()
            secs = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            fn(*args)
            secs = time.perf_counter() - t0
        best = min(best, secs)
    return best


def _routine_fns(route: str) -> Dict[str, Callable]:
    """The five routines on ``route``.  The kernels route is what dispatch
    runs with ``local_kernel="pallas"``: dgemm is K1, dtrsm the blocked
    solve (K2 on the diagonal blocks, K1 for the trailing updates), dsyrk
    the Cholesky's trailing product ``X @ X^T`` through K1 (whose wrapper
    copies the transposed view to unit column stride, as it does inside the
    Cholesky), dpotrf the blocked Cholesky (K3, K2, K1).  Neither package
    has an LU kernel, so dgetrf is the library's on both routes.  Below
    their wrappers' thresholds the kernels run their plain versions."""
    import torch
    lu = torch.linalg.lu_factor
    if route == "kernels":
        from ..kernels.cholesky.ops import cholesky
        from ..kernels.matmul.ops import matmul
        from ..kernels.trsm.ops import trsm
        return {"dgemm": matmul, "dtrsm": trsm,
                "dsyrk": lambda x, y: matmul(x, y.mT),
                "dpotrf": cholesky, "dgetrf": lu}
    if route == "library":
        return {"dgemm": torch.matmul,
                "dtrsm": lambda u, b: torch.linalg.solve_triangular(
                    u, b, upper=True, left=False),
                "dsyrk": lambda x, y: x @ y.mT,
                "dpotrf": torch.linalg.cholesky, "dgetrf": lu}
    raise ValueError(f"route must be one of {ROUTES}, got {route!r}")


@contextlib.contextmanager
def _ieee_fp32():
    """Float32 products in IEEE fp32 (no TF32) for the duration."""
    import torch
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def time_routines(sizes: Sequence[int] = (128, 256, 512, 1024, 2048),
                  dtype=None, *, device=None, route: str = "kernels",
                  reps: int = 3) -> List[dict]:
    """One entry per (routine, size): ``seconds`` (best of ``reps`` after
    a warm-up), ``flops_per_s`` (the routine's FLOP count over it) and
    ``launches``, the change in every kernel wrapper's launch count over
    one call, which says whether the size ran a kernel or a plain version.

    Operands come from a ``torch.Generator`` seeded with 0 for every size
    (as the reference seeds one key for all sizes): A standard normal,
    the SPD matrix A A^T + n I, the triangle triu(A) + n I.  ``device``
    defaults to the current CUDA device (no CPU fallback: pass
    ``device="cpu"`` to time the CPU).  The kernel extension is built before
    anything is timed, and the operands of one size are freed before the
    next.
    """
    import torch
    from .. import kernels
    from ..devices import canonical, default_devices
    device = canonical(device) if device is not None else default_devices()[0]
    dtype = dtype or torch.float32
    fns = _routine_fns(route)
    if route == "kernels" and device.type == "cuda":
        from ..kernels import _build
        _build.extension()
    out: List[dict] = []
    with _ieee_fp32():
        for n in sizes:
            gen = torch.Generator(device=device).manual_seed(0)
            a = torch.randn(n, n, generator=gen, device=device).to(dtype)
            eye = n * torch.eye(n, device=device, dtype=dtype)
            args = {"dgemm": lambda: (a, a),
                    "dtrsm": lambda: (torch.triu(a) + eye, a),
                    "dsyrk": lambda: (a, a),
                    "dpotrf": lambda: (a @ a.mT + eye,),
                    "dgetrf": lambda: (a @ a.mT + eye,)}
            for rout in ROUTINE_FLOPS:
                operands = args[rout]()
                # the warm-up call, whose launches are counted
                before = kernels.launches()
                fns[rout](*operands)
                after = kernels.launches()
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                secs = _time_call(fns[rout], *operands, reps=reps,
                                  device=device)
                out.append({"routine": rout, "n": int(n), "seconds": secs,
                            "flops_per_s": ROUTINE_FLOPS[rout](n) / secs,
                            "launches": {k: after[k] - before[k]
                                         for k in after}})
                del operands
            del a, eye, args
            if device.type == "cuda":
                torch.cuda.empty_cache()
    return out


def rates(entries: Sequence[dict]) -> Dict[str, Dict[int, float]]:
    """``time_routines`` entries as ``{routine: {n: FLOP/s}}``."""
    out: Dict[str, Dict[int, float]] = {r: {} for r in ROUTINE_FLOPS}
    for e in entries:
        out[e["routine"]][e["n"]] = e["flops_per_s"]
    return out


def bench_routines(sizes: Sequence[int] = (128, 256, 512, 1024, 2048),
                   dtype=None, *, device=None, route: str = "kernels",
                   reps: int = 3) -> Dict[str, Dict[int, float]]:
    """Measured FLOP/s of each routine per block size (Fig. 1 analog);
    see :func:`time_routines`."""
    return rates(time_routines(sizes, dtype, device=device, route=route,
                               reps=reps))


def fit_efficiency(gflops_by_size: Dict[int, float], peak: float) -> EfficiencyCurve:
    sizes = np.array(sorted(gflops_by_size))
    effs = np.array([gflops_by_size[int(n)] / peak for n in sizes])
    effs = np.clip(effs, 1e-4, 1.0)

    def loss(theta):
        emax, n0 = abs(theta[0]), abs(theta[1]) + 1.0
        pred = np.clip(emax * (1 - np.exp(-sizes / n0)), 1e-4, None)
        return float(np.mean((np.log(pred) - np.log(effs)) ** 2))

    theta, _ = multistart_nelder_mead(loss, np.array([effs.max(), 300.0]), n_starts=4)
    return EfficiencyCurve(float(abs(theta[0])), float(abs(theta[1]) + 1.0))


def measured_compute_model(machine: Machine = H100_SXM,
                           sizes: Sequence[int] = (128, 256, 512, 1024),
                           *, device=None, route: str = "kernels",
                           bench: Optional[Dict[str, Dict[int, float]]] = None
                           ) -> ComputeModel:
    """Benchmark this device and return a fitted ComputeModel.  Also updates
    the machine's peak to the best observed dgemm rate (the paper uses the
    vendor peak; on a measured device, measured peak is the honest analog).
    ``bench`` takes rates already measured (``bench_routines``'s form)
    instead of running the benchmark."""
    if bench is None:
        bench = bench_routines(sizes, device=device, route=route)
    peak = max(bench["dgemm"].values())
    machine = dataclasses.replace(machine, peak_flops_per_unit=peak)
    curves = {r: fit_efficiency(v, peak) for r, v in bench.items()}
    return ComputeModel(machine, curves)


def register_measured_profile(registry, model: ComputeModel,
                              notes: str = "") -> Machine:
    """Register ``model`` (from :func:`measured_compute_model`) in
    ``registry`` as the next revision of its machine's profile: the
    measured peak and fitted curves, the registered calibration surface
    kept.  The new revision changes the machine fingerprint, so a
    :class:`~repro_torch.tuner.Tuner` on ``registry`` plans from new
    plan-cache keys.  Pass a private registry
    (``tuner.build_default_registry()``) to leave the process default
    alone.  Returns the registered :class:`Machine`."""
    surface = registry.machine(model.machine.name)
    machine = dataclasses.replace(
        model.machine, revision=surface.machine.revision + 1,
        notes=notes or f"measured: peak {model.machine.peak_flops_per_unit:.4g} "
                       "FLOP/s (best dgemm), fitted routine efficiency")
    registry.register_machine(machine, dict(model.efficiency),
                              surface.calibration, overwrite=True)
    return machine


# ---------------------------------------------------------------------------
# 2. LogP ping (paper Fig. 2): fit L and beta
# 3. Contention calibration benchmark (paper Figs. 3-4)
# ---------------------------------------------------------------------------

def _link_setup(name: str, group, device, word_bytes: int):
    """The group, each rank's device and the word type of a link
    benchmark; refuses to run without a group."""
    import torch
    if group is None:
        raise ValueError(
            f"{name} needs group=, a torch.distributed group with one "
            "process a rank (repro_torch.distributed.spawn); stacked ranks "
            "share one device's memory and have no link between them")
    from ..devices import canonical, default_devices
    dev = canonical(device) if device is not None else default_devices()[0]
    dtype = torch.float64 if word_bytes == 8 else torch.float32
    return dev, dtype


def _same_on_every_rank(values: Sequence[float], group, dev) -> List[float]:
    """Rank 0's ``values`` on every rank of ``group``."""
    import torch
    from ..distributed.process_group import broadcast, host_or_device
    t = torch.tensor(list(values), dtype=torch.float64,
                     device=host_or_device(group, dev))
    return broadcast(t, 0, group).tolist()


def _settled(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def bench_ping(sizes_words: Sequence[int] = (256, 1024, 4096, 16384, 65536, 262144),
               word_bytes: int = 8, reps: int = 5, *, group=None,
               device=None) -> Dict[int, float]:
    """Round-trip/2 time between ranks 0 and 1 of ``group`` per message
    size (words): rank 0 sends, rank 1 receives into its device's memory
    and sends back, rank 0's clock stops when the message is back in its
    device's memory; one untimed round trip, then the best of ``reps``,
    halved.  Other ranks wait.  ``device`` is this rank's (default: the
    current CUDA device).  Every rank returns rank 0's result."""
    import torch
    import torch.distributed as dist
    from ..distributed.process_group import recv, send
    dev, dtype = _link_setup("bench_ping", group, device, word_bytes)
    if dist.get_world_size(group) < 2:
        raise ValueError("bench_ping needs a group of at least 2 ranks")
    rank = dist.get_rank(group)
    best = []
    for w in sizes_words:
        x = torch.ones(int(w), dtype=dtype, device=dev)
        t_best = float("inf")
        for rep in range(reps + 1):
            if rank == 0:
                _settled(dev)
                t0 = time.perf_counter()
                send(x, 1, group)
                y = recv(x, 1, group)
                _settled(dev)
                if rep:
                    t_best = min(t_best, time.perf_counter() - t0)
            elif rank == 1:
                y = recv(x, 0, group)
                send(y, 0, group)
        best.append(t_best / 2.0)
    return dict(zip((int(w) for w in sizes_words),
                    _same_on_every_rank(best, group, dev)))


def fit_alpha_beta(ping: Dict[int, float]) -> tuple[float, float]:
    """Least-squares (L, beta) from T(w) = L + beta*w."""
    ws = np.array(sorted(ping))
    ts = np.array([ping[int(w)] for w in ws])
    A = np.stack([np.ones_like(ws, dtype=float), ws.astype(float)], axis=1)
    (L, beta), *_ = np.linalg.lstsq(A, ts, rcond=None)
    return float(max(L, 1e-9)), float(max(beta, 1e-15))


def bench_contention(n_procs: int, distance: int, words: int = 1 << 20,
                     word_bytes: int = 8, reps: int = 5, *, group=None,
                     device=None) -> float:
    """Ranks 0 .. n_procs-1 of ``group`` shift ``words`` by ``distance``
    at once (rank i sends to i + distance, receives from i - distance,
    modulo n_procs) after a barrier; returns the wall seconds of the
    slowest rank (``all_reduce`` of the maximum: the reference's single
    SPMD completion time), best of ``reps`` after one untimed shift.
    Every rank of the group takes part in the barrier and the maximum;
    every rank returns the same value."""
    import torch
    import torch.distributed as dist
    from ..distributed.process_group import (host_or_device, stages,
                                             to_device, to_host)
    dev, dtype = _link_setup("bench_contention", group, device, word_bytes)
    world = dist.get_world_size(group)
    if not 1 <= n_procs <= world:
        raise ValueError(f"need {n_procs} ranks, the group has {world}")
    rank = dist.get_rank(group)
    x = torch.ones(int(words), dtype=dtype, device=dev)
    staged = stages(group, x)
    best = float("inf")
    for rep in range(reps + 1):
        dist.barrier(group)
        t0 = time.perf_counter()
        if rank < n_procs:
            dst = (rank + distance) % n_procs
            src = (rank - distance) % n_procs
            if dst == rank:
                y = x.clone()
            else:
                buf = to_host(x) if staged else x
                y = torch.empty(buf.shape, dtype=dtype, device=buf.device,
                                pin_memory=staged)
                for work in dist.batch_isend_irecv([
                        dist.P2POp(dist.isend, buf,
                                   dist.get_global_rank(group, dst), group),
                        dist.P2POp(dist.irecv, y,
                                   dist.get_global_rank(group, src),
                                   group)]):
                    work.wait()
                if staged:
                    y = to_device(y, dev)
            _settled(dev)
        wall = torch.tensor([time.perf_counter() - t0], dtype=torch.float64,
                            device=host_or_device(group, dev))
        dist.all_reduce(wall, op=dist.ReduceOp.MAX, group=group)
        if rep:
            best = min(best, float(wall.item()))
    return best


# ---------------------------------------------------------------------------
# Fit the Hopper calibration surface to the paper's published Table II
# ---------------------------------------------------------------------------


def _hopper_ctx(calib: ParametricCalibration) -> alg.AlgoContext:
    return alg.AlgoContext(
        comm=CommModel(HOPPER, calib),
        comp=ComputeModel(HOPPER, HOPPER_EFFICIENCY),
    )


def _table_residuals(calib: ParametricCalibration, algos: Sequence[str]) -> np.ndarray:
    """log-space residuals of our models vs the paper's published tables."""
    from .predictor import best_variant
    ctx = _hopper_ctx(calib)
    res = []
    for algo in algos:
        for size, rows in PAPER_TABLES[algo].items():
            for ci, cores in enumerate(CORE_COUNTS):
                p = cores // HOPPER.threads_per_unit
                choices = best_variant(ctx, algo, size, p)
                for variant, published in rows.items():
                    pred = choices[variant]
                    pred_pct = (100.0 * alg.USEFUL_FLOPS[algo](size)
                                / (pred.result.total * cores * HOPPER.peak_flops_per_thread))
                    res.append(math.log(max(pred_pct, 1e-6)) - math.log(published[ci]))
    return np.array(res)


def fit_hopper_calibration(fit_algos: Sequence[str] = ("cannon",),
                           n_starts: int = 6, seed: int = 0) -> ParametricCalibration:
    def loss(theta):
        calib = ParametricCalibration.from_params(theta)
        r = _table_residuals(calib, fit_algos)
        return float(np.mean(r ** 2))

    x0 = ParametricCalibration().params()
    theta, _ = multistart_nelder_mead(loss, x0, n_starts=n_starts, seed=seed,
                                      max_iter=400)
    return ParametricCalibration.from_params(np.abs(theta))


def hopper_fitted_calibration(refit: bool = False) -> ParametricCalibration:
    """Cached fitted surface (``artifacts/hopper_calibration_torch.json``;
    the root is resolved at each call, ``repro_torch.paths``)."""
    path = paths.hopper_cache("calibration")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if not refit and os.path.exists(path):
        with open(path) as f:
            return ParametricCalibration.from_params(json.load(f)["params"])
    calib = fit_hopper_calibration()
    with open(path, "w") as f:
        json.dump({"params": [float(x) for x in calib.params()]}, f)
    return calib


def _ctx_from_theta(theta: np.ndarray) -> alg.AlgoContext:
    """theta = 5 calibration params + (eff_max, n0) for dgemm/dtrsm/dpotrf.
    dsyrk tracks dgemm (same MXU/BLAS3 path).  Efficiency parameters are
    box-constrained to the visually-plausible range of paper Fig. 1
    (eff_max in [0.5, 0.98], n0 in [80, 1200]) so the fit can't push
    compute curves into absurd regions to absorb model-structure error."""

    def _eff(em, n0):
        return EfficiencyCurve(float(np.clip(abs(em), 0.5, 0.98)),
                               float(np.clip(abs(n0), 80.0, 1200.0)))

    calib = ParametricCalibration.from_params(np.abs(theta[:5]))
    eff = {
        "dgemm": _eff(theta[5], theta[6]),
        "dtrsm": _eff(theta[7], theta[8]),
        "dpotrf": _eff(theta[9], theta[10]),
        "dsyrk": _eff(theta[5], theta[6]),
    }
    return alg.AlgoContext(comm=CommModel(HOPPER, calib),
                           comp=ComputeModel(HOPPER, eff))


def _residuals_ctx(ctx: alg.AlgoContext, algos: Sequence[str],
                   core_idx: Optional[Sequence[int]] = None) -> np.ndarray:
    from .predictor import best_variant
    res = []
    for algo in algos:
        for size, rows in PAPER_TABLES[algo].items():
            for ci, cores in enumerate(CORE_COUNTS):
                if core_idx is not None and ci not in core_idx:
                    continue
                p = cores // HOPPER.threads_per_unit
                choices = best_variant(ctx, algo, size, p)
                for variant, published in rows.items():
                    pred = choices[variant]
                    pred_pct = (100.0 * alg.USEFUL_FLOPS[algo](size)
                                / (pred.result.total * cores * HOPPER.peak_flops_per_thread))
                    res.append(math.log(max(pred_pct, 1e-6)) - math.log(published[ci]))
    return np.array(res)


#: the joint fit's starting point (``fit_hopper_joint``'s): the
#: calibration surface's defaults, then the dgemm, dtrsm and dpotrf curves'
#: (peak share, knee) pairs.  Read-only; a context built on it stands in
#: for the two-minute fit where a run or a test cannot wait for it.
THETA0 = np.concatenate([ParametricCalibration().params(),
                         [0.92, 350.0, 0.85, 500.0, 0.70, 600.0]])
THETA0.setflags(write=False)


def fit_hopper_joint(train_core_idx: Sequence[int] = (0, 2, 4),
                     n_starts: int = 4, seed: int = 0) -> tuple[alg.AlgoContext, np.ndarray]:
    """Jointly fit calibration + routine-efficiency curves on a train split
    (alternate core counts, all four tables); returns (ctx, theta).
    Held-out columns {1, 3} are the validation set."""

    def loss(theta):
        ctx = _ctx_from_theta(theta)
        r = _residuals_ctx(ctx, list(PAPER_TABLES), core_idx=train_core_idx)
        return float(np.mean(r ** 2))

    theta, _ = multistart_nelder_mead(loss, THETA0.copy(), n_starts=n_starts,
                                      seed=seed, max_iter=600)
    return _ctx_from_theta(theta), theta


def fit_hopper_two_stage(train_core_idx: Sequence[int] = (0, 2, 4),
                         n_starts: int = 6, seed: int = 0) -> tuple[alg.AlgoContext, np.ndarray]:
    """Two-stage fit mirroring the paper's measurement independence:

    stage 1 — calibration surface + dgemm curve from the pure-dgemm
              algorithms (Cannon + SUMMA);
    stage 2 — dtrsm / dpotrf curves from TRSM + Cholesky with stage-1
              parameters frozen (they only add routine terms).
    """

    def loss1(sub):
        theta = np.concatenate([sub, [0.85, 500.0, 0.70, 600.0]])
        ctx = _ctx_from_theta(theta)
        r = _residuals_ctx(ctx, ["cannon", "summa"], core_idx=train_core_idx)
        return float(np.mean(r ** 2))

    x0 = np.concatenate([ParametricCalibration().params(), [0.92, 350.0]])
    sub1, _ = multistart_nelder_mead(loss1, x0, n_starts=n_starts, seed=seed,
                                     max_iter=800)

    def loss2(sub):
        theta = np.concatenate([sub1, sub])
        ctx = _ctx_from_theta(theta)
        r = _residuals_ctx(ctx, ["trsm", "cholesky"], core_idx=train_core_idx)
        return float(np.mean(r ** 2))

    sub2, _ = multistart_nelder_mead(loss2, np.array([0.85, 500.0, 0.70, 600.0]),
                                     n_starts=n_starts, seed=seed, max_iter=800)
    theta = np.concatenate([sub1, sub2])
    return _ctx_from_theta(theta), theta


def hopper_fitted_ctx(refit: bool = False) -> alg.AlgoContext:
    """Cached jointly-fitted Hopper context
    (``artifacts/hopper_joint_torch.json``; the root is resolved at each
    call, ``repro_torch.paths``)."""
    path = paths.hopper_cache("joint")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if not refit and os.path.exists(path):
        with open(path) as f:
            theta = np.array(json.load(f)["theta"])
        return _ctx_from_theta(theta)
    ctx, theta = fit_hopper_two_stage()
    with open(path, "w") as f:
        json.dump({"theta": [float(x) for x in theta]}, f)
    return ctx


def joint_validation_report(ctx: alg.AlgoContext,
                            held_out_idx: Sequence[int] = (1, 3)) -> Dict[str, Dict[str, float]]:
    """Per-table geo-mean relative error and max absolute %-of-peak error
    (the paper's own accuracy metric) on the held-out core counts."""
    from .predictor import best_variant
    out: Dict[str, Dict[str, float]] = {}
    for algo in PAPER_TABLES:
        rel = _residuals_ctx(ctx, [algo], core_idx=held_out_idx)
        abs_err = []
        for size, rows in PAPER_TABLES[algo].items():
            for ci, cores in enumerate(CORE_COUNTS):
                if ci not in held_out_idx:
                    continue
                p = cores // HOPPER.threads_per_unit
                choices = best_variant(ctx, algo, size, p)
                for variant, published in rows.items():
                    pred_pct = (100.0 * alg.USEFUL_FLOPS[algo](size)
                                / (choices[variant].result.total * cores
                                   * HOPPER.peak_flops_per_thread))
                    abs_err.append(abs(pred_pct - published[ci]))
        out[algo] = {
            "geo_mean_rel_err": float(np.exp(np.sqrt(np.mean(rel ** 2))) - 1.0),
            "max_abs_pct_points": float(np.max(abs_err)),
            "mean_abs_pct_points": float(np.mean(abs_err)),
        }
    return out


def validation_report(calib: ParametricCalibration) -> Dict[str, float]:
    """Geometric-mean relative error of our fitted models vs each published
    table (fit quality on cannon; *transfer* quality on the rest)."""
    out = {}
    for algo in PAPER_TABLES:
        r = _table_residuals(calib, [algo])
        out[algo] = float(np.exp(np.sqrt(np.mean(r ** 2))) - 1.0)
    return out
