#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

1. Prints the card's name and power limit (``nvidia-smi``) and builds the
   CUDA kernels from this checkout's sources (``build/torch_ext/``).
2. Holds each kernel (K1 matmul, K2 diagonal-block trsm, K3 block Cholesky)
   to its plain PyTorch version on the card at the main path's shapes, and
   times kernel, plain version and the nearest single PyTorch call with
   CUDA events.
3. Drives the main path: ``repro_torch.linalg.matmul / trsm / cholesky``
   at n = 16384, fp32, on the default devices (one card, p = 1), with the
   kernels' launch counts set to 0 before each call and read after it, and
   the residuals checked against the library.
4. Runs multi-rank plans stacked on the one card (``[cuda:0] * 4`` and
   ``* 8`` at n = 4096) and all 16 variants forced through ``execute`` on
   2x2 and 2x2x2 grids at n = 2048.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero, as do
a machine without a CUDA device and a directory without the checkout.

Usage, from the root of a checkout on a machine with a CUDA GPU:

    python3 chip_smoke.py
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
N_MAIN = 16384
N_MULTI = 4096
N_VARIANTS = 2048
# published peaks of one H100 SXM at 700 W (NVIDIA data sheet, dense)
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port is not beside this script ({exc})",
              file=sys.stderr)
        return 2
    # IEEE fp32 everywhere: the kernels, their plain versions, the library
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.extension()
    emit({"build_s": time.perf_counter() - t0, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    kernels = kernel_checks(torch)
    main_counts = main_path(torch)
    multi_rank(torch)
    forced_variants(torch)

    for entry in kernels:
        entry["launches"] = main_counts[entry["wrapper"]]
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


# -- 2. kernels against their plain versions --------------------------------

def time_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(torch, name, got, want, tol):
    got = got.float()
    want = want.float()
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    abs_err = float((got - want).abs().max())
    rel_err = abs_err / max(float(want.abs().max()), 1e-30)
    check(rel_err < tol, f"{name}: rel err {rel_err:.3e} >= {tol}")
    return abs_err, rel_err


def kernel_checks(torch):
    from repro_torch.kernels import (cholesky_block_cuda, cholesky_block_ref,
                                     matmul_cuda, matmul_ref, trsm_diag_cuda,
                                     trsm_diag_ref)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    out = []

    def entry(name, wrapper, source, replaces, shape, got, want, tol,
              kernel, plain, library, reps, ops, peak, nbytes):
        abs_err, rel_err = compare(torch, name, got, want, tol)
        ms = time_ms(torch, kernel, reps)
        bound = max(ops / peak, nbytes / PEAK_BYTES) * 1e3
        e = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "wrapper": wrapper, "shape": shape,
             "launches": None, "max_abs_err": abs_err,
             "max_rel_err": rel_err, "tol": tol, "ms": ms, "kernel_ms": ms,
             "plain_ms": time_ms(torch, plain, reps),
             "bound_ms": bound,
             "bound_by": ("operations" if ops / peak >= nbytes / PEAK_BYTES
                          else "bytes"),
             "library_ms": (time_ms(torch, library, reps)
                            if library is not None else None)}
        emit({"kernel_check": e})
        out.append(e)

    # K1 at the yardstick shapes and at the main path's product
    for m, k, n, dt, odt, reps in (
            (4096, 4096, 4096, torch.float32, torch.float32, 10),
            (4096, 4096, 4096, torch.bfloat16, torch.float32, 10),
            (300, 700, 260, torch.float32, torch.float32, 50),
            (N_MAIN, N_MAIN, N_MAIN, torch.float32, torch.float32, 2)):
        a = torch.randn(m, k, device=dev, generator=gen).to(dt)
        b = torch.randn(k, n, device=dev, generator=gen).to(dt)
        got = matmul_cuda(a, b, out_dtype=odt)
        want = matmul_ref(a, b, out_dtype=odt)
        if dt == odt:
            lib = lambda a=a, b=b: torch.matmul(a, b)  # noqa: E731
        elif mm_takes_out_dtype(torch):
            lib = lambda a=a, b=b: torch.mm(a, b, out_dtype=odt)  # noqa: E731
        else:
            lib = None
        isz = a.element_size()
        entry(f"K1 matmul {m}x{k}x{n} {str(dt)[6:]}->{str(odt)[6:]}",
              "matmul_cuda", "src/repro_torch/kernels/csrc/matmul.cu",
              "src/repro/kernels/matmul/matmul.py:51", [m, k, n], got, want,
              1e-5,
              lambda a=a, b=b: matmul_cuda(a, b, out_dtype=odt),
              lambda a=a, b=b: matmul_ref(a, b, out_dtype=odt), lib, reps,
              2.0 * m * k * n,
              PEAK_BF16 if dt == torch.bfloat16 else PEAK_FP32,
              (m * k + k * n) * isz + m * n * 4)
        del a, b, got, want

    # K2 and K3 at the main path's block (256: the Cholesky panel's first
    # shape and the diagonal block) and at the wider blocks a profile with
    # kernel constants may plan (perf/kernel.py candidate_tiles): 512 takes
    # K3's in-place body (nb > 336) and both take wider strips.  The bytes
    # count what each function needs: U's upper and A's lower triangle.
    for nb, reps in ((256, 20), (512, 5), (1024, 2)):
        m = N_MAIN - nb
        u = (torch.triu(torch.randn(nb, nb, device=dev, generator=gen), 1)
             / nb ** 0.5 + 4.0 * torch.eye(nb, device=dev))
        b = torch.randn(m, nb, device=dev, generator=gen)
        entry(f"K2 trsm_diag U {nb}x{nb}, B {m}x{nb} f32", "trsm_diag_cuda",
              "src/repro_torch/kernels/csrc/trsm.cu",
              "src/repro/kernels/trsm/trsm.py:57", [m, nb],
              trsm_diag_cuda(u, b), trsm_diag_ref(u, b), 1e-4,
              lambda u=u, b=b: trsm_diag_cuda(u, b),
              lambda u=u, b=b: trsm_diag_ref(u, b),
              lambda u=u, b=b: torch.linalg.solve_triangular(
                  u, b, upper=True, left=False),
              reps, float(m) * nb * nb, PEAK_FP32,
              (nb * (nb + 1) // 2 + 2 * m * nb) * 4)

        g = torch.randn(nb, nb, device=dev, generator=gen)
        a = g @ g.mT + nb * torch.eye(nb, device=dev)
        entry(f"K3 cholesky_block {nb}x{nb} f32", "cholesky_block_cuda",
              "src/repro_torch/kernels/csrc/cholesky.cu",
              "src/repro/kernels/cholesky/cholesky.py:47", [nb],
              cholesky_block_cuda(a), cholesky_block_ref(a), 1e-4,
              lambda a=a: cholesky_block_cuda(a),
              lambda a=a: cholesky_block_ref(a),
              lambda a=a: torch.linalg.cholesky(a), reps, nb ** 3 / 3.0,
              PEAK_FP32, (nb * (nb + 1) // 2 + nb * nb) * 4)
    return out


def mm_takes_out_dtype(torch) -> bool:
    """Whether ``torch.mm`` takes ``out_dtype`` (PyTorch 2.8 and later):
    the one library call for a bf16 x bf16 -> fp32 product."""
    major, minor = (int(x) for x in torch.__version__.split(".")[:2])
    return (major, minor) >= (2, 8)


# -- 3. the main path ---------------------------------------------------------

def fresh_tuner():
    from repro_torch.tuner import PlanCache, Tuner
    plan_dir = os.path.join(HERE, "build", "smoke_plans")
    shutil.rmtree(plan_dir, ignore_errors=True)
    return Tuner(cache=PlanCache(plan_dir))


def plan_summary(plan):
    return {"algo": plan.algo, "variant": plan.variant, "g": plan.g,
            "c": plan.c, "p": plan.p, "local_kernel": plan.local_kernel,
            "tiles": plan.tiles, "predicted_total_s": plan.predicted["total"]}


def operands(torch, op, n, gen):
    dev = torch.device("cuda")
    if op == "matmul":
        return (torch.randn(n, n, device=dev, generator=gen),
                torch.randn(n, n, device=dev, generator=gen))
    if op == "trsm":
        u = torch.triu(torch.randn(n, n, device=dev, generator=gen), 1)
        u = u / n ** 0.5 + 4.0 * torch.eye(n, device=dev)
        return u, torch.randn(n, n, device=dev, generator=gen)
    m = torch.randn(n, n, device=dev, generator=gen)
    a = m @ m.mT
    a.diagonal().add_(n)
    return (a,)


def residual(torch, op, args, out):
    """Relative residual of the result, and a check of its structure."""
    if op == "matmul":
        want = torch.matmul(*args)
        return float((out - want).abs().max() / want.abs().max())
    if op == "trsm":
        u, b = args
        return float(torch.linalg.norm(out @ u - b) / torch.linalg.norm(b))
    (a,) = args
    check(float(torch.triu(out, 1).abs().max()) == 0.0,
          "cholesky: factor is not lower-triangular")
    return float(torch.linalg.norm(out @ out.mT - a) / torch.linalg.norm(a))


PATH_KERNELS = {"matmul": ("matmul_cuda",),
                "trsm": ("matmul_cuda", "trsm_diag_cuda"),
                "cholesky": ("matmul_cuda", "trsm_diag_cuda",
                             "cholesky_block_cuda")}


def main_path(torch):
    from repro_torch import kernels, linalg
    from repro_torch.devices import default_devices
    tuner = fresh_tuner()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    totals = {name: 0 for name in kernels.launches()}
    for op in ("matmul", "trsm", "cholesky"):
        args = operands(torch, op, N_MAIN, gen)
        plan = tuner.plan(op, N_MAIN, devices=default_devices(),
                          dtype="float32")
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = getattr(linalg, op)(*args, tuner=tuner)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launches()
        res = residual(torch, op, args, out)
        emit({"main_path": op, "n": N_MAIN, "dtype": "float32",
              "plan": plan_summary(plan), "wall_s": wall, "residual": res,
              "launches": counts})
        check(res < 1e-4, f"main path {op}: residual {res:.3e}")
        for name in PATH_KERNELS[op]:
            check(counts[name] > 0, f"main path {op}: {name} never launched")
        for name, count in counts.items():
            totals[name] += count
        del args, out
        torch.cuda.empty_cache()
    return totals


# -- 4. multi-rank plans and forced variants on the one card ----------------

def library_result(torch, op, args):
    if op == "matmul":
        return torch.matmul(*args)
    if op == "trsm":
        u, b = args
        return torch.linalg.solve_triangular(u, b, upper=True, left=False)
    return torch.linalg.cholesky(args[0])


def multi_rank(torch):
    from repro_torch import kernels, linalg
    tuner = fresh_tuner()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    for p in (4, 8):
        devices = [torch.device("cuda", 0)] * p
        for op in ("matmul", "trsm", "cholesky"):
            args = operands(torch, op, N_MULTI, gen)
            plan = tuner.plan(op, N_MULTI, devices=devices, dtype="float32")
            kernels.reset_launches()
            out = getattr(linalg, op)(*args, devices=devices, tuner=tuner)
            torch.cuda.synchronize()
            counts = kernels.launches()
            want = library_result(torch, op, args)
            err = float((out - want).abs().max() / want.abs().max())
            emit({"multi_rank": op, "devices": f"cuda:0 x {p}",
                  "n": N_MULTI, "plan": plan_summary(plan), "rel_err": err,
                  "launches": counts})
            check(err < 1e-4, f"multi-rank {op} p={p}: rel err {err:.3e}")
            for name in PATH_KERNELS[op]:
                check(counts[name] > 0, f"multi-rank {op} p={p}: {name} "
                      "never launched")


def forced_variants(torch):
    from repro_torch import kernels
    from repro_torch.core.machine import H100_SXM
    from repro_torch.linalg import ALGORITHMS
    from repro_torch.perf.kernel import tiles_for_plan
    from repro_torch.tuner.dispatch import execute
    from repro_torch.tuner.plan import ExecutionPlan
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    ops = {op: operands(torch, op, N_VARIANTS, gen)
           for op in ("matmul", "trsm", "cholesky")}
    want = {op: library_result(torch, op, args) for op, args in ops.items()}
    for algo, variant in ALGORITHMS:
        c, g = (2, 2) if variant.startswith("2.5d") else (1, 2)
        op = "matmul" if algo in ("cannon", "summa") else algo
        plan = ExecutionPlan(
            algo=algo, variant=variant, n=N_VARIANTS, p=c * g * g, c=c, r=1,
            g=g, local_kernel="pallas", dtype="float32",
            machine=H100_SXM.name, fingerprint="forced", predicted={},
            tiles=tiles_for_plan(H100_SXM, algo, N_VARIANTS, g, "float32"))
        kernels.reset_launches()
        out = execute(plan, *ops[op], devices=[torch.device("cuda", 0)]
                      * plan.p)
        torch.cuda.synchronize()
        counts = kernels.launches()
        err = float((out - want[op]).abs().max() / want[op].abs().max())
        emit({"variant": f"{algo} {variant}", "grid": [c, g, g],
              "n": N_VARIANTS, "rel_err": err, "launches": counts})
        check(err < 1e-4, f"variant {algo} {variant}: rel err {err:.3e}")
        for name in PATH_KERNELS[op]:
            check(counts[name] > 0, f"variant {algo} {variant}: {name} "
                  "never launched")


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
