#!/usr/bin/env python3
"""Where the time goes on the port's main path, on one GPU.

Runs ``repro_torch.linalg.matmul / trsm / cholesky`` at n = 16384, fp32,
on the default device (p = 1) once to warm up and once under
``torch.profiler``, and prints one JSON line per op: the wall time of the
profiled call, the device time summed over device-side events (kernels and
copies; the host ops that launch them carry the same time again and are
left out), the device-busy share of the wall time, and the kernels by
device time.  Builds the CUDA kernels first, as chip_smoke.py does.  Exits
non-zero without a CUDA device or when the profile holds no device time.

Usage, from the root of a checkout on a machine with a CUDA GPU:

    python3 chip_profile.py
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
N = 16384
TOP = 8


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch import linalg
    from repro_torch.kernels import _build
    from repro_torch.tuner import PlanCache, Tuner
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.extension()
    plan_dir = os.path.join(HERE, "build", "profile_plans")
    shutil.rmtree(plan_dir, ignore_errors=True)
    tuner = Tuner(cache=PlanCache(plan_dir))
    gen = torch.Generator(device="cuda").manual_seed(0)
    for op in ("matmul", "trsm", "cholesky"):
        args = operands(torch, op, N, gen)
        getattr(linalg, op)(*args, tuner=tuner)          # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            getattr(linalg, op)(*args, tuner=tuner)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0]
        rows.sort(key=lambda r: -r[1])
        device_ms = sum(r[1] for r in rows)
        print(json.dumps({
            "op": op, "n": N, "wall_ms": wall * 1e3, "device_ms": device_ms,
            "device_busy_share": device_ms / (wall * 1e3),
            "top": [{"name": k[:90], "ms": ms, "count": c}
                    for k, ms, c in rows[:TOP]]}), flush=True)
        if device_ms <= 0:
            print("chip_profile: the profile holds no device time",
                  file=sys.stderr)
            return 1
        del args
        torch.cuda.empty_cache()
    return 0


def operands(torch, op, n, gen):
    """Seeded fp32 operands on the card: A and B for matmul; a
    well-conditioned upper-triangular U and B for trsm; an SPD A for
    cholesky."""
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


if __name__ == "__main__":
    sys.exit(main())
