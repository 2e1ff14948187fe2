#!/usr/bin/env python3
"""Where the time goes on the port's paths, on one GPU.

Runs ``repro_torch.linalg.matmul / trsm / cholesky`` at n = 16384, fp32,
on the default device (p = 1), and the LM prefill
(``repro_torch.launch.prefill``) of starcoder2-3b, hymba-1.5b, xlstm-350m,
qwen2-moe-a2.7b, llama-3.2-vision-11b and whisper-tiny at full width and
depth and of arctic-480b at depth 1, bf16, 4 prompts of 4096 tokens, each
once to warm up and once under ``torch.profiler``.  It prints one JSON line per call: the wall
time of the profiled call, the device time summed over device-side events
(kernels and copies; the host ops that launch them carry the same time
again and are left out), the device-busy share of the wall time, and the
kernels by device time; for a prefill also the device time of its
kernels (K4, K5 with its three launches summed, K6) against cuBLAS's bf16
and fp32 products against the rest.  Builds the
CUDA kernels first, as chip_smoke.py does, and prints what ptxas reports
for each kernel function of the sources (registers, spills, static shared
memory; nvcc -Xptxas -v with the build's flags), and what the loaded
K1 fp32 body reports (registers, spill bytes, static and dynamic shared
memory, resident CTAs an SM).  In each linalg call it splits K1's device
time by the product classes the path launches: (a) n x n x n, (b) the
trsm's rank-256 trailing updates (m = n, k = 256), (c) the Cholesky's
syrk (m = n' < n, k = 256).  Last, the device time of one call of K2, K3
and K1 at the shapes chip_smoke.py checks (K1 also against K at the
trailing-update width), and of the library call beside each (the
profiler's device events only: at small shapes the CUDA-event times of
chip_smoke.py are the wrappers' host time), and of one K5 call at
hymba-1.5b's and xlstm-350m's shapes, split over its three launches, and
of one K6 call at xlstm-350m's sLSTM shape.
Exits non-zero without a CUDA device or when a profile holds no device
time.

Usage, from the root of a checkout on a machine with a CUDA GPU:

    python3 chip_profile.py
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
N = 16384
TOP = 8
# K5's CUDA functions: chunk states, the state pass, the outputs
K5_KERNEL = re.compile(r"ssm_(chunk_state|state_pass|output)_kernel")
# the prefill calls, each with its kernels and their CUDA functions (K4's
# bf16 body: flash_tc_kernel), and the layer count where the full depth does
# not fit one card (arctic-480b: 35 layers of 26.8 GB of experts each)
K4_BF16 = re.compile("flash_tc_kernel")
PREFILL = (("starcoder2-3b", {"K4": K4_BF16}, None),
           ("hymba-1.5b", {"K5": K5_KERNEL}, None),
           ("xlstm-350m", {"K5": K5_KERNEL,
                           "K6": re.compile("slstm_scan_kernel")}, None),
           ("qwen2-moe-a2.7b", {"K4": K4_BF16}, None),
           ("llama-3.2-vision-11b", {"K4": K4_BF16}, None),
           ("whisper-tiny", {"K4": K4_BF16}, None),
           ("arctic-480b", {"K4": K4_BF16}, 1))
BATCH = 4
PROMPT_LEN = 4096
# cuBLAS's matrix product kernels (nvjet_* are its Hopper kernels); those
# with f32f32 or simt_sgemm in the name take fp32 operands: on the prefill
# path the plain chunked attention (hymba's window), cross-attention's
# _sdpa, the fp32 gates (hymba's wdt, xlstm's gates) and the MoE routers
PRODUCT = re.compile(r"gemm|xmma|cutlass|cublas|nvjet", re.IGNORECASE)
FP32_PRODUCT = re.compile(r"f32f32|simt_sgemm")
# the kernel of torch.cuda._sleep
SPIN = "spin_kernel"


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch import linalg
    from repro_torch.kernels import _build
    from repro_torch.tuner import PlanCache, Tuner
    torch.backends.cuda.matmul.allow_tf32 = False
    ext = _build.extension()
    ptxas_report(_build)
    if hasattr(ext, "matmul_info"):   # absent from builds of older sources
        regs, spill, static, dynamic, ctas = ext.matmul_info()
        print(json.dumps({"k1_fp32_body": {
            "registers": regs, "spill_bytes": spill, "static_smem": static,
            "dynamic_smem": dynamic, "ctas_per_sm": ctas}}), flush=True)
    k1_shapes = record_k1_shapes(ext)
    plan_dir = os.path.join(HERE, "build", "profile_plans")
    shutil.rmtree(plan_dir, ignore_errors=True)
    tuner = Tuner(cache=PlanCache(plan_dir))
    gen = torch.Generator(device="cuda").manual_seed(0)
    for op in ("matmul", "trsm", "cholesky"):
        args = operands(torch, op, N, gen)
        getattr(linalg, op)(*args, tuner=tuner)          # warm-up
        k1_shapes.clear()
        record = profiled(torch, lambda: getattr(linalg, op)(*args,
                                                            tuner=tuner))
        del record["all"]
        k1 = k1_by_class(record.pop("events"), k1_shapes, N)
        print(json.dumps({"op": op, "n": N, **record, "k1_by_class": k1}),
              flush=True)
        if record["device_ms"] <= 0:
            print("chip_profile: the profile holds no device time",
                  file=sys.stderr)
            return 1
        del args
        torch.cuda.empty_cache()

    import dataclasses
    from repro_torch.configs import get
    from repro_torch.launch.prefill import make_prefill_step, stub_inputs
    from repro_torch.models import build_model
    for arch, functions, layers in PREFILL:
        cfg = get(arch)
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        model = build_model(cfg)
        net = model.init(0)
        tokens = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT_LEN),
                               device="cuda", generator=gen)
        stubs = stub_inputs(cfg, BATCH, seed=0, device="cuda")
        step = make_prefill_step(model)
        step(net, tokens, **stubs)                       # warm-up
        record = profiled(torch, lambda: step(net, tokens, **stubs))
        groups = dict.fromkeys(functions, 0.0)
        groups.update({"bf16 products": 0.0, "fp32 products": 0.0,
                       "rest": 0.0})
        for row in record["all"]:
            kernel = next((k for k, f in functions.items()
                           if f.search(row["name"])), None)
            if kernel:
                groups[kernel] += row["ms"]
            elif PRODUCT.search(row["name"]):
                fp32 = FP32_PRODUCT.search(row["name"]) is not None
                groups["fp32 products" if fp32 else "bf16 products"] += \
                    row["ms"]
            else:
                groups["rest"] += row["ms"]
        del record["all"], record["events"]
        print(json.dumps({"prefill": arch, "layers": cfg.n_layers,
                          "batch": BATCH, "prompt_len": PROMPT_LEN,
                          "groups_ms": groups, **record}), flush=True)
        if record["device_ms"] <= 0 or not all(groups[k] > 0
                                               for k in functions):
            print(f"chip_profile: no device time, or none in one of "
                  f"{sorted(functions)}", file=sys.stderr)
            return 1
        del net, stubs
        torch.cuda.empty_cache()
    kernel_device_times(torch, gen)
    k1_device_times(torch, gen)
    k5_device_times(torch, gen)
    k6_device_times(torch, gen)
    return 0


def k6_device_times(torch, gen, reps: int = 10) -> None:
    """Device time of one K6 call at xlstm-350m's sLSTM shape (B 4, S 4096,
    W 1024, fp32, the inputs chip_smoke.py checks), with the device events
    and the counted launches a call; one JSON line."""
    from repro_torch.kernels import slstm_scan_cuda
    z, i, f, o = (torch.randn(4, 4096, 1024, device="cuda", generator=gen)
                  for _ in range(4))
    i.mul_(5.0)
    slstm_scan_cuda(z, i, f, o)
    before = slstm_scan_cuda.launches
    record = profiled(torch, lambda: [slstm_scan_cuda(z, i, f, o)
                                      for _ in range(reps)])
    print(json.dumps({
        "kernel": "K6 slstm_scan", "shape": "xlstm-350m sLSTM", "b": 4,
        "s": 4096, "w": 1024, "device_ms": record["device_ms"] / reps,
        "device_events": len(record["events"]) / reps,
        "counted_launches": (slstm_scan_cuda.launches - before) / reps}),
        flush=True)


def k5_device_times(torch, gen, reps: int = 10) -> None:
    """Device time of one K5 call at hymba-1.5b's SSD shape and at
    xlstm-350m's mLSTM shape (bf16, chip_smoke.py's layouts: heads as views
    of the projections, xlstm's v with the ones column), split over its
    three CUDA launches, with the device events and the counted launches a
    call; one JSON line each."""
    from repro_torch.kernels import ssm_scan_cuda
    dev = torch.device("cuda")
    for shape, b, h, s, dk, dv in (("hymba-1.5b SSD", 4, 25, 4096, 16, 64),
                                   ("xlstm-350m mLSTM", 4, 4, 4096, 256,
                                    257)):
        def heads(d, scale=1.0):
            return (torch.randn(b, s, h, d, device=dev, generator=gen)
                    * scale).bfloat16().transpose(1, 2)
        scale = 0.3 if dk <= 64 else dk ** -0.5
        q, k = heads(dk, scale), heads(dk, scale)
        if dv == 257:
            v = heads(dv - 1)
            v = torch.cat([v, torch.ones_like(v[..., :1])], -1)
        else:
            v = heads(dv)
        la = (-torch.rand(b, s, h, device=dev, generator=gen)
              * 0.1).transpose(1, 2)
        ssm_scan_cuda(q, k, v, la)
        before = ssm_scan_cuda.launches
        record = profiled(torch, lambda: [ssm_scan_cuda(q, k, v, la)
                                          for _ in range(reps)])
        by_launch = {}
        for row in record["all"]:
            m = K5_KERNEL.search(row["name"])
            if m:
                by_launch[m.group(0)] = (by_launch.get(m.group(0), 0.0)
                                         + row["ms"] / reps)
        print(json.dumps({
            "kernel": "K5 ssm_scan", "shape": shape, "bh": b * h, "s": s,
            "dk": dk, "dv": dv, "device_ms": record["device_ms"] / reps,
            "device_events": len(record["events"]) / reps,
            "counted_launches": (ssm_scan_cuda.launches - before) / reps,
            "by_launch_ms": by_launch}), flush=True)
        del q, k, v, la
        torch.cuda.empty_cache()


def k1_device_times(torch, gen) -> None:
    """Device time per call of K1 and of ``torch.matmul`` at the shapes
    chip_smoke.py checks, and at the trailing-update width for K = 256 to
    2048 (the time against K: its slope is the cost of the k-steps, its
    intercept what a tile costs besides); one JSON line each."""
    from repro_torch.kernels import matmul_cuda
    dev = torch.device("cuda")

    def rnd(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    u = rnd(N, N)
    panel = rnd(N - 256, 256)
    cases = [("class (a)", rnd(N, N), rnd(N, N), 2),
             ("class (b), B row stride 16384", rnd(N, 256), u[0:256, 256:],
              10),
             ("class (c), B = panel.mT", panel, panel.mT, 10),
             ("", rnd(4096, 4096), rnd(4096, 4096), 10),
             ("", rnd(300, 700), rnd(700, 260), 10),
             ("4-byte path", rnd(130, 130), rnd(130, 130), 10)]
    cases += [("K sweep at the trailing-update width", rnd(N, k),
               rnd(k, N - 256), 10) for k in (256, 512, 1024, 2048)]
    for layout, a, b, reps in cases:
        (m, k), n = a.shape, b.shape[-1]
        print(json.dumps({
            "kernel": "K1 matmul", "layout": layout or "contiguous",
            "m": m, "k": k, "n": n,
            **device_times(torch, lambda: matmul_cuda(a, b),
                           lambda: torch.matmul(a, b), reps)}), flush=True)
        del a, b
    del u, panel
    torch.cuda.empty_cache()


def kernel_device_times(torch, gen) -> None:
    """Device time per call of K2 and K3 and of the library call computing
    the same function, at the shapes chip_smoke.py checks; one JSON line
    each."""
    from repro_torch.kernels import cholesky_block_cuda, trsm_diag_cuda
    dev = torch.device("cuda")
    for nb, m, ldb in ((256, N - 256, None), (512, N - 512, None),
                       (1024, N - 1024, None), (256, 256, None),
                       (256, N, N), (130, 1000, None)):
        u = (torch.triu(torch.randn(nb, nb, device=dev, generator=gen), 1)
             / nb ** 0.5 + 4.0 * torch.eye(nb, device=dev))
        if ldb:
            b = torch.randn(m, ldb, device=dev, generator=gen)[:, nb:2 * nb]
        else:
            b = torch.randn(m, nb, device=dev, generator=gen)
        print(json.dumps({
            "kernel": "K2 trsm_diag", "nb": nb, "m": m, "ldb": b.stride(0),
            **device_times(torch, lambda: trsm_diag_cuda(u, b),
                           lambda: torch.linalg.solve_triangular(
                               u, b, upper=True, left=False))}), flush=True)
        del u, b
    for nb in (256, 200, 130, 512, 1024):
        g = torch.randn(nb, nb, device=dev, generator=gen)
        a = g @ g.mT + nb * torch.eye(nb, device=dev)
        print(json.dumps({
            "kernel": "K3 cholesky_block", "nb": nb,
            **device_times(torch, lambda: cholesky_block_cuda(a),
                           lambda: torch.linalg.cholesky(a))}), flush=True)


# K1's CUDA functions (the fp32 and bf16 bodies, in any version of
# csrc/matmul.cu)
K1_KERNEL = re.compile(r"matmul\w*_kernel<")


def record_k1_shapes(ext):
    """Wraps the extension's K1 launcher so that each launch appends its
    (m, n, k) to the returned list, in launch order."""
    shapes = []
    launch = ext.matmul

    def recording(*args):
        shapes.append(tuple(args[6:9]))
        return launch(*args)

    ext.matmul = recording
    return shapes


def k1_class(m, n, k, size):
    if m == n == k == size:
        return "a"
    if k == 256 and m == size:
        return "b"
    if k == 256 and m == n:
        return "c"
    return "other"


def k1_by_class(events, shapes, size):
    """K1's device time and launches by product class: the i-th K1 kernel
    on the device (one stream, so in launch order) is the i-th launch."""
    k1 = sorted((start, ms) for name, start, ms in events
                if K1_KERNEL.search(name))
    if len(k1) != len(shapes):
        return {"error": f"{len(k1)} K1 kernels for {len(shapes)} launches"}
    out = {}
    for (_, ms), (m, n, k) in zip(k1, shapes):
        c = out.setdefault(k1_class(m, n, k, size),
                           {"launches": 0, "device_ms": 0.0})
        c["launches"] += 1
        c["device_ms"] += ms
    return out


def device_times(torch, fn, library, reps: int = 10) -> dict:
    """Device time of one call of ``fn`` and of ``library``: the
    device-side events of ``reps`` calls under the profiler, summed, over
    ``reps``; with the events a call, so that a lost event shows."""
    out = {}
    for key, f in (("", fn), ("library_", library)):
        f()
        record = profiled(torch, lambda f=f: [f() for _ in range(reps)])
        out[key + "device_ms"] = record["device_ms"] / reps
        out[key + "device_events"] = len(record["events"]) / reps
    return out


def ptxas_report(build) -> None:
    """One JSON line per kernel function of each ``.cu`` source, as ptxas
    reports it when the source is compiled again with the build's flags and
    ``-Xptxas -v`` (to /dev/null)."""
    from torch.utils.cpp_extension import CUDA_HOME
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    for src in build.sources():
        if not src.endswith(".cu"):
            continue
        res = subprocess.run(
            [nvcc, *build.CUDA_FLAGS, "-Xptxas", "-v", "-c", src, "-o",
             os.devnull], capture_output=True, text=True, check=True)
        entry = None
        for line in res.stderr.splitlines():
            name = re.search(r"Compiling entry function '(\w+)'", line)
            if name:
                entry = {"ptxas": os.path.basename(src),
                         "function": name.group(1)}
            spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                               r"spill loads", line)
            if spills and entry is not None:
                entry["spill_stores"] = int(spills.group(1))
                entry["spill_loads"] = int(spills.group(2))
            regs = re.search(r"Used (\d+) registers", line)
            if regs and entry is not None:
                smem = re.search(r"(\d+) bytes smem", line)
                entry["registers"] = int(regs.group(1))
                entry["static_smem"] = int(smem.group(1)) if smem else 0
                print(json.dumps(entry), flush=True)
                entry = None


def profiled(torch, fn):
    """Wall and device time of one call of ``fn`` under the profiler, and
    the device-side events by time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # a profile can lose its first device event: let that be a spin
        # kernel, left out below
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [{"name": e.key[:90], "ms": e.self_device_time_total / 1e3,
             "count": e.count}
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0 and SPIN not in e.key]
    rows.sort(key=lambda r: -r["ms"])
    device_ms = sum(r["ms"] for r in rows)
    events = [(e.name, e.time_range.start, e.time_range.elapsed_us() / 1e3)
              for e in prof.events()
              if e.device_type == DeviceType.CUDA and SPIN not in e.name]
    return {"wall_ms": wall * 1e3, "device_ms": device_ms,
            "device_busy_share": device_ms / (wall * 1e3),
            "top": rows[:TOP], "all": rows, "events": events}


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
