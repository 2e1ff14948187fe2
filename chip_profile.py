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
of one K6 call at xlstm-350m's prefill and train shapes, split over its
three launches, at chunks of 16 to 128 steps, and of one call of K6's
backward at the train shape.  One warm train step each of starcoder2-3b
and xlstm-350m (chip_smoke.py §10.2's) splits its device time into the
port's kernels (K4; K5, K6 and K6's backward), the K4 and K5 sites'
backward through their twins, the optimizer, the products and the
rest.  Last, one warm n = 16384 matmul of chip_smoke.py §11.2 on a world
of 4 processes on cuda:0 (gloo, blocks staged through pinned host memory),
profiled in every rank: its wall, K1's device time (the products), the
device time of the device-to-host and host-to-device copies (the staging),
and the host time waiting on gloo (the ``comm_wait`` ranges of
``linalg.collectives.GroupComm``).
K1 at each compiled CTA tile: what the loaded body reports, and its
device time at 4096^3 beside ``torch.matmul``'s; K1 on bf16 operands at
4096^3 (its tensor-core body), out in fp32 and in bf16, beside
``torch.mm(out_dtype=)`` and ``torch.matmul``.
Exits non-zero without a CUDA device or when a profile holds no device
time.

Usage, from the root of a checkout on a machine with a CUDA GPU:

    python3 chip_profile.py              # all of the above
    python3 chip_profile.py --k1-tiles   # the build, the ptxas report of
                                         # K1's sources and its tiles alone
    python3 chip_profile.py --k1-bf16-k6-bwd
        # the ptxas report of K1's bf16 and K6's sources, K1 on bf16
        # operands at 4096^3, K6's backward at xlstm-350m's train shape (its
        # launches; chunks of 8 to 64), and xlstm-350m's train step split
    python3 chip_profile.py --k4-wide
        # the ptxas report of K4's and K1's entry sources, K4 at
        # chip_smoke.py's wide shapes (a prefill's B 1, H 16, KV 4, S 4096,
        # causal, at head dims 320, 512 and 640; the small ragged ones) in
        # bf16 and fp32, and K1 on bf16 operands whose rows TMA cannot load
        # as they lie (300 x 700 x 260, 130^3, a column offset of 1), each
        # beside its library call, by CUDA function; copied into an
        # unpacked checkout of another version it times that version's
        # bodies
    python3 chip_profile.py --k4-f32
        # the ptxas report of K4's source, K4's fp32 body at the paths'
        # fp32 shapes (starcoder2-3b's prefill B 4, H 24, KV 2, S 4096, d
        # 128; the fp32 checks' B 1, H 24, KV 2, S 2304; whisper-tiny's
        # self-attention B 1, H 6, S 2304, d 64; B 1, H 16, KV 4, S 4096, d
        # 256), causal, the heads transposed views of a projection, beside
        # SDPA, by CUDA function (SDPA's backend by its kernels' names);
        # copied into an unpacked checkout of another version it times that
        # version's body
    python3 chip_profile.py --k4-f32-designs
        # K4's fp32 body at the same shapes at each tile its launcher
        # picks among at that d (query rows a CTA, rows a thread, chunks
        # of O), and the tile the launcher reports through the wrapper: the
        # source built again with nvcc into a library beside a small entry
        # point and called through ctypes, each against the plain version
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
# K6's: chunk summaries, the carry, the outputs; and its backward
K6_KERNEL = re.compile(r"slstm_(chunk|carry|output)_kernel")
K6_BWD_KERNEL = re.compile(r"slstm_bwd_(chunk_|carry_|output_)?kernel")
# K6's backward's chunk lengths timed through the binding, besides the
# wrapper's (ops.BWD_CHUNK)
K6_BWD_CHUNKS = (8, 16, 32, 64)
# the prefill calls, each with its kernels and their CUDA functions (K4's
# bf16 body: flash_tc_kernel), and the layer count where the full depth does
# not fit one card (arctic-480b: 35 layers of 26.8 GB of experts each)
K4_BF16 = re.compile("flash_tc_kernel")
PREFILL = (("starcoder2-3b", {"K4": K4_BF16}, None),
           ("hymba-1.5b", {"K5": K5_KERNEL}, None),
           ("xlstm-350m", {"K5": K5_KERNEL,
                           "K6": K6_KERNEL}, None),
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
    k1_only = "--k1-tiles" in sys.argv[1:]
    redesigned = "--k1-bf16-k6-bwd" in sys.argv[1:]
    k4_wide = "--k4-wide" in sys.argv[1:]
    k4_f32 = "--k4-f32" in sys.argv[1:]
    if "--k4-f32-designs" in sys.argv[1:]:
        k4_f32_designs(torch, torch.Generator(device="cuda").manual_seed(0))
        return 0
    ptxas_report(_build, only="matmul" if k1_only else
                 ("matmul_bf16", "slstm") if redesigned else
                 ("flash_attention", "matmul.cu", "matmul_bf16") if k4_wide
                 else "flash_attention" if k4_f32 else None)
    gen = torch.Generator(device="cuda").manual_seed(0)
    if k4_f32:
        k4_f32_device_times(torch, gen)
        return 0
    if k4_wide:
        k4_wide_device_times(torch, gen)
        k1_staged_device_times(torch, gen)
        return 0
    if redesigned:
        k1_bf16_device_times(torch, gen)
        k6_device_times(torch, gen, backward_only=True)
        arch, tokens, ranges, functions = TRAIN_PROFILES[1]
        return 0 if train_step_profile(torch, arch, tokens, ranges,
                                       functions, timed_steps=5) else 1
    k1_tile_report(torch, ext)
    if k1_only:
        k1_tile_device_times(torch, gen)
        return 0
    k1_shapes = record_k1_shapes(ext)
    plan_dir = os.path.join(HERE, "build", "profile_plans")
    shutil.rmtree(plan_dir, ignore_errors=True)
    tuner = Tuner(cache=PlanCache(plan_dir))
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
    if not decode_step_profile(torch, gen):
        return 1
    for arch, tokens, backward_ranges, kernel_functions in TRAIN_PROFILES:
        if not train_step_profile(torch, arch, tokens, backward_ranges,
                                  kernel_functions):
            return 1
    kernel_device_times(torch, gen)
    k1_device_times(torch, gen)
    k1_bf16_device_times(torch, gen)
    k1_tile_device_times(torch, gen)
    k5_device_times(torch, gen)
    k6_device_times(torch, gen)
    return 0 if group_profile() else 1


# the world of chip_smoke.py §11.2 on the one card
GROUP_WORLD = 4


def group_profile() -> bool:
    """One warm §11.2 matmul per rank of a gloo world on cuda:0, profiled
    in each rank; prints each rank's split."""
    from repro_torch.distributed import on_first_card, spawn
    root = os.path.join(HERE, "build", "profile_group")
    shutil.rmtree(root, ignore_errors=True)
    ranks = spawn(profile_rank, GROUP_WORLD, device_of_rank=on_first_card,
                  init_dir=os.path.join(root, "init"), timeout_s=600,
                  args=(os.path.join(root, "plans"),))
    for rank, split in enumerate(ranks):
        print(json.dumps({"group_matmul": N, "rank": rank,
                          "world": GROUP_WORLD,
                          "transport": "gloo, staged through pinned host "
                                       "memory", **split}), flush=True)
    return all(r["products_ms"] > 0 for r in ranks)


def profile_rank(rank, world, device, plan_dir):
    """One rank: a cold matmul at n = 16384 on the group, then a warm one
    under the profiler, split into products, staging copies and the host's
    waits on gloo."""
    import torch
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import linalg
    from repro_torch.kernels import _build
    from repro_torch.tuner import PlanCache, Tuner
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.extension()
    tuner = Tuner(cache=PlanCache(os.path.join(plan_dir, str(rank))))
    gen = torch.Generator(device="cuda").manual_seed(0)
    a, b = operands(torch, "matmul", N, gen)
    group = dist.group.WORLD
    linalg.matmul(a, b, tuner=tuner, group=group)            # cold
    torch.cuda.synchronize()
    dist.barrier()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        linalg.matmul(a, b, tuner=tuner, group=group)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    split = {"wall_ms": wall * 1e3, "products_ms": 0.0, "d2h_ms": 0.0,
             "h2d_ms": 0.0, "other_device_ms": 0.0, "comm_wait_host_ms": 0.0,
             "stage_d2h_host_ms": 0.0, "stage_h2d_host_ms": 0.0}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            ms = e.self_device_time_total / 1e3
            if "matmul_f32_kernel" in e.key:
                split["products_ms"] += ms
            elif "DtoH" in e.key:
                split["d2h_ms"] += ms
            elif "HtoD" in e.key:
                split["h2d_ms"] += ms
            else:
                split["other_device_ms"] += ms
        elif e.key in ("comm_wait", "stage_d2h", "stage_h2d"):
            split[f"{e.key}_host_ms"] += e.cpu_time_total / 1e3
    return split


# chip_smoke.py §9's served batch: starcoder2-3b at full width and depth,
# bf16, six requests with prompts of these lengths, a KV ring of 4096
SERVE_PROMPTS = (128, 512, 1000, 2000, 3000, 3900)
SERVE_CACHE = 4096
# the profiler ranges of one decode step: the stacking of the requests'
# caches into the batch, the split back into per-request views, and each
# attention's _sdpa over the whole ring buffer
RANGES = ("cache_stack", "cache_rows", "sdpa_ring")


def ranged(torch, label, fn):
    """``fn`` run inside the profiler range ``label``."""
    def wrapped(*args, **kw):
        with torch.profiler.record_function(label):
            return fn(*args, **kw)
    return wrapped


def range_kernels(events, label):
    """(name, device ms) of every device kernel launched inside the
    profiler ranges named ``label``, found through the ranges' CPU
    children."""
    from torch.autograd import DeviceType
    out = []

    def walk(e):
        out.extend((k.name, k.duration / 1e3) for k in e.kernels)
        for c in e.cpu_children:
            walk(c)
    for e in events:
        if e.name == label and e.device_type == DeviceType.CPU:
            walk(e)
    return out


def decode_step_profile(torch, gen) -> bool:
    """One warm decode step of chip_smoke.py §9's served batch: the six
    requests prefilled into their own caches (FIFO: one whole prompt a
    step), then one batched decode step to warm up and one under the
    profiler.  Prints the step's wall and device time, the device-busy
    share, the device kernels launched, and the device time split into the
    products (cuBLAS kernels outside _sdpa), _sdpa over the ring buffer
    (its products included), the cache stack (torch.cat into the batch)
    and the per-request views, and the rest.  False when the profile holds
    no device time."""
    from repro_torch import kernels
    from repro_torch.configs import get
    from repro_torch.core.machine import H100_SXM
    from repro_torch.models import attention, build_model
    from repro_torch.serving import (FIFOPolicy, ModelBackend, Request,
                                     Scheduler, SchedulerConfig,
                                     cost_model_for)
    from repro_torch.serving import scheduler as sched_mod
    cfg = get("starcoder2-3b")
    model = build_model(cfg)
    net = model.init(0)
    sched = Scheduler(ModelBackend(model, net, max_cache_len=SERVE_CACHE),
                      cost_model_for(cfg, H100_SXM),
                      SchedulerConfig(max_cache_len=SERVE_CACHE,
                                      max_batch=len(SERVE_PROMPTS)),
                      policy=FIFOPolicy())
    for i, n in enumerate(SERVE_PROMPTS):
        sched.submit(Request(rid=f"r{i}", max_new_tokens=8,
                             prompt=torch.randint(0, cfg.vocab_size, (1, n),
                                                  device="cuda",
                                                  generator=gen)))
    while not all(rs.out for rs in sched.active.values()) or \
            len(sched.active) < len(SERVE_PROMPTS):
        sched.step()
    sched.step()                                          # warm-up
    patched = ((sched_mod, "stack_caches", "cache_stack"),
               (sched_mod, "row_of", "cache_rows"),
               (attention, "_sdpa", "sdpa_ring"))
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patched]
    for mod, name, label in patched:
        setattr(mod, name, ranged(torch, label, getattr(mod, name)))
    kernels.reset_launches()
    reports = []
    try:
        record = profiled(torch, lambda: reports.append(sched.step()),
                          keep_profile=True, ranges=RANGES)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    [rep] = reports
    prof = record.pop("profile")
    events = list(prof.events())
    split = {label: sum(ms for _, ms in range_kernels(events, label))
             for label in RANGES}
    sdpa_products = sum(ms for name, ms in range_kernels(events, "sdpa_ring")
                        if PRODUCT.search(name))
    products = sum(r["ms"] for r in record["all"]
                   if PRODUCT.search(r["name"]))
    split["products outside _sdpa"] = products - sdpa_products
    split["rest"] = record["device_ms"] - sum(split.values())
    device_events = len(record.pop("events"))
    del record["all"]
    print(json.dumps({
        "decode_step": "starcoder2-3b", "dtype": cfg.dtype,
        "layers": cfg.n_layers, "decode_batch": rep.decode_batch,
        "prefill_tokens": rep.prefill_tokens,
        "context_lens": [rs.context_len for rs in sched.active.values()],
        "max_cache_len": SERVE_CACHE, "device_events": device_events,
        "counted_launches": kernels.launches(),
        "split_ms": split, **record}), flush=True)
    del sched, net
    torch.cuda.empty_cache()
    return record["device_ms"] > 0 and split["sdpa_ring"] > 0


# K6's shapes: xlstm-350m's prefill (B 4, S 4096) and train (B 1, S 1024)
K6_SHAPES = (("xlstm-350m prefill", 4, 4096, 1024),
             ("xlstm-350m train", 1, 1024, 1024))
K6_CHUNKS = (16, 32, 64, 128)


def k6_device_times(torch, gen, reps: int = 10,
                    backward_only: bool = False) -> None:
    """Device time of one K6 call at xlstm-350m's prefill and train shapes
    (fp32, the inputs chip_smoke.py checks: the input gate five times
    wider), split over its three launches, at each chunk length of
    K6_CHUNKS: the wrapper's (``ops.CHUNK``) through the wrapper, the
    others through the binding; with the device events and the counted
    launches a call.  Then one call of K6's backward at the train shape on
    the forward's states, split over its launches, through the wrapper and,
    where the binding takes a chunk, at each of K6_BWD_CHUNKS through the
    binding.  One JSON line each; ``backward_only``: the train shape's
    backward alone."""
    from repro_torch.kernels import (_build, slstm_scan_bwd_cuda,
                                     slstm_scan_cuda)
    from repro_torch.kernels.slstm.ops import CHUNK
    ext = _build.extension()

    def by_launch(record, pattern):
        out = {}
        for row in record["all"]:
            m = pattern.search(row["name"])
            if m:
                out[m.group(0)] = out.get(m.group(0), 0.0) + row["ms"] / reps
        return out

    def binding(z, i, f, o, chunk):
        b, s, w = z.shape
        none = torch.empty(0, device="cuda")
        work = torch.empty(ext.slstm_scan_workspace(b, s, w, chunk),
                           device="cuda")
        ext.slstm_scan(z, i, f, o, torch.empty_like(z), none, none, none,
                       work, chunk, torch.cuda.current_stream().cuda_stream)

    for shape, b, s, w in K6_SHAPES:
        if backward_only and b != 1:
            continue
        z, i, f, o = (torch.randn(b, s, w, device="cuda", generator=gen)
                      for _ in range(4))
        i.mul_(5.0)
        for chunk in () if backward_only else K6_CHUNKS:
            if chunk == CHUNK:
                def call():
                    slstm_scan_cuda(z, i, f, o)
            else:
                def call():
                    binding(z, i, f, o, chunk)
            call()
            before = slstm_scan_cuda.launches
            record = profiled(torch, lambda: [call() for _ in range(reps)])
            by_launch = {}
            for row in record["all"]:
                m = K6_KERNEL.search(row["name"])
                if m:
                    by_launch[m.group(0)] = (by_launch.get(m.group(0), 0.0)
                                             + row["ms"] / reps)
            print(json.dumps({
                "kernel": "K6 slstm_scan", "shape": shape, "b": b, "s": s,
                "w": w, "chunk": chunk, "wrapper_chunk": chunk == CHUNK,
                "device_ms": record["device_ms"] / reps,
                "device_events": len(record["events"]) / reps,
                "counted_launches": (slstm_scan_cuda.launches - before)
                / reps, "by_launch_ms": by_launch}), flush=True)
        if b == 1:
            dy = torch.randn(b, s, w, device="cuda", generator=gen)
            ins = (z, i, f, o, *slstm_scan_cuda(z, i, f, o, states=True)[1:],
                   dy)
            slstm_scan_bwd_cuda(*ins)
            before = slstm_scan_bwd_cuda.launches
            record = profiled(torch, lambda: [slstm_scan_bwd_cuda(*ins)
                                              for _ in range(reps)])
            print(json.dumps({
                "kernel": "K6 slstm_scan_bwd", "shape": shape, "b": b,
                "s": s, "w": w, "device_ms": record["device_ms"] / reps,
                "kernel_ms": sum(r["ms"] for r in record["all"]
                                 if K6_BWD_KERNEL.search(r["name"])) / reps,
                "by_launch_ms": by_launch(record, K6_BWD_KERNEL),
                "device_events": len(record["events"]) / reps,
                "counted_launches": (slstm_scan_bwd_cuda.launches - before)
                / reps}), flush=True)
            if hasattr(ext, "slstm_scan_bwd_workspace"):
                grads = [torch.empty_like(z) for _ in range(4)]
                for chunk in K6_BWD_CHUNKS:
                    work = torch.empty(ext.slstm_scan_bwd_workspace(
                        b, s, w, chunk), device="cuda")

                    def call(chunk=chunk, work=work):
                        ext.slstm_scan_bwd(
                            *ins, *grads, work, chunk,
                            torch.cuda.current_stream().cuda_stream)
                    call()
                    record = profiled(torch, lambda: [call()
                                                      for _ in range(reps)])
                    print(json.dumps({
                        "kernel": "K6 slstm_scan_bwd", "shape": shape,
                        "b": b, "s": s, "w": w, "chunk": chunk,
                        "device_ms": record["device_ms"] / reps,
                        "by_launch_ms": by_launch(record, K6_BWD_KERNEL)}),
                        flush=True)
                del grads, work
            del dy, ins
        del z, i, f, o
        torch.cuda.empty_cache()


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


def k1_bf16_device_times(torch, gen, n: int = 4096) -> None:
    """Device time per call of K1 on bf16 operands at n^3 (the body the
    launcher ran, by its count), out in fp32 and in bf16, beside the one
    library call computing the same (``torch.mm`` with ``out_dtype``, or
    ``torch.matmul``); one JSON line each."""
    from repro_torch.kernels import matmul_cuda
    a = torch.randn(n, n, device="cuda", generator=gen).to(torch.bfloat16)
    b = torch.randn(n, n, device="cuda", generator=gen).to(torch.bfloat16)
    for odt in (torch.float32, torch.bfloat16):
        if odt == torch.bfloat16:
            def library():
                torch.matmul(a, b)
        else:
            def library():
                torch.mm(a, b, out_dtype=odt)
        bodies = dict(getattr(matmul_cuda, "launches_by_body", {}))
        matmul_cuda(a, b, out_dtype=odt)
        ran = {k: v - bodies.get(k, 0) for k, v in
               getattr(matmul_cuda, "launches_by_body", {}).items()
               if v != bodies.get(k, 0)}
        print(json.dumps({
            "kernel": "K1 matmul", "dtype": "bfloat16",
            "out_dtype": str(odt)[6:], "m": n, "k": n, "n": n, "body": ran,
            **device_times(torch, lambda: matmul_cuda(a, b, out_dtype=odt),
                           library)}), flush=True)


def by_function(torch, fn, reps: int) -> dict:
    """Device time of one call of ``fn`` (``reps`` calls under the
    profiler, over ``reps``) and its split by CUDA function."""
    fn()
    record = profiled(torch, lambda: [fn() for _ in range(reps)])
    return {"device_ms": record["device_ms"] / reps,
            "functions_ms": {r["name"]: r["ms"] / reps
                             for r in record["all"]}}


# K4's wide shapes of chip_smoke.py §2: (B, H, KV, S, D, causal, reps)
K4_WIDE = ((1, 16, 4, 4096, 320, True, 5), (1, 16, 4, 4096, 512, True, 5),
           (1, 16, 4, 4096, 640, True, 5), (1, 4, 2, 256, 320, True, 20),
           (2, 4, 2, 300, 320, False, 20), (2, 4, 2, 300, 512, False, 20),
           (1, 4, 2, 300, 320, True, 20), (1, 4, 2, 256, 512, True, 20))


def k4_wide_device_times(torch, gen) -> None:
    """Device time per call of K4 at chip_smoke.py's wide shapes (a
    prefill's B 1, H 16, KV 4, S 4096, causal, at head dims 320, padded to
    384 by the wrapper, 512 and 640; the small ragged ones) in bf16 and
    fp32, and of SDPA's on the same inputs, each split by CUDA function
    (the wrapper's padding copies among them); one JSON line each."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention_cuda
    for dt in (torch.bfloat16, torch.float32):
        for b, h, kv, s, d, causal, reps in K4_WIDE:
            q, k, v = (torch.randn(b, n, s, d, device="cuda",
                                   generator=gen).to(dt) for n in (h, kv, kv))
            print(json.dumps({
                "kernel": "K4 flash_attention", "dtype": str(dt)[6:],
                "shape": [b, h, kv, s, d], "causal": causal,
                **by_function(torch, lambda: flash_attention_cuda(
                    q, k, v, causal=causal), reps),
                "library": by_function(
                    torch, lambda: F.scaled_dot_product_attention(
                        q, k, v, is_causal=causal, enable_gqa=True), reps)}),
                flush=True)
            del q, k, v
            torch.cuda.empty_cache()


# K4's fp32 shapes on the paths (chip_smoke.py §2's): (B, H, KV, S, D, reps)
K4_F32 = ((4, 24, 2, 4096, 128, 3), (1, 24, 2, 2304, 128, 10),
          (1, 6, 6, 2304, 64, 20), (1, 16, 4, 4096, 256, 5))


def k4_f32_device_times(torch, gen) -> None:
    """Device time per call of K4 on fp32 operands at the paths' shapes
    (causal; q, k and v the heads of (B, S, heads * D) projections, as the
    prefill hands them over), and of SDPA's on the same inputs, each split
    by CUDA function; the K4 bodies that ran (``launches_by_body``, where
    the version counts them); one JSON line each."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention_cuda
    for b, h, kv, s, d, reps in K4_F32:
        q, k, v = (torch.randn(b, s, n, d, device="cuda",
                               generator=gen).transpose(1, 2)
                   for n in (h, kv, kv))
        bodies = dict(getattr(flash_attention_cuda, "launches_by_body", {}))
        kernel = by_function(torch, lambda: flash_attention_cuda(
            q, k, v, causal=True), reps)
        ran = {n: c - bodies.get(n, 0) for n, c in
               getattr(flash_attention_cuda, "launches_by_body", {}).items()
               if c != bodies.get(n, 0)}
        print(json.dumps({
            "kernel": "K4 flash_attention", "dtype": "float32",
            "shape": [b, h, kv, s, d], "causal": True,
            "layout": "heads of a projection", "body": ran, **kernel,
            "library": by_function(
                torch, lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True), reps)}),
            flush=True)
        del q, k, v
        torch.cuda.empty_cache()


# the tiles of K4's fp32 body (csrc/flash_attention_f32.cu,
# flash_f32_kernel<BQ, TR, NCH>) that its launcher picks among at each d
K4_F32_DESIGNS = {128: ((128, 8, 1), (64, 4, 4)),
                  64: ((128, 8, 1), (64, 4, 4)),
                  256: ((64, 8, 1), (64, 4, 4), (32, 4, 3))}
K4_F32_ENTRY = """#include "%s"
extern "C" cudaError_t k4_f32_design(
    const void* q, const void* k, const void* v, void* o, int batch,
    int heads, int kv_heads, int sq, int skv, int d, const long long* st,
    float scale, int causal, int bq, int tr, int nch, cudaStream_t stream) {
%s  return cudaErrorInvalidValue;
}
"""


def k4_f32_designs(torch, gen, reps: int = 3) -> None:
    """Device time per call of K4's fp32 body at the paths' fp32 shapes
    (K4_F32) at each tile of K4_F32_DESIGNS, its largest error per row
    against the plain version, and the tile the launcher reports through
    the wrapper; one JSON line a shape."""
    import ctypes
    from repro_torch.kernels import _build, flash_attention_cuda
    from repro_torch.kernels.flash_attention.ops import _ref4
    from torch.utils.cpp_extension import CUDA_HOME
    out = os.path.join(HERE, "build", "profile_k4")
    os.makedirs(out, exist_ok=True)
    calls = "".join(
        f"  if (bq == {bq} && tr == {tr} && nch == {nch}) return "
        f"launch_at<{bq}, {tr}, {nch}>(q, k, v, o, batch, heads, kv_heads, "
        "sq, skv, d, st, scale, causal, stream);\n"
        for bq, tr, nch in sorted({c for cs in K4_F32_DESIGNS.values()
                                   for c in cs}))
    src = os.path.join(out, "designs.cu")
    with open(src, "w") as f:
        f.write(K4_F32_ENTRY % (os.path.join(_build.CSRC,
                                             "flash_attention_f32.cu"),
                                calls))
    lib_path = os.path.join(out, "designs.so")
    subprocess.run([os.path.join(CUDA_HOME, "bin", "nvcc"),
                    *_build.CUDA_FLAGS, "-shared", "-Xcompiler", "-fPIC",
                    "-I", _build.CSRC, "-o", lib_path, src], check=True)
    lib = ctypes.CDLL(lib_path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.k4_f32_design.argtypes = [vp] * 4 + [ci] * 6 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_float] + [ci] * 4 + [vp]
    for b, h, kv, s, d, _ in K4_F32:
        q, k, v = (torch.randn(b, s, n, d, device="cuda",
                               generator=gen).transpose(1, 2)
                   for n in (h, kv, kv))
        want = _ref4(q, k, v, True)
        o = torch.empty(b, h, s, d, device="cuda")
        st = (ctypes.c_longlong * 12)(*[x for t in (q, k, v, o)
                                        for x in t.stride()[:3]])
        designs = {}
        for bq, tr, nch in K4_F32_DESIGNS[d]:
            def call(bq=bq, tr=tr, nch=nch):
                err = lib.k4_f32_design(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    b, h, kv, s, s, d, st, d ** -0.5, 1, bq, tr, nch,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"k4_f32_design: error {err}")
            call()
            torch.cuda.synchronize()
            e = (o - want).abs().amax(-1) / want.abs().amax(-1).clamp(
                min=1e-30)
            designs[f"{bq}x{tr}x{nch}"] = {
                "max_rel_err": float(e.max()),
                "device_ms": by_function(torch, call, reps)["device_ms"]}
        before = dict(flash_attention_cuda.launches_by_body)
        flash_attention_cuda(q, k, v, causal=True)
        chosen = [n for n, c in flash_attention_cuda.launches_by_body.items()
                  if c != before.get(n, 0)]
        print(json.dumps({
            "kernel": "K4 flash_attention fp32 designs",
            "shape": [b, h, kv, s, d], "causal": True,
            "launcher_chose": chosen, "designs": designs}), flush=True)
        del q, k, v, o, want
        torch.cuda.empty_cache()


def k1_staged_device_times(torch, gen, reps: int = 20) -> None:
    """Device time per call of K1 on bf16 operands whose rows TMA cannot
    load as they lie (chip_smoke.py §2's: 300 x 700 x 260 out in fp32, 130^3
    and 2048^3 with A at a column offset of 1 out in bf16), and of the
    library call computing the same (``torch.mm(out_dtype=)``,
    ``torch.matmul``), each split by CUDA function (the wrapper's staging
    copies among them); one JSON line each."""
    from repro_torch.kernels import matmul_cuda
    bf16, f32 = torch.bfloat16, torch.float32

    def rnd(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).to(bf16)

    for layout, a, b, odt in (
            ("rows not 16-byte aligned", rnd(300, 700), rnd(700, 260), f32),
            ("130 columns", rnd(130, 130), rnd(130, 130), bf16),
            ("A at column offset 1", rnd(2048, 2049)[:, 1:],
             rnd(2048, 2048), bf16)):
        library = ((lambda: torch.mm(a, b, out_dtype=odt)) if odt == f32
                   else (lambda: torch.matmul(a, b)))
        print(json.dumps({
            "kernel": "K1 matmul", "layout": layout, "dtype": "bfloat16",
            "out_dtype": str(odt)[6:], "m": a.shape[0], "k": a.shape[1],
            "n": b.shape[1],
            **by_function(torch, lambda: matmul_cuda(a, b, out_dtype=odt),
                          reps),
            "library": by_function(torch, library, reps)}), flush=True)


def k1_tile_report(torch, ext) -> None:
    """What the loaded K1 fp32 body reports at each compiled CTA tile
    (registers, spill bytes, static and dynamic shared memory, resident
    CTAs an SM, threads, stages); one JSON line each."""
    from repro_torch.kernels.matmul import CTA_TILES
    keys = ("registers", "spill_bytes", "static_smem", "dynamic_smem",
            "ctas_per_sm", "threads", "stages")
    for tile in CTA_TILES:
        print(json.dumps({"k1_fp32_body": list(tile),
                          **dict(zip(keys, ext.matmul_info(*tile)))}),
              flush=True)


def k1_tile_device_times(torch, gen, n: int = 4096) -> None:
    """Device time per call of K1 at each compiled CTA tile at n^3, fp32,
    and of ``torch.matmul`` beside it; one JSON line each."""
    from repro_torch.kernels import matmul_cuda
    from repro_torch.kernels.matmul import CTA_TILES
    a = torch.randn(n, n, device="cuda", generator=gen)
    b = torch.randn(n, n, device="cuda", generator=gen)
    for tile in CTA_TILES:
        print(json.dumps({
            "kernel": "K1 matmul", "cta_tile": list(tile), "m": n, "k": n,
            "n": n, **device_times(torch, lambda t=tile: matmul_cuda(
                a, b, tile=t), lambda: torch.matmul(a, b))}), flush=True)


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
# csrc/matmul.cu and csrc/matmul_tile_*.cu)
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


def ptxas_report(build, only=None) -> None:
    """One JSON line per kernel function of each ``.cu`` source (or of those
    whose name starts with ``only``), as ptxas reports it when the source is
    compiled again with the build's flags and ``-Xptxas -v`` (to
    /dev/null)."""
    from torch.utils.cpp_extension import CUDA_HOME
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    for src in build.sources():
        if not src.endswith(".cu") or not os.path.basename(src).startswith(
                only or ""):
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


# one warm train step each (chip_smoke.py §10.2's): (arch, tokens, the
# profiler ranges around the twins' backward passes: label -> (module of
# repro_torch.models, autograd Function), the port's kernels by their CUDA
# functions).  K4's and K5's backward recompute and differentiate their
# twins (_sdpa_chunked, decayed_linear_attention), whose ATen ops the
# ranges hold; K6's backward is its kernel, launched from the binding
# outside any ATen op (the profiler links it to no range), so it is found
# by name
TRAIN_PROFILES = (
    ("starcoder2-3b", 4096,
     {"k4_twin_backward": ("attention", "FlashAttention")}, {"K4": K4_BF16}),
    ("xlstm-350m", 1024, {"k5_twin_backward": ("ssm", "SSMScan")},
     {"K5": K5_KERNEL, "K6": K6_KERNEL, "K6 backward": K6_BWD_KERNEL}),
)


def train_step_profile(torch, arch, tokens, backward_ranges,
                       kernel_functions, timed_steps: int = 0) -> bool:
    """One warm train step of chip_smoke.py §10.2: ``arch`` at full width
    and depth, its own type, remat, one prompt of ``tokens`` tokens, AdamW
    with fp32 moments, through ``Trainer``.  Prints the step's wall and
    device time, the device-busy share, and the device time split into the
    port's kernels (the forward and its recompute under remat; K6's
    backward), each twin's backward (its products included), the
    optimizer, cuBLAS's products elsewhere (the forward, its recompute and
    their backward), and the rest.  False when the profile holds no device
    time, or none in a twin's backward or in one of the kernels.  With
    ``timed_steps``, that many warm steps first, each timed alone without
    the profiler (host clock, ending in a synchronize)."""
    from repro_torch import kernels
    from repro_torch.configs import get
    from repro_torch.models import attention, ssm
    from repro_torch.training import (AdamWConfig, DataConfig, TrainConfig,
                                      Trainer, trainer)
    modules = {"attention": attention, "ssm": ssm}
    cfg = get(arch)
    tr = Trainer(TrainConfig(
        model=cfg, opt=AdamWConfig(lr=3e-4, warmup_steps=20,
                                   total_steps=100),
        data=DataConfig(cfg.vocab_size, tokens, 1, seed=0), n_steps=2),
        seed=0)
    batch = tr.batch_at(0)
    tr.train_step(batch)                                  # warm-up
    walls = []
    for _ in range(timed_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.train_step(batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    labels = (*backward_ranges, "optimizer")
    saved = []
    for label, (module, name) in backward_ranges.items():
        fn_cls = getattr(modules[module], name)
        saved.append((fn_cls, fn_cls.backward))
        fn_cls.backward = staticmethod(ranged(torch, label, fn_cls.backward))
    orig_update = trainer.apply_update
    trainer.apply_update = ranged(torch, "optimizer", orig_update)
    kernels.reset_launches()
    try:
        record = profiled(torch, lambda: tr.train_step(batch),
                          keep_profile=True, ranges=labels)
    finally:
        for fn_cls, orig in saved:
            fn_cls.backward = staticmethod(orig)
        trainer.apply_update = orig_update
    prof = record.pop("profile")
    events = list(prof.events())
    split = {label: sum(ms for _, ms in range_kernels(events, label))
             for label in labels}
    in_ranges = [name for label in labels
                 for name, _ in range_kernels(events, label)]
    ranged_products = sum(ms for label in labels
                          for name, ms in range_kernels(events, label)
                          if PRODUCT.search(name))
    for name, function in kernel_functions.items():
        split[name] = sum(r["ms"] for r in record["all"]
                          if function.search(r["name"]))
    split["products elsewhere"] = sum(
        r["ms"] for r in record["all"]
        if PRODUCT.search(r["name"])) - ranged_products
    split["rest"] = record["device_ms"] - sum(split.values())
    device_events = len(record.pop("events"))
    del record["all"]
    print(json.dumps({
        "train_step": arch, "dtype": cfg.dtype, "layers": cfg.n_layers,
        "remat": cfg.remat, "tokens": tokens,
        "device_events": device_events, "ranged_kernels": len(in_ranges),
        "counted_launches": kernels.launches(), "split_ms": split,
        "warm_walls_ms": walls, **record}), flush=True)
    del tr
    torch.cuda.empty_cache()
    return record["device_ms"] > 0 and all(
        split[label] > 0 for label in (*backward_ranges, *kernel_functions))


def profiled(torch, fn, keep_profile=False, ranges=()):
    """Wall and device time of one call of ``fn`` under the profiler, and
    the device-side events by time (and the profile itself when
    ``keep_profile``).  The device-side marks of the profiler ranges named
    in ``ranges`` are no device work: they are left out of the device time
    and reported apart (their device spans, summed by name)."""
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
    skip = set(ranges) | {SPIN}
    rows, spans = [], dict.fromkeys(ranges, 0.0)
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        if e.key in spans:
            spans[e.key] += e.self_device_time_total / 1e3
        elif not any(k in e.key for k in skip):
            rows.append({"name": e.key[:90],
                         "ms": e.self_device_time_total / 1e3,
                         "count": e.count})
    rows.sort(key=lambda r: -r["ms"])
    device_ms = sum(r["ms"] for r in rows)
    events = [(e.name, e.time_range.start, e.time_range.elapsed_us() / 1e3)
              for e in prof.events()
              if e.device_type == DeviceType.CUDA
              and not any(k in e.name for k in skip)]
    out = {"wall_ms": wall * 1e3, "device_ms": device_ms,
           "device_busy_share": device_ms / (wall * 1e3),
           "top": rows[:TOP], "all": rows, "events": events}
    if ranges:
        out["range_spans_ms"] = spans
    if keep_profile:
        out["profile"] = prof
    return out


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
