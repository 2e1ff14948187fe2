#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

1. Prints the card's name and power limit (``nvidia-smi``) and builds the
   CUDA kernels from this checkout's sources (``build/torch_ext/``).
2. Holds each kernel (K1 matmul, K2 diagonal-block trsm, K3 block Cholesky,
   K4 flash attention, K5 the SSD scan, K6 the sLSTM recurrence) to its
   plain PyTorch version on the card at its path's shapes (K1 at the main
   path's three product classes, on its 4-byte copy path and on a stacked
   batch; K2 also on a strided B and at the Cholesky's last panel, K3 also
   at a ragged width; K4, K5 and K6 in the path's layouts, with the error
   taken per output row; K4 also at head dims 16, 80 and 160, which its
   wrapper pads, and 256; K5 also at xlstm's 256 x 257 state and at small
   ragged shapes; K6 at xlstm's sLSTM shape and a ragged one), and times
   kernel, plain version and the nearest single PyTorch call with CUDA
   events; K1's launcher must refuse arguments it does not take, K3's a
   block wider than one CTA holds, K4's a head dim it has no body for, K5's
   a dk above the widest a tile holds, and K6's binding inputs that are not
   fp32 or not contiguous.
3. Drives the linalg path: ``repro_torch.linalg.matmul / trsm / cholesky``
   at n = 16384, fp32, on the default devices (one card, p = 1), with the
   kernels' launch counts set to 0 before each call and read after it, and
   the residuals checked against the library.
4. Runs multi-rank plans stacked on the one card (``[cuda:0] * 4`` and
   ``* 8`` at n = 4096) and all 16 variants forced through ``execute`` on
   2x2 and 2x2x2 grids at n = 2048.
5. Drives the LM prefill path (``repro_torch.launch.prefill``) at full
   width and depth for starcoder2-3b, hymba-1.5b, xlstm-350m,
   qwen2-moe-a2.7b, llama-3.2-vision-11b (1601 image tokens) and
   whisper-tiny (1500 frames), and for arctic-480b at full width and depth
   1 (35 layers do not fit one card), bf16, 4 prompts of 4096 tokens,
   weights drawn from seed 0 on the card: a cold and a warm call each, the
   counts set to 0 before each and read after it, the peak memory, finite
   logits, K4 (the attention models), K5 (hymba, xlstm's mLSTM) and K6
   (xlstm's sLSTM) launched.
6. Holds that path to the plain versions: starcoder2-3b, hymba-1.5b,
   xlstm-350m, qwen2-moe-a2.7b and llama-3.2-vision-11b (a cross layer
   every 2 layers for this check) at full width and depth 2, whisper-tiny
   at full depth, fp32, one prompt of 2304 tokens (above the 2048 at which
   attention leaves ``_sdpa``), on the card and on the CPU with the same
   state dict: last-position logits within 1e-3 relative, equal argmax, and
   for the MoE the routing of the card against the CPU's; and starcoder2-3b
   in bf16 on the card (K4's tensor-core body) against the CPU's fp32 run
   of the same bf16-valued weights, within 2e-2.
7. Runs the measuring half on ``cuda:0``: the routine-efficiency benchmark
   (``core.calibration.time_routines``) through the kernels (K1-K3) and
   through the library at sizes 256 to 16384, the fitted curves and the
   measured ``h100-sxm`` profile registered in a private registry (a new
   fingerprint); then the linalg calls at n = 16384 warm, unobserved and
   with ``observe=True`` into a temporary run store (one record a call, its
   phases within 10 % of the synchronized host wall time, residual < 1e-4),
   the seed's and the measured profile's predictions beside them, and the
   records joined against both profiles and refitted.
8. Runs the per-rank network simulator through the normal entry points:
   sim-refined plans (``Tuner.plan(refine="sim")``) for p = 4 and 8 at
   n = 4096, executed stacked on ``cuda:0`` through K1-K3; the diagnosis
   loop (a faulted ``sim.Network`` stands in for the measured channel,
   ``probe_links`` names the degraded link, ``emit_degraded_profile``
   registers the faulted ``h100-sxm`` revision and the linalg calls plan
   sim-refined on it unasked); and the records of §7 and §8 joined with
   ``include_sim=True``.  Stacked ranks share one card's memory, so for
   p > 1 measured against simulated is a check of the plumbing, not a
   measurement of NVLink.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero, as do
a machine without a CUDA device and a directory without the checkout.

Usage, from the root of a checkout on a machine with a CUDA GPU:

    python3 chip_smoke.py
"""

from __future__ import annotations

import json
import math
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

    kernels = kernel_checks(torch) + lm_kernel_checks(torch)
    main_counts = main_path(torch)
    multi_rank(torch)
    forced_variants(torch)
    prefill_counts = prefill_path(torch)
    prefill_against_cpu(torch)
    measuring_counts, measured_records, measured_registry = \
        measuring_half(torch)
    simulator_counts = simulator(torch, measured_records, measured_registry)

    for entry in kernels:
        entry["launches"] = (main_counts[entry["wrapper"]]
                             + prefill_counts[entry["wrapper"]]
                             + measuring_counts[entry["wrapper"]]
                             + simulator_counts[entry["wrapper"]])
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


def compare(torch, name, got, want, tol, per_row):
    """Largest absolute error, and the largest error relative to the
    largest value of the reference: over the whole output, or per output
    row (its last axis) when ``per_row``, so that rows of small values are
    held as tightly as rows of large ones."""
    got = got.float()
    want = want.float()
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    err = (got - want).abs()
    abs_err = float(err.max())
    if per_row:
        rel_err = float((err.amax(-1)
                         / want.abs().amax(-1).clamp(min=1e-30)).max())
    else:
        rel_err = abs_err / max(float(want.abs().max()), 1e-30)
    check(rel_err < tol, f"{name}: rel err {rel_err:.3e} >= {tol}")
    return abs_err, rel_err


def kernel_entry(torch, name, wrapper, source, replaces, shape, got, want,
                 tol, kernel, plain, library, reps, ops, peak, nbytes, *,
                 plain_reps=None, library_note=None, per_row=False,
                 layout="contiguous"):
    """Check one kernel result against its plain version, time kernel,
    plain version and library call, and emit the entry of the kernels
    line (its launches are filled in from the path runs)."""
    abs_err, rel_err = compare(torch, name, got, want, tol, per_row)
    ms = time_ms(torch, kernel, reps)
    e = {"name": name, "route": "cuda", "source": source,
         "replaces": replaces, "wrapper": wrapper, "shape": shape,
         "layout": layout, "launches": None, "max_abs_err": abs_err,
         "max_rel_err": rel_err, "rel_to": "row max" if per_row else "max",
         "tol": tol, "ms": ms, "kernel_ms": ms,
         "plain_ms": time_ms(torch, plain, plain_reps or reps),
         "bound_ms": max(ops / peak, nbytes / PEAK_BYTES) * 1e3,
         "bound_by": ("operations" if ops / peak >= nbytes / PEAK_BYTES
                      else "bytes"),
         "library_ms": (time_ms(torch, library, reps)
                        if library is not None else None)}
    if library_note:
        e["library_note"] = library_note
    emit({"kernel_check": e})
    return e


def kernel_checks(torch):
    from repro_torch.kernels import (cholesky_block_cuda, cholesky_block_ref,
                                     matmul_cuda, matmul_ref, trsm_diag_cuda,
                                     trsm_diag_ref)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    out = []

    def entry(*args, **kw):
        out.append(kernel_entry(torch, *args, **kw))

    # K1 at the yardstick shapes, at the three product classes of the main
    # path, on the 4-byte copy path and on a stacked batch.  The classes:
    # (a) the n^3 product (the matmul, and the g = 1 trsm and Cholesky
    # bodies); (b) the trsm's rank-256 trailing update at j = 1, B a
    # strided view of U (row stride 16384) as kernels/trsm/ops.py hands it
    # over; (c) the Cholesky's syrk at its widest, B the panel's transpose
    # passed as .mT as blocked_factor passes it (the wrapper copies it).
    # The 4-byte path: operands whose rows are not 16-byte aligned (130
    # columns; a view at a column offset of 1).  The batch: the local
    # blocks of the [cuda:0] * 8 plans at n = 4096.
    f32, bf16 = torch.float32, torch.bfloat16

    def rnd(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    def k1_cases():
        yield "", (rnd(4096, 4096), rnd(4096, 4096)), f32, 10
        yield "", (rnd(4096, 4096).to(bf16), rnd(4096, 4096).to(bf16)), \
            f32, 10
        yield "", (rnd(300, 700), rnd(700, 260)), f32, 50
        yield "class (a)", (rnd(N_MAIN, N_MAIN), rnd(N_MAIN, N_MAIN)), f32, 2
        u = rnd(N_MAIN, N_MAIN)
        yield "class (b), B row stride 16384", (rnd(N_MAIN, 256),
                                                u[0:256, 256:]), f32, 10
        del u
        panel = rnd(N_MAIN - 256, 256)
        yield "class (c), B = panel.mT", (panel, panel.mT), f32, 10
        yield "4-byte path", (rnd(130, 130), rnd(130, 130)), f32, 50
        yield "4-byte path, A at column offset 1", (
            rnd(2048, 2049)[:, 1:], rnd(2048, 2048)), f32, 10
        yield "stacked batch of 8", (rnd(8, 2048, 2048),
                                     rnd(8, 2048, 2048)), f32, 10

    for layout, (a, b), odt, reps in k1_cases():
        dt = a.dtype
        *batch, m, k = a.shape
        n = b.shape[-1]
        nb = batch[0] if batch else 1
        got = matmul_cuda(a, b, out_dtype=odt)
        want = matmul_ref(a, b, out_dtype=odt)
        if dt == odt:
            lib = lambda a=a, b=b: torch.matmul(a, b)  # noqa: E731
        elif mm_takes_out_dtype(torch):
            lib = lambda a=a, b=b: torch.mm(a, b, out_dtype=odt)  # noqa: E731
        else:
            lib = None
        isz = a.element_size()
        entry(f"K1 matmul {'%dx' % nb if batch else ''}{m}x{k}x{n} "
              f"{str(dt)[6:]}->{str(odt)[6:]}"
              + (f" ({layout})" if layout else ""),
              "matmul_cuda", "src/repro_torch/kernels/csrc/matmul.cu",
              "src/repro/kernels/matmul/matmul.py:51",
              [nb, m, k, n] if batch else [m, k, n], got, want, 1e-5,
              lambda a=a, b=b: matmul_cuda(a, b, out_dtype=odt),
              lambda a=a, b=b: matmul_ref(a, b, out_dtype=odt), lib, reps,
              2.0 * nb * m * k * n, PEAK_BF16 if dt == bf16 else PEAK_FP32,
              nb * ((m * k + k * n) * isz + m * n * 4),
              layout=layout or "contiguous")
        del a, b, got, want
        torch.cuda.empty_cache()
    k1_refuses_type(torch, matmul_cuda)

    # K2 and K3 at the main path's block (256: the Cholesky panel's first
    # shape and the diagonal block) and at the wider blocks a profile with
    # kernel constants may plan (perf/kernel.py candidate_tiles): above 336
    # K3 is a composition of K3, K2 and K1 launches.  Besides: K3 at a
    # ragged 200 (the last panel 8 wide), K2 at the Cholesky's last panel
    # (B 256 x 256: 4 strips of 64 rows) and K2 on a column slice of a
    # 16384-wide B (row stride 16384), as the trsm path hands it over; and
    # each at 130, whose rows are not 16-byte aligned, so the kernels take
    # their 4-byte copies.  The bytes count what each function needs: U's
    # upper and A's lower triangle.
    for nb, m, ldb, reps in ((256, N_MAIN - 256, None, 20),
                             (512, N_MAIN - 512, None, 5),
                             (1024, N_MAIN - 1024, None, 2),
                             (256, 256, None, 20),
                             (256, N_MAIN, N_MAIN, 20),
                             (130, 1000, None, 20)):
        u = (torch.triu(torch.randn(nb, nb, device=dev, generator=gen), 1)
             / nb ** 0.5 + 4.0 * torch.eye(nb, device=dev))
        if ldb:
            b = torch.randn(m, ldb, device=dev, generator=gen)[:, nb:2 * nb]
        else:
            b = torch.randn(m, nb, device=dev, generator=gen)
        entry(f"K2 trsm_diag U {nb}x{nb}, B {m}x{nb} f32"
              + (f" (row stride {ldb})" if ldb else ""), "trsm_diag_cuda",
              "src/repro_torch/kernels/csrc/trsm.cu",
              "src/repro/kernels/trsm/trsm.py:57", [m, nb],
              trsm_diag_cuda(u, b), trsm_diag_ref(u, b), 1e-4,
              lambda u=u, b=b: trsm_diag_cuda(u, b),
              lambda u=u, b=b: trsm_diag_ref(u, b),
              lambda u=u, b=b: torch.linalg.solve_triangular(
                  u, b, upper=True, left=False),
              reps, float(m) * nb * nb, PEAK_FP32,
              (nb * (nb + 1) // 2 + 2 * m * nb) * 4,
              layout=f"row stride {ldb}" if ldb else "contiguous")
        del u, b

    for nb, reps in ((256, 20), (200, 20), (130, 20), (512, 5), (1024, 2)):
        g = torch.randn(nb, nb, device=dev, generator=gen)
        a = g @ g.mT + nb * torch.eye(nb, device=dev)
        entry(f"K3 cholesky_block {nb}x{nb} f32"
              + (" (K3 + K2 + K1)" if nb > 336 else ""),
              "cholesky_block_cuda",
              "src/repro_torch/kernels/csrc/cholesky.cu",
              "src/repro/kernels/cholesky/cholesky.py:47", [nb],
              cholesky_block_cuda(a), cholesky_block_ref(a), 1e-4,
              lambda a=a: cholesky_block_cuda(a),
              lambda a=a: cholesky_block_ref(a),
              lambda a=a: torch.linalg.cholesky(a), reps, nb ** 3 / 3.0,
              PEAK_FP32, (nb * (nb + 1) // 2 + nb * nb) * 4)
    k3_refuses_width(torch, cholesky_block_cuda)
    return out


def heads_view(torch, b, h, s, d, gen, dt, scale=1.0):
    """(B, H, S, D) operands laid out as the prefill path gives them: heads
    split out of a (B, S, H * D) projection, a transposed view with head
    stride D and row stride H * D."""
    x = torch.randn(b, s, h, d, device="cuda", generator=gen) * scale
    return x.to(dt).transpose(1, 2)


def lm_kernel_checks(torch):
    """K4 at starcoder2-3b's prefill shape and, in bf16 and fp32, at the
    reference's test shapes (the ragged edge, the non-causal branch, GQA,
    each head dim), at head dims 16, 80 and 160 (zero-padded to 64, 96 and
    256 by the wrapper) and at 256, and its launcher's refusal of a head
    dim it has no body for; K5 at hymba-1.5b's SSD shape, at xlstm-350m's 256 x 257 mLSTM
    state (v with the normaliser's ones column), at the widest state the
    reference tests and at small ragged shapes, and its launcher's refusal
    of dk = 257.  The path's
    shapes take the path's layouts: the heads as transposed views of the
    projections.  The error is taken per output row, relative to the row's
    largest value.  Both kernels' bf16 outputs are held to the plain
    version run in fp32 on the widened inputs, with no rounding on the
    plain side, within 8e-3: one bf16 rounding of the output is at most
    2^-8 (3.9e-3); K4's rounding of P to bf16 before P V adds about 1e-3.
    fp32 within the summation order."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention_cuda, ssm_scan_cuda
    from repro_torch.kernels.flash_attention.ops import _ref4 as flash_ref
    from repro_torch.kernels.ssm_scan.ops import _ref4 as scan_ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    out = []

    def entry(*args, **kw):
        out.append(kernel_entry(torch, *args, per_row=True, **kw))

    # K4: (B, H, KV, S, D, causal, dtype, path layout, reps)
    bf16, fp32 = torch.bfloat16, torch.float32
    for b, h, kv, s, d, causal, dt, path, reps in (
            (4, 24, 2, 4096, 128, True, bf16, True, 20),
            (1, 8, 1, 384, 128, True, bf16, False, 20),
            (2, 4, 4, 300, 64, False, bf16, False, 20),
            (1, 6, 3, 256, 96, True, bf16, False, 20),
            (1, 4, 2, 256, 16, True, bf16, False, 20),
            (1, 4, 2, 256, 80, True, bf16, False, 20),
            (1, 4, 2, 256, 160, True, bf16, False, 20),
            (1, 4, 2, 256, 256, True, bf16, False, 20),
            (1, 8, 1, 384, 128, True, fp32, False, 20),
            (2, 4, 4, 300, 64, False, fp32, False, 20),
            (1, 6, 3, 256, 96, True, fp32, False, 20),
            (1, 4, 2, 256, 16, True, fp32, False, 20),
            (1, 4, 2, 256, 80, True, fp32, False, 20),
            (1, 4, 2, 256, 160, True, fp32, False, 20),
            (1, 4, 2, 256, 256, True, fp32, False, 20)):
        if path:
            q = heads_view(torch, b, h, s, d, gen, dt)
            k = heads_view(torch, b, kv, s, d, gen, dt)
            v = heads_view(torch, b, kv, s, d, gen, dt)
        else:
            q = torch.randn(b, h, s, d, device=dev, generator=gen).to(dt)
            k = torch.randn(b, kv, s, d, device=dev, generator=gen).to(dt)
            v = torch.randn(b, kv, s, d, device=dev, generator=gen).to(dt)
        pairs = s * (s + 1) // 2 if causal else s * s
        isz = q.element_size()
        entry(f"K4 flash_attention B{b} H{h} KV{kv} S{s} D{d} "
              f"{'causal' if causal else 'full'} {str(dt)[6:]}",
              "flash_attention_cuda",
              "src/repro_torch/kernels/csrc/flash_attention.cu",
              "src/repro/kernels/flash_attention/flash_attention.py:95",
              [b, h, kv, s, d],
              flash_attention_cuda(q, k, v, causal=causal),
              flash_ref(q.float(), k.float(), v.float(), causal),
              8e-3 if dt == bf16 else 1e-5,
              lambda q=q, k=k, v=v, c=causal: flash_attention_cuda(
                  q, k, v, causal=c),
              lambda q=q, k=k, v=v, c=causal: flash_ref(q, k, v, c),
              lambda q=q, k=k, v=v, c=causal:
                  F.scaled_dot_product_attention(q, k, v, is_causal=c,
                                                 enable_gqa=True),
              reps, 4.0 * b * h * d * pairs,
              PEAK_BF16 if dt == bf16 else PEAK_FP32,
              2 * (b * h + b * kv) * s * d * isz, plain_reps=2,
              layout="heads of a projection" if path else "contiguous")
        del q, k, v
        torch.cuda.empty_cache()

    k4_refuses_head_dim(torch, flash_attention_cuda)

    # K5: (B, H, S, DK, DV, dtype, layout, reps); the bound counts the
    # recurrence's 4 DK DV operations a step, the least work of the
    # function.  xlstm's shape runs the 256 x 257 state through the
    # wrapper: q and k heads of the projections scaled by DK^-1/2, v the
    # heads with the ones column concatenated (rows of 514 bytes).  The
    # small shapes reach the branches the path's shapes do not: the
    # reference's test shapes (a zero-filled tail chunk, DK padded to 64; a
    # single chunk at DK 32) and S 300, DK 20, DV 33 (DK padded to 32 in
    # shared memory, element-wise loads of v and stores of y, and in bf16
    # of q and k).
    for b, h, s, dk, dv, dt, layout, reps in (
            (4, 25, 4096, 16, 64, bf16, "heads of a projection", 10),
            (4, 4, 4096, 256, 257, bf16,
             "q, k heads of a projection; v with a ones column", 5),
            (1, 1, 512, 128, 129, fp32, "contiguous", 10),
            (1, 4, 300, 64, 128, bf16, "contiguous", 20),
            (1, 2, 64, 32, 32, fp32, "contiguous", 20),
            (1, 2, 300, 20, 33, fp32, "contiguous", 20),
            (1, 2, 300, 20, 33, bf16, "contiguous", 20)):
        if layout != "contiguous":
            scale = 0.3 if dk <= 64 else dk ** -0.5
            q = heads_view(torch, b, h, s, dk, gen, dt, scale)
            k = heads_view(torch, b, h, s, dk, gen, dt, scale)
            if dv == 257:
                v = heads_view(torch, b, h, s, dv - 1, gen, dt)
                v = torch.cat([v, torch.ones_like(v[..., :1])], -1)
            else:
                v = heads_view(torch, b, h, s, dv, gen, dt)
            la = (-torch.rand(b, s, h, device=dev, generator=gen)
                  * 0.1).transpose(1, 2)
        else:
            q = (torch.randn(b, h, s, dk, device=dev, generator=gen)
                 * 0.3).to(dt)
            k = (torch.randn(b, h, s, dk, device=dev, generator=gen)
                 * 0.3).to(dt)
            v = torch.randn(b, h, s, dv, device=dev, generator=gen).to(dt)
            la = -torch.rand(b, h, s, device=dev, generator=gen) * 0.1
        isz = q.element_size()
        entry(
            f"K5 ssm_scan BH{b * h} S{s} DK{dk} DV{dv} {str(dt)[6:]}",
            "ssm_scan_cuda", "src/repro_torch/kernels/csrc/ssm_scan.cu",
            "src/repro/kernels/ssm_scan/ssm_scan.py:81",
            [b * h, s, dk, dv], ssm_scan_cuda(q, k, v, la),
            scan_ref(q.float(), k.float(), v.float(), la),
            8e-3 if dt == bf16 else 1e-4,
            lambda q=q, k=k, v=v, la=la: ssm_scan_cuda(q, k, v, la),
            lambda q=q, k=k, v=v, la=la: scan_ref(q, k, v, la),
            None, reps, 4.0 * b * h * s * dk * dv,
            PEAK_BF16 if dt == bf16 else PEAK_FP32,
            b * h * s * ((2 * dk + 2 * dv) * isz + 4), plain_reps=1,
            library_note="no single PyTorch call computes it", layout=layout)
        del q, k, v, la
        torch.cuda.empty_cache()

    k5_refuses_dk(torch, ssm_scan_cuda)

    # K6 at xlstm-350m's sLSTM shape (B 4, S 4096, W 1024) and at a small
    # ragged one (a tail of 4 steps behind the 8 a thread loads ahead, a
    # warp of 20 features).  The gates' pre-activations are what the
    # projections of a normed input give, with the input gate five times
    # wider, so that the stabiliser m matters.  fp32 on both sides; the
    # kernel's expf / tanhf and fused multiply-adds against PyTorch's own,
    # over a contractive recurrence: 1e-4 of each output row's largest
    # value.  The bound counts 27 operations a step (each exp, log1p and
    # tanh as one); the bytes (4 inputs read once, y written once) bound it.
    from repro_torch.kernels import slstm_scan_cuda, slstm_scan_ref
    for b, s, w, reps in ((4, 4096, 1024, 10), (1, 300, 20, 20)):
        z, i, f, o = (torch.randn(b, s, w, device=dev, generator=gen)
                      for _ in range(4))
        i.mul_(5.0)
        entry(f"K6 slstm_scan B{b} S{s} W{w} f32", "slstm_scan_cuda",
              "src/repro_torch/kernels/csrc/slstm.cu",
              "none (port-side; the reference scans _slstm_step, "
              "src/repro/models/ssm.py:222)", [b, s, w],
              slstm_scan_cuda(z, i, f, o), slstm_scan_ref(z, i, f, o), 1e-4,
              lambda z=z, i=i, f=f, o=o: slstm_scan_cuda(z, i, f, o),
              lambda z=z, i=i, f=f, o=o: slstm_scan_ref(z, i, f, o),
              None, reps, 27.0 * b * s * w, PEAK_FP32, 5 * b * s * w * 4,
              plain_reps=1, library_note="no single PyTorch call computes "
              "it", layout="contiguous")
        del z, i, f, o
        torch.cuda.empty_cache()
    k6_refuses(torch, slstm_scan_cuda)
    return out


def k6_refuses(torch, wrapper):
    """K6 takes fp32, contiguous inputs only: given bf16 or a transposed
    view, the binding raises with a plain message, nothing is converted or
    copied and nothing counts."""
    z = torch.zeros(1, 64, 32, device="cuda")
    cases = {"fp32": (z.to(torch.bfloat16),) * 4,
             "contiguous": (z.transpose(1, 2),) * 4}
    for what, args in cases.items():
        before = wrapper.launches
        try:
            wrapper(*args)
            refused = ""
        except RuntimeError as exc:
            refused = str(exc).splitlines()[0]
        counted = wrapper.launches - before
        emit({"k6_refuses": what, "message": refused,
              "launches_counted": counted})
        check(f"must be {what}" in refused, f"K6 took inputs that are not "
              f"{what}")
        check(counted == 0, f"K6 counted a refused launch ({what})")


def k5_refuses_dk(torch, wrapper):
    """K5 holds a state of up to 256 rows (dk) in a tile: given 257, the
    binding raises and nothing runs, through the wrapper or called
    directly; nothing counts."""
    from repro_torch.kernels import _build
    ext = _build.extension()
    q = torch.zeros(1, 1, 128, 257, device="cuda")
    v = torch.zeros(1, 1, 128, 4, device="cuda")
    la = torch.zeros(1, 1, 128, device="cuda")
    y = torch.full_like(v, float("nan"))
    work = torch.empty(ext.ssm_scan_workspace(1, 1, 128, 257, 4),
                       device="cuda")
    strides = ([st for t in (q, q, v) for st in t.stride()[:3]]
               + list(la.stride()) + list(y.stride()[:3]))
    before = wrapper.launches
    try:
        wrapper(q, q, v, la)
        wrapper_refused = ""
    except RuntimeError as exc:
        wrapper_refused = str(exc).splitlines()[0]
    try:
        ext.ssm_scan(q.data_ptr(), q.data_ptr(), v.data_ptr(),
                     la.data_ptr(), y.data_ptr(), work.data_ptr(),
                     work.numel(), 0, 1, 1, 128, 257, 4, strides,
                     torch.cuda.current_stream().cuda_stream)
        refused = ""
    except RuntimeError as exc:
        refused = str(exc).splitlines()[0]
    torch.cuda.synchronize()
    untouched = bool(torch.isnan(y).all())
    counted = wrapper.launches - before
    emit({"k5_refuses_dk": 257, "wrapper_message": wrapper_refused,
          "message": refused, "output_untouched": untouched,
          "launches_counted": counted})
    check("dk must be" in wrapper_refused, "K5's wrapper took dk = 257")
    check("dk must be" in refused, "K5's launcher took dk = 257")
    check(untouched and counted == 0, "K5 ran or counted a dk = 257 launch")


def k4_refuses_head_dim(torch, wrapper):
    """K4's C launcher has bodies for head dims 64, 96, 128 and 256 only:
    given 320, the binding raises and nothing runs, in either type.  The
    binding is called directly, past the wrapper's own check."""
    from repro_torch.kernels import _build
    d = 320
    for dt, code in ((torch.bfloat16, 1), (torch.float32, 0)):
        q = torch.zeros(1, 1, 128, d, device="cuda", dtype=dt)
        o = torch.full_like(q, float("nan"))
        strides = [st for t in (q, q, q, o) for st in t.stride()[:3]]
        before = wrapper.launches
        try:
            _build.extension().flash_attention(
                q.data_ptr(), q.data_ptr(), q.data_ptr(), o.data_ptr(), code,
                1, 1, 1, 128, 128, d, strides, d ** -0.5, True,
                torch.cuda.current_stream().cuda_stream)
            refused = ""
        except RuntimeError as exc:
            refused = str(exc).splitlines()[0]
        torch.cuda.synchronize()
        untouched = bool(torch.isnan(o).all())
        counted = wrapper.launches - before
        emit({"k4_refuses_head_dim": d, "dtype": str(dt)[6:],
              "message": refused, "output_untouched": untouched,
              "launches_counted": counted})
        check("head dim must be" in refused,
              f"K4's launcher took d = {d} in {dt}")
        check(untouched and counted == 0,
              f"K4 ran or counted a d = {d} launch in {dt}")


def k1_refuses_type(torch, wrapper):
    """K1's launcher takes the type codes 0 (fp32) and 1 (bf16): given 2,
    the binding raises and nothing runs.  The binding is called directly,
    past the wrapper."""
    from repro_torch.kernels import _build
    a = torch.zeros(128, 128, device="cuda")
    out = torch.full_like(a, float("nan"))
    before = wrapper.launches
    try:
        _build.extension().matmul(
            a.data_ptr(), a.data_ptr(), out.data_ptr(), 2, 0, 1, 128, 128,
            128, 0, 128, 0, 128, 0, 128,
            torch.cuda.current_stream().cuda_stream)
        refused = ""
    except RuntimeError as exc:
        refused = str(exc).splitlines()[0]
    torch.cuda.synchronize()
    untouched = bool(torch.isnan(out).all())
    counted = wrapper.launches - before
    emit({"k1_refuses_type": 2, "message": refused,
          "output_untouched": untouched, "launches_counted": counted})
    check("refused the arguments" in refused,
          "K1's launcher took type code 2")
    check(untouched and counted == 0, "K1 ran or counted a refused launch")


def k3_refuses_width(torch, wrapper):
    """One K3 launch factors at most 336 columns (the wrapper composes
    wider blocks): given 337, the binding raises and nothing runs.  The
    binding is called directly, past the wrapper."""
    from repro_torch.kernels import _build
    nb = 337
    a = torch.eye(nb, device="cuda")
    out = torch.full_like(a, float("nan"))
    before = wrapper.launches
    try:
        _build.extension().cholesky_block(
            a.data_ptr(), out.data_ptr(), 1, nb, a.stride(0), a.stride(0),
            out.stride(0), out.stride(0),
            torch.cuda.current_stream().cuda_stream)
        refused = ""
    except RuntimeError as exc:
        refused = str(exc).splitlines()[0]
    torch.cuda.synchronize()
    untouched = bool(torch.isnan(out).all())
    counted = wrapper.launches - before
    emit({"k3_refuses_width": nb, "message": refused,
          "output_untouched": untouched, "launches_counted": counted})
    check("one launch factors" in refused, "K3's launcher took nb = 337")
    check(untouched and counted == 0, "K3 ran or counted an nb = 337 launch")


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


# -- 5. the LM prefill path at full width and depth --------------------------

# arch -> (the kernels its prefill must launch, the layer count it runs at
# when the full depth does not fit one card, and why)
PREFILL_ARCHS = {
    "starcoder2-3b": (("flash_attention_cuda",), None),
    "hymba-1.5b": (("ssm_scan_cuda",), None),
    "xlstm-350m": (("ssm_scan_cuda", "slstm_scan_cuda"), None),
    "qwen2-moe-a2.7b": (("flash_attention_cuda",), None),
    "llama-3.2-vision-11b": (("flash_attention_cuda",), None),
    "whisper-tiny": (("flash_attention_cuda",), None),
    "arctic-480b": (("flash_attention_cuda",), (
        1, "n_layers 35 -> 1: one layer of 128 x 3 x 7168 x 4864 experts is "
           "26.8 GB in bf16, and 35 layers do not fit one card")),
}
PREFILL_BATCH = 4
PREFILL_LEN = 4096


def prefill_path(torch):
    """A cold and a warm prefill call per model; returns the cold calls'
    launch counts, summed over the models."""
    import dataclasses
    from repro_torch import kernels
    from repro_torch.configs import get
    from repro_torch.launch.prefill import make_prefill_step, stub_inputs
    from repro_torch.models import build_model
    totals = {name: 0 for name in kernels.launches()}
    for arch, (wrappers, cut) in PREFILL_ARCHS.items():
        cfg = get(arch)
        if cut:
            cfg = dataclasses.replace(cfg, n_layers=cut[0])
        model = build_model(cfg)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        net = model.init(SEED)                    # the current GPU
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        tokens = torch.randint(0, cfg.vocab_size,
                               (PREFILL_BATCH, PREFILL_LEN), device="cuda",
                               generator=gen)
        stubs = stub_inputs(cfg, PREFILL_BATCH, seed=SEED, device="cuda")
        step = make_prefill_step(model)
        torch.cuda.synchronize()
        weights_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        calls = []
        for _ in ("cold", "warm"):
            kernels.reset_launches()
            t0 = time.perf_counter()
            logits = step(net, tokens, **stubs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            calls.append((wall, kernels.launches(), logits))
        (cold, cold_counts, logits), (warm, warm_counts, warm_logits) = calls
        tokens_n = PREFILL_BATCH * PREFILL_LEN
        finite = bool(torch.isfinite(logits).all())
        line = {"prefill": arch, "dtype": cfg.dtype, "batch": PREFILL_BATCH,
                "prompt_len": PREFILL_LEN, "layers": cfg.n_layers,
                "params": sum(p.numel() for p in net.parameters()),
                "stub_inputs": {k: list(v.shape) for k, v in stubs.items()},
                "init_s": init_s, "cold_s": cold, "warm_s": warm,
                "cold_tokens_per_s": tokens_n / cold,
                "warm_tokens_per_s": tokens_n / warm,
                "max_memory_allocated": torch.cuda.max_memory_allocated(),
                "max_memory_allocated_init": weights_peak,
                "launches_cold": cold_counts, "launches_warm": warm_counts,
                "logits_shape": list(logits.shape), "logits_finite": finite,
                "argmax": logits[:, -1].argmax(-1).tolist()}
        if cut:
            line["reduced"] = cut[1]
        emit(line)
        check(tuple(logits.shape) == (PREFILL_BATCH, 1, cfg.vocab_size),
              f"prefill {arch}: logits shape {tuple(logits.shape)}")
        check(finite, f"prefill {arch}: non-finite logits")
        check(torch.equal(logits, warm_logits),
              f"prefill {arch}: the warm call's logits differ")
        for counts in (cold_counts, warm_counts):
            for wrapper in wrappers:
                check(counts[wrapper] > 0, f"prefill {arch}: {wrapper} "
                      "never launched")
        for name, count in cold_counts.items():
            totals[name] += count
        del net, logits, warm_logits, calls, stubs, tokens
        torch.cuda.empty_cache()
    return totals


# -- 6. the prefill path against the plain versions ---------------------------

CHECK_LEN = 2304
# (arch, dtype on the card, tolerance of the last position's logits relative
# to their largest value, config changes, the launches each kernel must make
# in the card's call).  fp32: only summation orders differ.  bf16 (K4's
# tensor-core body): the card rounds the activations to bf16 at every layer
# boundary (2^-8 each) and P before P V, the CPU computes in fp32 with the
# same bf16-valued weights; the CPU's own bf16 run of this path at depth 2
# and reduced widths stays within 1e-2 of its fp32 run
# (tests/test_torch_models.py::test_bf16_prefill_stays_near_fp32), so 2e-2
# leaves room for the card's other summation orders.  Depth 2 keeps the CPU
# side short; whisper-tiny runs at full depth (4 + 4 layers).  The VLM's
# pattern is changed for this check only: a cross layer every 2 layers (not
# 5), so that its 2 layers are one self and one cross layer at full width.
CPU_CHECKS = (
    ("starcoder2-3b", "float32", 1e-3, {"n_layers": 2},
     {"flash_attention_cuda": 2}),
    ("hymba-1.5b", "float32", 1e-3, {"n_layers": 2}, {"ssm_scan_cuda": 2}),
    ("starcoder2-3b", "bfloat16", 2e-2, {"n_layers": 2},
     {"flash_attention_cuda": 2}),
    ("xlstm-350m", "float32", 1e-3, {"n_layers": 2},
     {"ssm_scan_cuda": 1, "slstm_scan_cuda": 1}),
    ("qwen2-moe-a2.7b", "float32", 1e-3, {"n_layers": 2},
     {"flash_attention_cuda": 2}),
    ("whisper-tiny", "float32", 1e-3, {}, {"flash_attention_cuda": 4}),
    ("llama-3.2-vision-11b", "float32", 1e-3,
     {"n_layers": 2, "cross_attn_every": 2}, {"flash_attention_cuda": 1}),
)


def check_config(arch, dtype, changes):
    """The config of a §6 check: ``arch`` in ``dtype`` with ``changes``."""
    import dataclasses
    from repro_torch.configs import get
    cfg = get(arch)
    changes = dict(changes, dtype=dtype)
    every = changes.pop("cross_attn_every", None)
    if every:
        changes["vision"] = dataclasses.replace(cfg.vision,
                                                cross_attn_every=every)
    return dataclasses.replace(cfg, **changes)


class RoutingLog:
    """Records every MoE routing decision (``models.moe.route``) made
    while it is installed."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from repro_torch.models import moe
        self._route = moe.route

        def route(*args, **kw):
            r = self._route(*args, **kw)
            self.calls.append((r.gate_idx.cpu(), r.keep.cpu()))
            return r

        moe.route = route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.route = self._route
        return False


def routing_differences(card, cpu):
    """Per MoE layer: tokens whose top-k experts differ, tokens whose kept
    mask differs, and tokens routed."""
    out = []
    for (idx_a, keep_a), (idx_b, keep_b) in zip(card, cpu):
        out.append({"gate_idx_differs": int((idx_a != idx_b).any(-1).sum()),
                    "keep_differs": int((keep_a != keep_b).any(-1).sum()),
                    "tokens": int(idx_a.shape[0] * idx_a.shape[1])})
    return out


def prefill_against_cpu(torch):
    import dataclasses
    from repro_torch import kernels
    from repro_torch.launch.prefill import make_prefill_step, stub_inputs
    from repro_torch.models import build_model
    for arch, dtype, tol, changes, want_counts in CPU_CHECKS:
        cfg = check_config(arch, dtype, changes)
        model = build_model(cfg)
        net = model.init(SEED, device="cuda")
        net_cpu = type(net)(dataclasses.replace(cfg, dtype="float32"),
                            device="cpu")
        net_cpu.load_state_dict({k: v.float().cpu()
                                 for k, v in net.state_dict().items()})
        gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
        tokens = torch.randint(0, cfg.vocab_size, (1, CHECK_LEN),
                               device="cuda", generator=gen)
        stubs = stub_inputs(cfg, 1, seed=SEED + 1, device="cuda")
        step = make_prefill_step(model)
        kernels.reset_launches()
        with RoutingLog() as card_routes:
            got = step(net, tokens, **stubs)
            torch.cuda.synchronize()
        counts = kernels.launches()
        t0 = time.perf_counter()
        with RoutingLog() as cpu_routes:
            want = step(net_cpu, tokens.cpu(),
                        **{k: v.float().cpu() for k, v in stubs.items()})
        cpu_s = time.perf_counter() - t0
        got = got.cpu().float()
        abs_err = float((got - want).abs().max())
        rel_err = abs_err / float(want.abs().max())
        argmax = [int(got.argmax(-1).flatten()[0]),
                  int(want.argmax(-1).flatten()[0])]
        line = {"prefill_vs_cpu": arch, "layers": cfg.n_layers,
                "dtype": dtype, "cpu_dtype": "float32",
                "prompt_len": CHECK_LEN, "config_changes": changes,
                "max_abs_err": abs_err, "max_rel_err": rel_err, "tol": tol,
                "argmax_card_cpu": argmax, "launches": counts,
                "cpu_s": cpu_s}
        if cfg.moe:
            line["routing_card_vs_cpu"] = routing_differences(
                card_routes.calls, cpu_routes.calls)
            check(len(card_routes.calls) == len(cpu_routes.calls)
                  == cfg.n_layers, f"prefill vs cpu {arch}: "
                  f"{len(card_routes.calls)} / {len(cpu_routes.calls)} "
                  "routing decisions recorded")
        emit(line)
        for name, n in want_counts.items():
            check(counts[name] == n, f"prefill vs cpu {arch} {dtype}: "
                  f"{name} launched {counts[name]} times, not {n}")
        check(rel_err < tol, f"prefill vs cpu {arch} {dtype}: rel err "
              f"{rel_err:.3e}")
        if dtype == "float32":
            check(argmax[0] == argmax[1],
                  f"prefill vs cpu {arch}: argmax differs")
        del net, net_cpu, stubs
        torch.cuda.empty_cache()


# -- 7. the measuring half: calibration, the measured profile, recording ------

CAL_SIZES = (256, 512, 1024, 2048, 4096, 8192, 16384)
# the kernel each routine launches on the kernels route at every size of
# CAL_SIZES (all above the wrappers' thresholds; at 256 the solve and the
# factor are one diagonal block, without a K1 update); dgetrf is the
# library's on both routes
CAL_KERNELS = {"dgemm": ("matmul_cuda",),
               "dtrsm": ("trsm_diag_cuda",),
               "dsyrk": ("matmul_cuda",),
               "dpotrf": ("cholesky_block_cuda",)}
# sizes at and above which the curves are fitted a second time, for
# comparison: the local blocks of the p = 1 plans, past the sizes at which
# a call is bound by its launches
LARGE_SIZES = 2048


def measuring_half(torch):
    """Returns the kernel launch counts of the kernels route and of the
    observed linalg calls, summed; the records of the observed calls; and
    the registry of the measured profile they were planned on."""
    import dataclasses
    import tempfile
    from repro_torch import kernels, linalg, telemetry
    from repro_torch.core import calibration as cal
    from repro_torch.core.machine import H100_SXM
    from repro_torch.devices import device_kind_of
    from repro_torch.tuner import PlanCache, Tuner, build_default_registry
    t_start = time.perf_counter()
    check(torch.cuda.device_count() > 0, "measuring half: no cuda:0")
    dev = torch.device("cuda", 0)
    totals = {name: 0 for name in kernels.launches()}

    # 7.1 the routine benchmark on both routes
    bench = {}
    for route in cal.ROUTES:
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        entries = cal.time_routines(CAL_SIZES, device=dev, route=route)
        counts = kernels.launches()
        emit({"calibration": route, "device": device_kind_of(dev),
              "dtype": "float32", "seconds": time.perf_counter() - t0,
              "gflops": {e["routine"] + f" {e['n']}": e["flops_per_s"] / 1e9
                         for e in entries},
              "launches": {e["routine"] + f" {e['n']}":
                           {k: v for k, v in e["launches"].items() if v}
                           for e in entries},
              "launches_total": counts})
        for e in entries:
            rate = e["flops_per_s"]
            check(math.isfinite(rate) and rate > 0,
                  f"calibration {route} {e['routine']} {e['n']}: rate {rate}")
        if route == "kernels":
            for e in entries:
                for name in CAL_KERNELS.get(e["routine"], ()):
                    check(e["launches"][name] > 0,
                          f"calibration {e['routine']} {e['n']}: {name} "
                          "not launched")
            for name in ("matmul_cuda", "trsm_diag_cuda",
                         "cholesky_block_cuda"):
                check(counts[name] > 0, f"calibration: {name} never "
                      "launched")
            for name, count in counts.items():
                totals[name] += count
        else:
            check(not any(counts.values()),
                  f"calibration library route launched {counts}")
        bench[route] = cal.rates(entries)

    # 7.2 the fits and the measured profile
    def curves(rates, least=0):
        peak = max(rates["dgemm"].values())
        return {r: dataclasses.asdict(cal.fit_efficiency(
            {n: v for n, v in vals.items() if n >= least}, peak))
            for r, vals in rates.items()}
    model = cal.measured_compute_model(bench=bench["kernels"])
    registry = build_default_registry()
    measured = cal.register_measured_profile(registry, model)
    emit({"measured_profile": {
        "name": measured.name, "revision": measured.revision,
        "fingerprint": measured.fingerprint(),
        "seed_fingerprint": H100_SXM.fingerprint(),
        "peak_flops": measured.peak_flops_per_unit,
        "seed_peak_flops": H100_SXM.peak_flops_per_unit,
        "library_peak_flops": max(bench["library"]["dgemm"].values()),
        "notes": measured.notes},
        "curves": {route: curves(rates) for route, rates in bench.items()},
        f"curves_n_ge_{LARGE_SIZES}": {
            route: curves(rates, LARGE_SIZES)
            for route, rates in bench.items()}})
    check(measured.fingerprint() != H100_SXM.fingerprint(),
          "the measured profile kept the seed's fingerprint")

    # 7.3 the linalg calls at n = 16384: predictions, unobserved and
    # observed warm calls
    large = build_default_registry()
    large_model = cal.measured_compute_model(
        bench={r: {n: v for n, v in vals.items() if n >= LARGE_SIZES}
               for r, vals in bench["kernels"].items()})
    cal.register_measured_profile(large, large_model,
                                  notes=f"measured, fitted at n >= "
                                        f"{LARGE_SIZES}")
    store = telemetry.RunStore(tempfile.mkdtemp(prefix="smoke_runs_"))
    plan_dir = os.path.join(HERE, "build", "smoke_plans_measured")
    shutil.rmtree(plan_dir, ignore_errors=True)
    tuner = Tuner(registry=registry, cache=PlanCache(plan_dir), store=store)
    seed_tuner = fresh_tuner()
    large_tuner = Tuner(registry=large, cache=PlanCache(plan_dir + "_large"))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    devices = [dev]
    n_records = 0
    for op in ("matmul", "trsm", "cholesky"):
        args = operands(torch, op, N_MAIN, gen)
        predicted = {
            name: t.plan(op, N_MAIN, devices=devices, dtype="float32")
            .predicted["total"]
            for name, t in (("seed", seed_tuner), ("measured", tuner),
                            (f"measured_n_ge_{LARGE_SIZES}", large_tuner))}
        getattr(linalg, op)(*args, devices=devices, tuner=tuner)   # warm-up
        calls = []
        for observe in (False, True, False, True):
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            out = getattr(linalg, op)(*args, devices=devices, tuner=tuner,
                                      observe=observe)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = kernels.launches()
            records = [r for r in store.load() if r.kind == "dispatch"]
            check(len(records) == n_records + observe,
                  f"observed {op}: {len(records) - n_records} records for "
                  f"one call (observe={observe})")
            n_records = len(records)
            res = residual(torch, op, args, out)
            check(res < 1e-4, f"observed {op}: residual {res:.3e}")
            call = {"observe": observe, "wall_s": wall, "residual": res}
            if observe:
                rec = records[-1]
                total = sum(rec.phases.values())
                call.update(phases=rec.phases, phases_sum_s=total,
                            record={"op": rec.op, "variant": rec.variant,
                                    "n": rec.n, "p": rec.p, "c": rec.c,
                                    "machine": rec.machine,
                                    "fingerprint": rec.fingerprint})
                for phase in ("plan", "distribute", "execute"):
                    check(rec.phases.get(phase, 0.0) > 0.0,
                          f"observed {op}: phase {phase} missing or 0")
                check(abs(total - wall) <= 0.1 * wall,
                      f"observed {op}: phases {total:.4f} s against wall "
                      f"{wall:.4f} s")
            for name in PATH_KERNELS[op]:
                check(counts[name] > 0, f"observed {op}: {name} never "
                      "launched")
            for name, count in counts.items():
                totals[name] += count
            calls.append(call)
        emit({"measured_linalg": op, "n": N_MAIN, "dtype": "float32",
              "p": 1, "predicted_total_s": predicted, "calls": calls})
        del args, out
        torch.cuda.empty_cache()

    # 7.4 join the records against the seed and the measured profile; refit
    records = store.load()
    algos = sorted({r.op for r in records if r.kind == "dispatch"})
    joined = {}
    for name, reg in (("seed", build_default_registry()),
                      ("measured", registry)):
        rows = telemetry.join(records, reg)
        joined[name] = rows
        emit({"residuals": name, "rows": [
            {"op": r.op, "variant": r.variant, "n": r.n, "p": r.p,
             "phase": r.phase, "measured_s": r.measured,
             "predicted_s": r.predicted, "ratio": r.ratio} for r in rows],
            "report": telemetry.accuracy_report(rows)})
        got = sorted({r.op for r in rows})
        check(len(algos) == 3 and got == algos,
              f"join against the {name} profile: rows for {got}, records "
              f"of {algos}")
    refit = telemetry.refit(joined["measured"], registry)
    emit({"refit": {"machine": refit.machine.name,
                    "revision": refit.machine.revision,
                    "fingerprint": refit.fingerprint,
                    "speed_scale": refit.speed_scale,
                    "shape_scale": refit.shape_scale,
                    "comm_scale": refit.comm_scale,
                    "peak_flops": refit.machine.peak_flops_per_unit,
                    "rows": [refit.n_comp_rows, refit.n_comm_rows]}})
    check(refit.machine.revision == measured.revision + 1,
          "refit did not bump the measured profile's revision")
    emit({"measuring_half_s": time.perf_counter() - t_start})
    return totals, records, registry


# -- 8. the simulator: refined plans, fault diagnosis, the simulator join ----

# the degraded channel's beta multiplier, and the probe's size: the H100's
# NVLink latency (5 us) dwarfs a 4096-word transfer, so the probe sends
# 2^24 words (64 MiB of fp32), which the bandwidth governs
FAULT_SCALE = 8.0
PROBE_WORDS = float(2 ** 24)
STACKED_NOTE = ("ranks stacked on one card: measured/sim compares "
                "on-device copies with a simulated NVLink fabric (a check "
                "of the plumbing, not a measurement of NVLink)")


def simulated_call(torch, op, plan, args, devices, store):
    """One warm-up and one observed ``execute`` of ``plan``: the result,
    the synchronized wall time and the observed call's launch counts."""
    from repro_torch import kernels
    from repro_torch.tuner.dispatch import execute
    execute(plan, *args, devices=devices)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = execute(plan, *args, devices=devices, observe=True, store=store)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, kernels.launches()


def simulator(torch, measured_records, measured_registry):
    """Returns the kernel launch counts of §8's executed calls."""
    import tempfile
    from repro_torch import kernels, linalg, sim, telemetry
    from repro_torch.tuner import PlanCache, Tuner, build_default_registry
    t_start = time.perf_counter()
    totals = {name: 0 for name in kernels.launches()}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    store = telemetry.RunStore(tempfile.mkdtemp(prefix="smoke_sim_runs_"))
    plan_root = os.path.join(HERE, "build", "smoke_plans_sim")
    shutil.rmtree(plan_root, ignore_errors=True)

    def count(counts, what, op):
        for name in PATH_KERNELS[op]:
            check(counts[name] > 0, f"{what} {op}: {name} never launched")
        for name, n in counts.items():
            totals[name] += n

    # 8.1 sim-refined plans, executed
    seed_registry = build_default_registry()
    tuner = Tuner(registry=seed_registry,
                  cache=PlanCache(os.path.join(plan_root, "refined")))
    for p in (4, 8):
        devices = [torch.device("cuda", 0)] * p
        for op in ("matmul", "trsm", "cholesky"):
            args = operands(torch, op, N_MULTI, gen)
            closed = tuner.plan(op, N_MULTI, devices=devices,
                                dtype="float32")
            evals = tuner.stats.get("sim_evals", 0)
            refined = tuner.plan(op, N_MULTI, devices=devices,
                                 dtype="float32", refine="sim")
            check("sim_total" in refined.predicted,
                  f"refined {op} p={p}: no sim_total in the plan")
            check(tuner.stats.get("sim_evals", 0) > evals,
                  f"refined {op} p={p}: no candidate simulated")
            topo = sim.topology_for(
                seed_registry.machine(refined.machine).machine, p)
            check(isinstance(topo, sim.Crossbar),
                  f"refined {op} p={p}: simulated on {topo!r}")
            out, wall, counts = simulated_call(torch, op, refined, args,
                                               devices, store)
            want = library_result(torch, op, args)
            err = float((out - want).abs().max() / want.abs().max())
            emit({"sim_refined": op, "devices": f"cuda:0 x {p}",
                  "n": N_MULTI, "topology": repr(topo),
                  "closed_form_plan": plan_summary(closed),
                  "refined_plan": plan_summary(refined),
                  "same_plan": (closed.algo, closed.variant, closed.c,
                                closed.g) == (refined.algo, refined.variant,
                                              refined.c, refined.g),
                  "closed_form_total_s": closed.predicted["total"],
                  "sim_total_s": refined.predicted["sim_total"],
                  "simulated": {k: v for k, v in refined.predicted.items()
                                if k.startswith("sim/")},
                  "wall_s": wall, "rel_err": err, "launches": counts,
                  "note": STACKED_NOTE})
            check(err < 1e-4, f"refined {op} p={p}: rel err {err:.3e}")
            count(counts, f"refined p={p}", op)
            del args, out, want
    emit({"sim_refined_stats": dict(tuner.stats)})

    # 8.2 the diagnosis loop: a faulted network stands in for the channel
    registry = build_default_registry()
    profile = registry.machine("h100-sxm").machine
    topo = sim.topology_for(profile, 8)
    check(isinstance(topo, sim.Crossbar), f"h100-sxm at p=8: {topo!r}")
    link = topo.route(0, 1)[0]
    channel = sim.Network(topo, profile.latency, profile.inv_bandwidth,
                          faults=sim.FaultSpec(degraded_links=(
                              sim.DegradedLink(link, FAULT_SCALE),)))
    healthy_net = sim.Network(topo, profile.latency, profile.inv_bandwidth)
    distances = telemetry.default_probe_distances(topo, 8)
    located = telemetry.localize_link(
        topo, 8, distances=distances,
        measure=lambda d: telemetry.probe_shift_durations(
            channel, 8, d, words=PROBE_WORDS),
        baseline=lambda d: telemetry.probe_shift_durations(
            healthy_net, 8, d, words=PROBE_WORDS))
    diag = telemetry.probe_links(channel, words=PROBE_WORDS)
    emit({"diagnosis": diag.to_dict(), "localize_link": located.to_dict(),
          "injected": {"link": link, "name": topo.link_name(link),
                       "scale": FAULT_SCALE},
          "probe_distances": list(distances), "probe_words": PROBE_WORDS})
    for verdict in (diag, located):
        check(verdict.kind == "degraded_link" and verdict.component == link,
              f"diagnosis named {verdict.to_dict()}, not link {link}")
    devices = [torch.device("cuda", 0)] * 8
    tuner = Tuner(registry=registry,
                  cache=PlanCache(os.path.join(plan_root, "diagnosed")))
    healthy = {op: tuner.plan(op, N_MULTI, devices=devices, dtype="float32")
               for op in ("matmul", "trsm", "cholesky")}
    machine = telemetry.emit_degraded_profile(
        registry, "h100-sxm", diag.to_fault_spec(), diagnosis=diag)
    check(machine.revision == profile.revision + 1,
          f"degraded profile at revision {machine.revision}")
    for op in ("matmul", "trsm", "cholesky"):
        args = operands(torch, op, N_MULTI, gen)
        evals = tuner.stats.get("sim_evals", 0)
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = getattr(linalg, op)(*args, devices=devices, tuner=tuner)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launches()
        check(tuner.stats.get("sim_evals", 0) > evals,
              f"degraded {op}: the faulted surface planned without the "
              "simulator")
        degraded = tuner.plan(op, N_MULTI, devices=devices, dtype="float32")
        check("sim_total" in degraded.predicted
              and degraded.fingerprint != healthy[op].fingerprint,
              f"degraded {op}: plan not sim-refined on the new revision")
        res = residual(torch, op, args, out)
        emit({"diagnosed": op, "devices": "cuda:0 x 8", "n": N_MULTI,
              "healthy_plan": plan_summary(healthy[op]),
              "degraded_plan": plan_summary(degraded),
              "degraded_sim_total_s": degraded.predicted["sim_total"],
              "same_plan": (healthy[op].algo, healthy[op].variant,
                            healthy[op].c) == (degraded.algo,
                                               degraded.variant, degraded.c),
              "wall_s": wall, "residual": res, "launches": counts})
        check(res < 1e-4, f"degraded {op}: residual {res:.3e}")
        count(counts, "degraded", op)
        del args, out
    torch.cuda.empty_cache()

    # 8.3 the simulator join: §7's records against the profile that planned
    # them, §8.1's against the seed
    for name, records, reg in (
            ("measuring_half_p1", measured_records, measured_registry),
            ("sim_refined", store.load(), seed_registry)):
        rows = telemetry.join(records, reg, include_sim=True)
        ops = sorted({r.op for r in records if r.kind == "dispatch"})
        sim_ops = sorted({r.op for r in rows if r.source == "sim"})
        out = []
        for r in rows:
            if r.source != "sim":
                continue
            model = [m for m in rows if m.source == "model"
                     and m.timestamp == r.timestamp and m.phase == "execute"]
            out.append({"op": r.op, "variant": r.variant, "n": r.n,
                        "p": r.p, "c": r.c, "measured_s": r.measured,
                        "sim_s": r.predicted,
                        "measured_over_sim": r.ratio,
                        "measured_over_model":
                            model[0].ratio if model else None})
        emit({"sim_join": name, "rows": out,
              **({"note": STACKED_NOTE} if name == "sim_refined" else {})})
        check(len(ops) == 3 and sim_ops == ops,
              f"sim join {name}: sim rows for {sim_ops}, records of {ops}")
    emit({"simulator_s": time.perf_counter() - t_start})
    return totals


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
