#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

1. Prints the card's name and power limit (``nvidia-smi``) and builds the
   CUDA kernels from this checkout's sources (``build/torch_ext/``).
2. Holds each kernel (K1 matmul, K2 diagonal-block trsm, K3 block Cholesky,
   K4 flash attention, K5 the SSD scan) to its plain PyTorch version on the
   card at its path's shapes (K1 at the main path's three product classes,
   on its 4-byte copy path and on a stacked batch; K2 also on a strided B
   and at the Cholesky's last panel, K3 also at a ragged width; K4 and K5
   in the path's layouts, with the error taken per output row; K4 also at
   head dims 16 and 80, which its wrapper pads; K5 also at xlstm's 256 x 257
   state and at small ragged shapes), and times kernel, plain version and the nearest single PyTorch
   call with CUDA events; K1's launcher must refuse arguments it does not
   take, K3's a block wider than one CTA holds, K4's a head dim it has no
   body for, and K5's a dk above the widest a tile holds.
3. Drives the linalg path: ``repro_torch.linalg.matmul / trsm / cholesky``
   at n = 16384, fp32, on the default devices (one card, p = 1), with the
   kernels' launch counts set to 0 before each call and read after it, and
   the residuals checked against the library.
4. Runs multi-rank plans stacked on the one card (``[cuda:0] * 4`` and
   ``* 8`` at n = 4096) and all 16 variants forced through ``execute`` on
   2x2 and 2x2x2 grids at n = 2048.
5. Drives the LM prefill path (``repro_torch.launch.prefill``) at full
   width and depth for starcoder2-3b and hymba-1.5b, bf16, 4 prompts of
   4096 tokens, weights drawn from seed 0 on the card: a cold and a warm
   call each, the counts set to 0 before each and read after it, the peak
   memory, finite logits, K4 (starcoder2) and K5 (hymba) launched.
6. Holds that path to the plain versions: each model at full width and
   depth 2, fp32, one prompt of 2304 tokens (above the 2048 at which
   attention leaves ``_sdpa``), on the card and on the CPU with the same
   state dict: last-position logits within 1e-3 relative, equal argmax;
   and starcoder2-3b in bf16 on the card (K4's tensor-core body) against
   the CPU's fp32 run of the same bf16-valued weights, within 2e-2.

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

    kernels = kernel_checks(torch) + lm_kernel_checks(torch)
    main_counts = main_path(torch)
    multi_rank(torch)
    forced_variants(torch)
    prefill_counts = prefill_path(torch)
    prefill_against_cpu(torch)

    for entry in kernels:
        entry["launches"] = (main_counts[entry["wrapper"]]
                             + prefill_counts[entry["wrapper"]])
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
    each head dim) and at head dims 16 and 80 (zero-padded to 64 and 96 by
    the wrapper), and its launcher's refusal of a head dim it has no body
    for; K5 at hymba-1.5b's SSD shape, at xlstm-350m's 256 x 257 mLSTM
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
            (1, 8, 1, 384, 128, True, fp32, False, 20),
            (2, 4, 4, 300, 64, False, fp32, False, 20),
            (1, 6, 3, 256, 96, True, fp32, False, 20),
            (1, 4, 2, 256, 16, True, fp32, False, 20),
            (1, 4, 2, 256, 80, True, fp32, False, 20)):
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
    return out


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
    """K4's C launcher has bodies for head dims 64, 96 and 128 only: given
    80, the binding raises and nothing runs, in either type.  The binding
    is called directly, past the wrapper's own check."""
    from repro_torch.kernels import _build
    for dt, code in ((torch.bfloat16, 1), (torch.float32, 0)):
        q = torch.zeros(1, 1, 128, 80, device="cuda", dtype=dt)
        o = torch.full_like(q, float("nan"))
        strides = [st for t in (q, q, q, o) for st in t.stride()[:3]]
        before = wrapper.launches
        try:
            _build.extension().flash_attention(
                q.data_ptr(), q.data_ptr(), q.data_ptr(), o.data_ptr(), code,
                1, 1, 1, 128, 128, 80, strides, 80 ** -0.5, True,
                torch.cuda.current_stream().cuda_stream)
            refused = ""
        except RuntimeError as exc:
            refused = str(exc).splitlines()[0]
        torch.cuda.synchronize()
        untouched = bool(torch.isnan(o).all())
        counted = wrapper.launches - before
        emit({"k4_refuses_head_dim": 80, "dtype": str(dt)[6:],
              "message": refused, "output_untouched": untouched,
              "launches_counted": counted})
        check("head dim must be" in refused,
              f"K4's launcher took d = 80 in {dt}")
        check(untouched and counted == 0,
              f"K4 ran or counted a d = 80 launch in {dt}")


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

PREFILL_ARCHS = {"starcoder2-3b": "flash_attention_cuda",
                 "hymba-1.5b": "ssm_scan_cuda"}
PREFILL_BATCH = 4
PREFILL_LEN = 4096


def prefill_path(torch):
    """A cold and a warm prefill call per model; returns the cold calls'
    launch counts, summed over the models."""
    from repro_torch import kernels
    from repro_torch.configs import get
    from repro_torch.launch.prefill import make_prefill_step
    from repro_torch.models import build_model
    totals = {name: 0 for name in kernels.launches()}
    for arch, wrapper in PREFILL_ARCHS.items():
        cfg = get(arch)
        model = build_model(cfg)
        net = model.init(SEED)                    # the current GPU
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        tokens = torch.randint(0, cfg.vocab_size,
                               (PREFILL_BATCH, PREFILL_LEN), device="cuda",
                               generator=gen)
        step = make_prefill_step(model)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        calls = []
        for _ in ("cold", "warm"):
            kernels.reset_launches()
            t0 = time.perf_counter()
            logits = step(net, tokens)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            calls.append((wall, kernels.launches(), logits))
        (cold, cold_counts, logits), (warm, warm_counts, warm_logits) = calls
        tokens_n = PREFILL_BATCH * PREFILL_LEN
        finite = bool(torch.isfinite(logits).all())
        emit({"prefill": arch, "dtype": cfg.dtype, "batch": PREFILL_BATCH,
              "prompt_len": PREFILL_LEN, "layers": cfg.n_layers,
              "params": sum(p.numel() for p in net.parameters()),
              "cold_s": cold, "warm_s": warm,
              "cold_tokens_per_s": tokens_n / cold,
              "warm_tokens_per_s": tokens_n / warm,
              "max_memory_allocated": torch.cuda.max_memory_allocated(),
              "launches_cold": cold_counts, "launches_warm": warm_counts,
              "logits_shape": list(logits.shape), "logits_finite": finite,
              "argmax": logits[:, -1].argmax(-1).tolist()})
        check(tuple(logits.shape) == (PREFILL_BATCH, 1, cfg.vocab_size),
              f"prefill {arch}: logits shape {tuple(logits.shape)}")
        check(finite, f"prefill {arch}: non-finite logits")
        check(torch.equal(logits, warm_logits),
              f"prefill {arch}: the warm call's logits differ")
        for counts in (cold_counts, warm_counts):
            check(counts[wrapper] > 0, f"prefill {arch}: {wrapper} never "
                  "launched")
        for name, count in cold_counts.items():
            totals[name] += count
        del net, logits, warm_logits, calls
        torch.cuda.empty_cache()
    return totals


# -- 6. the prefill path against the plain versions ---------------------------

CHECK_LEN = 2304
# (arch, dtype on the card, tolerance of the last position's logits relative
# to their largest value).  fp32: only summation orders differ.  bf16 (K4's
# tensor-core body): the card rounds the activations to bf16 at every layer
# boundary (2^-8 each) and P before P V, the CPU computes in fp32 with the
# same bf16-valued weights; the CPU's own bf16 run of this path at depth 2
# and reduced widths stays within 1e-2 of its fp32 run
# (tests/test_torch_models.py::test_bf16_prefill_stays_near_fp32), so 2e-2
# leaves room for the card's other summation orders.
CPU_CHECKS = (("starcoder2-3b", "float32", 1e-3),
              ("hymba-1.5b", "float32", 1e-3),
              ("starcoder2-3b", "bfloat16", 2e-2))


def prefill_against_cpu(torch):
    import dataclasses
    from repro_torch import kernels
    from repro_torch.configs import get
    from repro_torch.launch.prefill import make_prefill_step
    from repro_torch.models import build_model
    from repro_torch.models.transformer import Decoder
    for arch, dtype, tol in CPU_CHECKS:
        wrapper = PREFILL_ARCHS[arch]
        cfg = dataclasses.replace(get(arch), n_layers=2, dtype=dtype)
        model = build_model(cfg)
        net = model.init(SEED, device="cuda")
        net_cpu = Decoder(dataclasses.replace(cfg, dtype="float32"),
                          device="cpu")
        net_cpu.load_state_dict({k: v.float().cpu()
                                 for k, v in net.state_dict().items()})
        gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
        tokens = torch.randint(0, cfg.vocab_size, (1, CHECK_LEN),
                               device="cuda", generator=gen)
        step = make_prefill_step(model)
        kernels.reset_launches()
        got = step(net, tokens)
        torch.cuda.synchronize()
        counts = kernels.launches()
        t0 = time.perf_counter()
        want = step(net_cpu, tokens.cpu())
        cpu_s = time.perf_counter() - t0
        got = got.cpu().float()
        abs_err = float((got - want).abs().max())
        rel_err = abs_err / float(want.abs().max())
        argmax = [int(got.argmax(-1).flatten()[0]),
                  int(want.argmax(-1).flatten()[0])]
        emit({"prefill_vs_cpu": arch, "layers": 2, "dtype": dtype,
              "cpu_dtype": "float32", "prompt_len": CHECK_LEN,
              "max_abs_err": abs_err, "max_rel_err": rel_err, "tol": tol,
              "argmax_card_cpu": argmax, "launches": counts, "cpu_s": cpu_s})
        check(counts[wrapper] == 2, f"prefill vs cpu {arch} {dtype}: "
              f"{wrapper} launched {counts[wrapper]} times, not once a "
              "layer")
        check(rel_err < tol, f"prefill vs cpu {arch} {dtype}: rel err "
              f"{rel_err:.3e}")
        if dtype == "float32":
            check(argmax[0] == argmax[1],
                  f"prefill vs cpu {arch}: argmax differs")
        del net, net_cpu
        torch.cuda.empty_cache()


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
