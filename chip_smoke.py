#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

1. Prints the card's name and power limit (``nvidia-smi``) and builds the
   CUDA kernels from this checkout's sources (``build/torch_ext/``).
2. Holds each kernel (K1 matmul, K2 diagonal-block trsm, K3 block Cholesky,
   K4 flash attention, K5 the SSD scan, K6 the sLSTM recurrence) to its
   plain PyTorch version on the card at its path's shapes (K1 at the main
   path's three product classes, on its 4-byte copy path, on a stacked
   batch and on a batch of one, §11's rank blocks, and in bf16 on its
   tensor-core body, out in fp32 and in bf16, on TMA's ragged edges, a
   stacked and a shared-B batch, and on operands TMA cannot load as they
   lie (rows not 16-byte aligned: 700 and 130 columns, a view at a column
   offset of 1), which the wrapper stages, each row naming the body that
   ran; K2 also on a strided B
   (§11's rank blocks among them) and at the Cholesky's last panel, K3 also
   at a ragged width; K4, K5 and K6 in the path's layouts, with the error
   taken per output row; K4 also at head dims 16, 80 and 160, which its
   wrapper pads, at 256, and at 320 (padded to 384) and 512 on its wide
   bodies, also at a ragged S of 300, causal and not, with B 2, and at a
   prefill's B 1, H 16, KV 4, S 4096, causal, at 320, 512 and 640; K5
   also at xlstm's 256 x 257 state and at small ragged shapes; K6 at
   xlstm's prefill and train shapes, with open forget gates (f + 6, so
   that its chunk carries show), at a ragged shape and at S below its
   chunk, its per-step states, and its backward (a
   reverse scan over chunks) at the train shape, with f + 6, at the ragged
   shape and at S below its chunk against the plain reverse loop), and
   times kernel, plain version and the nearest single PyTorch call with
   CUDA events; K1's launcher must refuse arguments it does not take, K3's a
   block wider than one CTA holds, K4's a head dim above the widest its
   wide bodies take, 768 on an H100 (its wrapper stating the limit), K5's
   a dk above the widest a tile holds, and K6's and its backward's binding
   inputs that are not fp32, not contiguous or (the backward) of unlike
   shapes.  Each of K1's compiled CTA tiles reports 0 spill bytes, is
   timed at 4096^3 beside its plain version and ``torch.matmul`` (an
   entry each), and is held within 2.1e-6 of the plain version and bit
   for bit to the default tile at 4096^3, 300 x 700 x 260, 130^3, an A at
   column offset 1 and 8 x 2048^3; the heuristic plan equals no plan bit
   for bit, both on the default tile; the launcher refuses a tile it does
   not compile.
3. Drives the linalg path: ``repro_torch.linalg.matmul / trsm / cholesky``
   at n = 16384, fp32, on the default devices (one card, p = 1), with the
   kernels' launch counts set to 0 before each call and read after it, and
   the residuals checked against the library; every K1 launch on the
   default CTA tile (``h100-sxm`` plans the heuristic tiles).  Then
   ``linalg.matmul`` on bf16 operands at n = 4096: every K1 launch on its
   tensor-core body, the result bf16 and within 2e-2 of ``matmul_ref``.
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
6. Holds that path to the plain versions: starcoder2-3b, hymba-1.5b and
   qwen2-moe-a2.7b at full width and depth 1, xlstm-350m and
   llama-3.2-vision-11b (a cross layer every 2 layers for this check) at
   depth 2, whisper-tiny at full depth, fp32, one prompt of 2304 tokens (above the 2048 at which
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

9. Serves on the card (``repro_torch.serving``): starcoder2-3b at full
   width and depth 4 (cut from 30 for the script's time), bf16, six
   requests (prompts of 128 to 3900 tokens, 32 new tokens each, a KV ring
   of 4096) submitted between scheduler steps
   so that they join and leave a running batch, under the FIFO and the
   model-guided policy (the cost model built for ``h100-sxm``), a cold and
   a warm run each: TTFT and TPOT per request, decode tokens/s, steps,
   wall time and peak memory; every request ends with 32 tokens, every KV
   block returns to the pool, no operation runs on the CPU (the cold FIFO
   run under a dispatch mode that counts them); each request's
   tokens against its own single-request ``Engine.generate`` (reported,
   with the single run's top-2 margin where they differ).  Then every
   block kind's one-step decode at full width, fp32 (starcoder2-3b,
   qwen2-moe-a2.7b, xlstm-350m, hymba-1.5b, llama-3.2-vision-11b at depth
   2, whisper-tiny at full depth) against the CPU with one state dict,
   over a 32-token prompt and 16 greedy tokens (< 1e-3 relative, equal
   argmax at every step), the chunked decode against the per-token one,
   hymba's KV ring across its 1024-token window against the card's
   full-sequence forward; and three staggered fp32 requests (starcoder2-3b
   at depth 2) through the scheduler's batch against each alone, token
   for token.
10. Trains on the card (``repro_torch.training``; ``Model.loss`` through
   the differentiable K4, K5 and K6 sites: K4's and K5's backward
   recompute through the twins the reference differentiates, K6's is its
   backward kernel).  10.1: the loss and
   every parameter's gradient at full width, fp32, depth 2 (starcoder2-3b
   and hymba-1.5b depth 1, whisper-tiny full depth, the VLM with a cross
   layer every 2 layers) on the card
   against the CPU with one state dict and one numpy batch, for
   starcoder2-3b (K4 at S = 2304), hymba-1.5b (K5 and its windowed loop),
   xlstm-350m (K5 at 256 x 257 and K6), qwen2-moe-a2.7b (the aux loss,
   its routing compared: gated only where it agrees; 256 tokens),
   whisper-tiny and llama-3.2-vision-11b (256 tokens): loss < 1e-4
   relative, each gradient < 1e-3 of
   its largest entry; starcoder2-3b also with remat against without on
   the card.  10.2: starcoder2-3b bf16 at full width and depth, one
   prompt of 4096 tokens, remat, AdamW with fp32 moments, four steps
   through ``Trainer`` and its synthetic pipeline (synchronized wall,
   tokens/s, loss, grad norm, lr, peak memory, K4 launches each step;
   the parameters move), one more step under the CPU-op guard (0
   operations), then xlstm-350m bf16 at full depth, 1024 tokens, two
   steps (K5, K6 and K6's backward launched, K6's plain versions run on
   no CUDA tensor; the sites' backward time).  10.3: the loss
   falls over five steps on one fixed batch (starcoder2-3b at depth 2,
   fp32).  10.4: ``Trainer.run`` checkpoints at step 2, a new Trainer
   restores it, and its step 3 matches the first's within 1e-5.
11. Runs the group backend on the card: ranks as processes of a gloo
   group (``repro_torch.distributed.spawn``), every rank on cuda:0, blocks
   staged through pinned host memory, IEEE fp32 in every rank; the ranks
   load §1's build (its ``.so`` must not change).  11.1: the 16 variants
   forced through ``execute`` on 4 (2D, 2x2) and 8 (2.5D, 2x2x2) ranks at
   n = 2048 on §4's operands: within 1e-4 of the library, within 1e-6 of
   §4's stacked run (Cannon 2D and 2D_ovlp bitwise), K1 (and K2 / K3
   where §4 needs them) launched in every rank.  11.2: on the 4 ranks,
   ``linalg.matmul / trsm / cholesky`` at n = 8192, cold and warm (the
   warm call observed: the slowest rank's phases and communication),
   residual < 1e-4, the plan's predicted total beside the wall, the same
   plan stacked on ``[cuda:0] * 4`` beside it; Cannon 2D against 2D_ovlp
   forced at the same n, in turns (2D, 2D_ovlp, 2D_ovlp, 2D).  11.3: the
   ranks of each world run the port's Fig. 2 and Figs. 3-4 benchmarks (``benchmarks.fig2_alpha_beta``
   and ``fig34_calibration``'s ``measure``): the ping between two ranks
   (the reference's sizes, 8-byte words) on cuda:0 and on the host, and
   its fit, on the 4 ranks; the contention factors (wall over L + beta
   words) at distances 1, 2 and P/2 on 4 and 8 ranks.
   11.4: with a card for each of 4 ranks, 11.1's Cannon and SUMMA 2D rows
   over NCCL (cuda:r a rank); else one line saying it was not run.  A
   rank that fails fails the run; the kernels line adds every rank's
   launches of 11.1 and 11.2.
12. Runs the benchmark harness (``repro_torch.benchmarks.run``) on the
   card at its ``CARD_SIZES``: ``fig5to8`` (Figs. 5-8: the 8 2D variants
   on 4 gloo ranks on cuda:0 at n = 8192 through K1-K3, measured against
   est_Cal and est_NoCal from the parameters the ranks measure),
   ``tuner`` (8 ranks stacked on cuda:0, n = 4096), ``serving`` (Phase A
   on qwen1.5-4b bf16 at full width and depth; Phases B and C on the
   host), ``obs`` and ``kernels`` (K1's tile sweep at n = 4096: one
   matmul plan a CTA tile, timed, refitted into ``H100_KERNEL_SEED``'s
   constants, the model's shortlist and choice), writing their JSONs
   under ``artifacts/bench_torch/``;
   then ``--check-regressions`` once, on an empty history in a temporary
   directory (warn-only, exit 0).  Gated: every bench returns and its
   ``_meta`` names the card and its power limit as ``nvidia-smi`` does;
   fig5to8's residuals < 1e-4 and each variant's kernels launched in every
   rank; at least 200 model-evaluation scenarios (the tuner bench itself
   raises if its disk hit evaluates a model); serving's records, Phase
   B's gates and the re-key; obs's flow events; kernels against the
   reference CI's gates (``tuned_over_default`` >= 1, a new revision that
   moved a constant), at least four CTA tiles timed, each launched.  Reported: fig5to8's
   table, the tuner's overheads, serving's post-refit error, obs's
   overhead.  The kernels line adds §12's launches, every fig5to8 rank's
   included, its routine benchmark's as well as its variants'.
13. Trains sharded (``repro_torch.distributed.sharding``,
   ``launch/mesh.py``): ranks as processes of a gloo group, every rank on
   cuda:0, staged through pinned host memory, a mesh (pods, data, model)
   laid over them.  The unsharded runs go first, in this process; then
   one world of 4 ranks runs 13.1 to 13.3, each on a mesh of its own.
   13.1: starcoder2-3b at full width, fp32, depth 2, S 2304, global
   batch 2, two AdamW steps from one seed on one numpy batch, on
   (1, 2, 2) (tensor-parallel attention and MLP, KV 2 -> 1 a rank) and
   on (1, 1, 4) (the 2 KV heads' leaves gathered), against the unsharded
   ``Trainer`` on the card: loss < 1e-5 relative, every rank's block of
   every parameter < 1e-4 of the whole parameter's largest entry.
   13.2: starcoder2-3b bf16 at full width on (1, 2, 2), S 2304, global
   batch 2, remat, AdamW (ZeRO-1 moments), at the most layers (up to 2)
   four ranks' estimated bytes fit on the card (``rank_bytes``): a cold and a
   warm step, the slowest rank's wall, each rank's peak memory (below the
   unsharded run's), the staged bytes and host seconds in the group
   collectives a step.  In 13.1 and 13.2 K4 is launched in every rank
   and its plain version runs on no CUDA tensor.  13.3:
   ``compress_pod_mean`` over (2, 1, 2) against the CPU on the same
   inputs (the quantizer bitwise on every pod's input, the mean over the
   gathered payloads and the new error within 1e-6).  13.4:
   ``launch/train.py --smoke --mesh 1,2,2 --steps 3`` as a subprocess,
   started with §13's unsharded runs and awaited before the world (its
   four small ranks beside them, never beside the world).
   13.5, the expert-parallel layout: qwen2-moe-a2.7b in fp32 at full
   width, depth 1, S 2304, global batch 2, on (1, 1, 4) (60 experts
   divide 4: every bank "ep"), two AdamW steps against
   the unsharded run on the card with 13.1's bars, K4 in every rank, and
   no all-gather over ``model`` of a bank's block; arctic-480b's forward
   in bf16 at full width, depth 1, one row of 2304 tokens on (1, 1, 4),
   its weights drawn on each rank's blocks only (built on ``meta``): each
   rank's peak under 13.39 GB (half of one layer's whole banks), finite
   logits, K4 in every rank.  13.6, the sharded decode: starcoder2-3b,
   xlstm-350m and qwen2-moe-a2.7b in fp32 at full width, depth 2, on
   (1, 1, 4), 2 rows, a 16-token chunk (token by token for xlstm) then 16
   one-token steps: every step's logits within 1e-5 of the largest of
   the unsharded decode on the card, the same argmax, and each rank's
   bytes of the cache leaves the specs cut a quarter of the whole's.
   13.7, the reference's other sharding profiles (the mesh under
   ``rules_for(arch, profile)``), fp32 at full width, depth 2, each
   against its unsharded run on the card: starcoder2-3b under ``dp_sp``
   on (1, 2, 2), S 2304, global batch 4 (one row a rank, no tensor
   parallelism, ZeRO-1 over data and model); starcoder2-3b under
   ``seq_sp`` on (1, 1, 4) with 13.1's batch (576 positions a rank
   between blocks, 13.1's unsharded run); xlstm-350m under ``seq_sp`` on
   (1, 1, 4), S 1024, global batch 2: loss < 1e-5 relative, every rank's
   block of every parameter after two AdamW steps < 1e-4 of its largest
   entry, and of every first-step gradient < 1e-5 of its largest entry
   (a key bias's, zero in exact arithmetic, of its weight's); K4 (for
   xlstm K5, K6 and K6's backward) in every rank, no plain version on a
   CUDA tensor; each rank's peak memory and the collective bytes by kind
   reported.  13.8, the head-parallel blocks under the baseline rules,
   with 13.7's gates and reports: xlstm-350m at depth 2 on (1, 1, 4)
   with 13.7's xlstm batch and unsharded run (the mLSTM on 1 of its 4
   heads a rank, the sLSTM on 256 of its 1024 features; K5, K6 and K6's
   backward in every rank), and whisper-tiny at full depth on (1, 2, 2),
   S 2304, global batch 2 (3 of its 6 heads a rank in the encoder's and
   the decoder's self-attention and the cross-attention; K4 in every
   rank), each against its unsharded run on the card; every attention,
   SSM and xLSTM block tensor-parallel and no all-gather over ``model``
   of a ``"tp"`` leaf, in every rank.  The kernels line adds every
   rank's launches of 13.1, 13.2, 13.5, 13.7 and 13.8.
14. The dry run (``repro_torch.launch.dryrun``, ``launch/specs.py``,
   ``core/roofline.py``): rank 0 of the (16, 16) ``data, model`` mesh,
   its collectives counted and not sent (``counting_mesh``).  14.1: the
   meta-device count of starcoder2-3b@train_4k (16 rows of 4096 tokens)
   and @prefill_32k (2 rows of 32768): the three terms on the H100's
   spec-sheet constants, the dominant one, the predicted peak a rank,
   whether it fits.  14.2: the same rank's steps on the card, the prefill
   at full depth (K4 at S 32768), the train step at full width and the
   most layers whose predicted peak stays under 60 GB (at least 2; the
   meta count repeated at that depth): the card's count of FLOPs by type,
   bytes and collective calls and bytes by kind equal to the meta count
   within 1e-9 relative, the measured peak within 30 % of the predicted
   one, K4 launched in both and its plain version on no CUDA tensor;
   reported, the cold (counted) and warm wall against the bound of the
   compute and memory terms.  14.3: the decode cells starcoder2-3b@
   decode_32k (8 rows, 2048 of the 32768 slots a rank) and
   xlstm-350m@long_500k (one row), rank 0 of the same mesh, on meta and
   then on the card at full depth, with 14.2's gates on the counts and
   the peak (no kernel: decode reaches none).  14.4: the train cell under
   the ``dp_sp`` and ``seq_sp`` profiles (``--profile``), on meta and then
   on the card at the depth 14.2's rule gives, with 14.2's gates.  The
   kernels line adds §14's launches.
15. The reference's four examples on the port (``repro_torch.examples``)
   with ``--device cuda``, in one subprocess (its process-wide tuner and
   run store built under the section's locations), the port's artifacts
   root on a temporary directory seeded with the Hopper joint fit's
   starting point (the two-minute fit is not run): the quickstart with
   ``REPRO_TELEMETRY=1`` (its measured loop: 2 x 8 records, each the best
   of 5 dispatched matmuls at n 768 and 1024, p = 1, through K1), the
   linalg demo (n 64: blocks below the kernels' thresholds), the served
   batch (xlstm-350m reduced) and ``train_e2e --smoke --steps 20 --batch 4
   --seq 128`` (checkpointing to its default directory, under the
   temporary root).  Gated: each example finishes, the quickstart's report has
   at least 16 rows and its loop launched K1, the training losses are
   finite, nothing is written under the checkout's ``artifacts/``.
   Reported: each example's wall and output, the quickstart's mean
   relative error before and after its refit (the reference CI's 0.35 is
   its CPU's bar), the first and last training loss.  The kernels line
   adds §15's launches.

The line before the last is ``{"kernels": [...]}``, after each section's
wall time (``{"sections_s": ...}``) and the script's (``{"script_s":
...}``); the last line is
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero, as do
a machine without a CUDA device and a directory without the checkout.

Usage, from the root of a checkout on a machine with a CUDA GPU:

    python3 chip_smoke.py
"""

from __future__ import annotations

import contextlib
import gc
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


#: K1's launches by CTA tile in the runs that read them (§3, §12's kernels
#: bench): the kernels line gives each tile's entry its count
TILE_LAUNCHES = {}
#: K1's launches by body in §3's bf16 call: the kernels line gives each
#: bf16 entry its body's count
BODY_LAUNCHES = {}
#: K4's launches by body (flash_attention_cuda.launches_by_body, the body
#: the launcher reported) in §5's cold prefills, §6's checks and §13's
#: ranks: the kernels line gives them under keys that name that scope, as
#: its ``launches`` counts other runs
K4_BODY_LAUNCHES = {}
#: the fp32 tile K4's launcher must report at the paths' fp32 shapes in §2,
#: (B, H, KV, S, D): the fastest of the kept tiles at each (PERF.md's
#: kernel table; ``chip_profile.py --k4-f32-designs``)
K4_F32_PATH_TILES = {(4, 24, 2, 4096, 128): "fp32_128x8x1",
                     (1, 24, 2, 2304, 128): "fp32_128x8x1",
                     (1, 6, 6, 2304, 64): "fp32_64x4x4",
                     (1, 16, 4, 4096, 256): "fp32_64x8x1"}


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def on_body(name, family: str) -> bool:
    """Whether K4's launcher reported a body of ``family``: ``fp32`` (any
    of its tiles, ``fp32_<rows>x<rows a thread>x<chunks>``) or one bf16
    body by its name."""
    if name is None:
        return False
    return name.startswith("fp32_") if family == "fp32" else name == family


def k4_bodies_are(bodies: dict, k4: int, family: str) -> bool:
    """Whether ``bodies`` (launches by body) holds ``k4`` launches, all on
    bodies of ``family`` (:func:`on_body`)."""
    return sum(bodies.values()) == k4 and all(
        on_body(n, family) for n, c in bodies.items() if c)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def main() -> int:
    t_start = time.perf_counter()
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

    # each section's wall, printed before the script's
    walls = {}

    def section(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(torch, *args)
        walls[name] = time.perf_counter() - t0
        return out

    kernels = section("2", lambda t: kernel_checks(t) + lm_kernel_checks(t))
    main_counts = section("3", main_path)
    section("4", lambda t: multi_rank(t))
    stacked_variants = section("4 variants", forced_variants)
    prefill_counts = section("5", prefill_path)
    section("6", prefill_against_cpu)
    measuring_counts, measured_records, measured_registry = \
        section("7", measuring_half)
    simulator_counts = section("8", simulator, measured_records,
                               measured_registry)
    serving_counts = section("9", serving)
    training_counts = section("10", training)
    group_counts = section("11", process_groups, stacked_variants)
    harness_counts = section("12", harness,
                             smi.stdout.strip().splitlines()[0])
    sharded_counts = section("13", sharded_training)
    dryrun_counts = section("14", dry_run)
    example_counts = section("15", examples)

    for entry in kernels:
        entry["launches"] = (main_counts[entry["wrapper"]]
                             + prefill_counts[entry["wrapper"]]
                             + measuring_counts[entry["wrapper"]]
                             + simulator_counts[entry["wrapper"]]
                             + serving_counts[entry["wrapper"]]
                             + training_counts[entry["wrapper"]]
                             + group_counts[entry["wrapper"]]
                             + harness_counts[entry["wrapper"]]
                             + sharded_counts[entry["wrapper"]]
                             + dryrun_counts[entry["wrapper"]]
                             + example_counts[entry["wrapper"]])
        if "cta_tile" in entry:
            entry["launches_at_tile"] = TILE_LAUNCHES.get(
                tuple(entry["cta_tile"]), 0)
        if entry["wrapper"] == "flash_attention_cuda":
            entry["launches_by_body_s5_s6_s13"] = dict(K4_BODY_LAUNCHES)
            entry["launches_of_body_s5_s6_s13"] = K4_BODY_LAUNCHES.get(
                entry["body"], 0)
        elif entry.get("body", "").startswith("bf16"):
            entry["launches_of_body"] = BODY_LAUNCHES.get(entry["body"], 0)
    emit({"sections_s": walls})
    emit({"script_s": time.perf_counter() - t_start})
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
                 layout="contiguous", extra=None):
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
    e.update(extra or {})
    emit({"kernel_check": e})
    return e


#: K1's source by the body a launch ran (kernels/matmul/ops.py, BODIES)
K1_SOURCES = {"fp32": "src/repro_torch/kernels/csrc/matmul_f32.cuh",
              "bf16_wgmma": "src/repro_torch/kernels/csrc/matmul_bf16.cu"}
#: K1 with bf16 output against matmul_ref's: each side rounds its fp32 sums
#: to bf16 once, and sums that differ in order by an fp32 rounding can
#: round to neighbouring bf16 values, one ulp (2^-8 of the element)
K1_BF16_OUT_TOL = 2e-2


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
    # blocks of the [cuda:0] * 8 plans at n = 4096.  A batch of one: a
    # rank's (1, 1, 1, rb, rb) block in §11's group runs (rb = 1024 in
    # 11.1, 8192 in 11.2's 2 x 2 plans).  bf16 operands (what linalg's
    # matmul hands K1 on bf16 inputs) run the tensor-core body, out in
    # fp32 (within 1e-5) and in bf16 (K1_BF16_OUT_TOL), also on TMA's ragged
    # edges, a stacked batch and a B shared by the batch; operands whose
    # rows are not 16-byte aligned (700, 260 and 130 columns, a view at a
    # column offset of 1) are staged by the wrapper and run the same body.
    # Each row names the body that ran.
    f32, bf16 = torch.float32, torch.bfloat16

    def rnd(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    def k1_cases():
        yield "", (rnd(4096, 4096), rnd(4096, 4096)), f32, 10
        a16, b16 = rnd(4096, 4096).to(bf16), rnd(4096, 4096).to(bf16)
        yield "", (a16, b16), f32, 10
        yield "", (a16, b16), bf16, 10
        del a16, b16
        # the bf16 body's ragged M, N and K (TMA's zero fill), a stacked
        # batch, B shared by the batch (stride 0), and rows TMA cannot
        # load as they lie (700, 260 and 130 columns; a column offset of
        # 1), staged by the wrapper
        yield "ragged M, N, K", (rnd(1000, 328).to(bf16),
                                 rnd(328, 520).to(bf16)), f32, 20
        yield "stacked batch of 8", (rnd(8, 2048, 2048).to(bf16),
                                     rnd(8, 2048, 2048).to(bf16)), bf16, 10
        yield "B shared by a batch of 4", (rnd(4, 1024, 1024).to(bf16),
                                           rnd(1024, 1024).to(bf16)), \
            bf16, 10
        yield "rows not 16-byte aligned", (rnd(300, 700).to(bf16),
                                           rnd(700, 260).to(bf16)), f32, 20
        yield "130 columns, staged", (rnd(130, 130).to(bf16),
                                      rnd(130, 130).to(bf16)), bf16, 50
        yield "A at column offset 1, staged", (
            rnd(2048, 2049).to(bf16)[:, 1:], rnd(2048, 2048).to(bf16)), \
            bf16, 10
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
        for rb, reps in ((N_VARIANTS // 2, 10), (N_MAIN // 2, 3)):
            yield "a group rank's block", (rnd(1, 1, 1, rb, rb),
                                           rnd(1, 1, 1, rb, rb)), f32, reps

    for layout, (a, b), odt, reps in k1_cases():
        dt = a.dtype
        *batch, m, k = a.shape
        n = b.shape[-1]
        nb = math.prod(batch)
        before = dict(matmul_cuda.launches_by_body)
        got = matmul_cuda(a, b, out_dtype=odt)
        body = [name for name, c in matmul_cuda.launches_by_body.items()
                if c != before.get(name, 0)]
        check(len(body) == 1, f"K1 {layout}: bodies launched {body}")
        body = body[0]
        want_body = "fp32" if dt == f32 else "bf16_wgmma"
        check(body == want_body, f"K1 {dt} {layout}: the {body} body ran, "
              f"not {want_body}")
        want = matmul_ref(a, b, out_dtype=odt)
        if dt == odt:
            lib = lambda a=a, b=b: torch.matmul(a, b)  # noqa: E731
        elif mm_takes_out_dtype(torch):
            lib = lambda a=a, b=b: torch.mm(a, b, out_dtype=odt)  # noqa: E731
        else:
            lib = None
        isz = a.element_size()
        osz = torch.empty((), dtype=odt).element_size()
        # a B shared by the batch moves once
        b_bytes = k * n * isz * (nb if b.dim() > 2 else 1)
        entry(f"K1 matmul {'%dx' % nb if batch else ''}{m}x{k}x{n} "
              f"{str(dt)[6:]}->{str(odt)[6:]}"
              + (f" ({layout})" if layout else ""),
              "matmul_cuda", K1_SOURCES[body],
              "src/repro/kernels/matmul/matmul.py:51",
              [nb, m, k, n] if batch else [m, k, n], got, want,
              K1_BF16_OUT_TOL if odt == bf16 else 1e-5,
              lambda a=a, b=b: matmul_cuda(a, b, out_dtype=odt),
              lambda a=a, b=b: matmul_ref(a, b, out_dtype=odt), lib, reps,
              2.0 * nb * m * k * n, PEAK_BF16 if dt == bf16 else PEAK_FP32,
              nb * (m * k * isz + m * n * osz) + b_bytes,
              layout=layout or "contiguous", extra={"body": body})
        del a, b, got, want
        torch.cuda.empty_cache()
    k1_refuses_type(torch, matmul_cuda)
    k1_tile_checks(torch, entry, rnd)

    # K2 and K3 at the main path's block (256: the Cholesky panel's first
    # shape and the diagonal block) and at the wider blocks a profile with
    # kernel constants may plan (perf/kernel.py candidate_tiles): above 336
    # K3 is a composition of K3, K2 and K1 launches.  Besides: K3 at a
    # ragged 200 (the last panel 8 wide), K2 at the Cholesky's last panel
    # (B 256 x 256: 4 strips of 64 rows) and K2 on a column slice of a
    # 16384-wide B (row stride 16384), as the trsm path hands it over, and
    # of a group rank's block (1024 rows, stride 1024 in §11.1; 8192 and
    # 8192 in 11.2's 2 x 2 plans); and
    # each at 130, whose rows are not 16-byte aligned, so the kernels take
    # their 4-byte copies.  The bytes count what each function needs: U's
    # upper and A's lower triangle.
    for nb, m, ldb, reps in ((256, N_MAIN - 256, None, 20),
                             (512, N_MAIN - 512, None, 5),
                             (1024, N_MAIN - 1024, None, 2),
                             (256, 256, None, 20),
                             (256, N_MAIN, N_MAIN, 20),
                             (256, N_VARIANTS // 2, N_VARIANTS // 2, 20),
                             (256, N_MAIN // 2, N_MAIN // 2, 20),
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
    256 by the wrapper), at 256, at 320 (padded to 384) and 512 (the wide
    bodies; also at the ragged S 300, non-causal with B 2 and causal), at a
    prefill's B 1, H 16, KV 4, S 4096, causal, at 320, 512 and 640, in fp32
    at the paths' shapes (starcoder2-3b's prefill B 4, H 24, KV 2, S 4096,
    D 128; the fp32 checks' S 2304; whisper-tiny's B 1, H 6, S 2304, D 64;
    B 1, H 16, KV 4, S 4096, D 256; the plain version once at S 4096), each
    entry naming the body the launcher reported (at the paths' fp32 shapes
    gated to the tile :data:`K4_F32_PATH_TILES` names), and its launcher's
    and wrapper's refusal of a head dim above the widest the wide bodies
    take; K5 at hymba-1.5b's SSD shape, at xlstm-350m's 256 x 257 mLSTM
    state (v with the normaliser's ones column), at the widest state the
    reference tests and at small ragged shapes, and its launcher's refusal
    of dk = 257; K6 and its backward (:func:`k6_checks`).  The path's
    shapes take the path's layouts: the heads as transposed views of the
    projections.  The error is taken per output row, relative to the row's
    largest value.  Both kernels' bf16 outputs are held to the plain
    version run in fp32 on the widened inputs, with no rounding on the
    plain side, within 8e-3: one bf16 rounding of the output is at most
    2^-8 (3.9e-3); K4's rounding of P to bf16 before P V adds about 1e-3.
    fp32 within the summation order."""
    import torch.nn.functional as F
    from repro_torch.kernels import _build, flash_attention_cuda, ssm_scan_cuda
    from repro_torch.kernels.flash_attention.ops import _ref4 as flash_ref
    from repro_torch.kernels.flash_attention.ops import padded_head_dim
    from repro_torch.kernels.ssm_scan.ops import _ref4 as scan_ref
    from repro_torch.kernels.ssm_scan.ops import ssm_scan_workspace
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    out = []

    def entry(*args, per_row=True, **kw):
        out.append(kernel_entry(torch, *args, per_row=per_row, **kw))

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
            (1, 4, 2, 256, 320, True, bf16, False, 10),
            (2, 4, 2, 300, 320, False, bf16, False, 10),
            (2, 4, 2, 300, 512, False, bf16, False, 10),
            (1, 4, 2, 300, 320, True, bf16, False, 10),
            (1, 4, 2, 256, 512, True, bf16, False, 10),
            (1, 16, 4, 4096, 320, True, bf16, False, 5),
            (1, 16, 4, 4096, 512, True, bf16, False, 5),
            (1, 16, 4, 4096, 640, True, bf16, False, 5),
            (1, 8, 1, 384, 128, True, fp32, False, 20),
            (2, 4, 4, 300, 64, False, fp32, False, 20),
            (1, 6, 3, 256, 96, True, fp32, False, 20),
            (1, 4, 2, 256, 16, True, fp32, False, 20),
            (1, 4, 2, 256, 80, True, fp32, False, 20),
            (1, 4, 2, 256, 160, True, fp32, False, 20),
            (1, 4, 2, 256, 256, True, fp32, False, 20),
            (1, 4, 2, 256, 320, True, fp32, False, 10),
            (2, 4, 2, 300, 320, False, fp32, False, 10),
            (2, 4, 2, 300, 512, False, fp32, False, 10),
            (1, 4, 2, 300, 320, True, fp32, False, 10),
            (1, 4, 2, 256, 512, True, fp32, False, 10),
            (1, 16, 4, 4096, 320, True, fp32, False, 5),
            (1, 16, 4, 4096, 512, True, fp32, False, 5),
            (1, 16, 4, 4096, 640, True, fp32, False, 5),
            (4, 24, 2, 4096, 128, True, fp32, True, 5),
            (1, 24, 2, 2304, 128, True, fp32, True, 10),
            (1, 6, 6, 2304, 64, True, fp32, True, 10),
            (1, 16, 4, 4096, 256, True, fp32, True, 5)):
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
        before = dict(flash_attention_cuda.launches_by_body)
        got = flash_attention_cuda(q, k, v, causal=causal)
        ran = [n for n, c in flash_attention_cuda.launches_by_body.items()
               if c != before.get(n, 0)]
        body = ran[0] if len(ran) == 1 else None
        if dt == fp32:
            want = K4_F32_PATH_TILES.get((b, h, kv, s, d) if path else None)
            ok = body == want if want else on_body(body, "fp32")
        else:
            want = "bf16_wgmma" + ("_wide" if padded_head_dim(d) > 256
                                   else "")
            ok = body == want
        check(ok, f"K4 {dt} B{b} H{h} S{s} d {d}: bodies {ran} ran"
              + (f", not {want}" if want else ""))
        entry(f"K4 flash_attention B{b} H{h} KV{kv} S{s} D{d} "
              f"{'causal' if causal else 'full'} {str(dt)[6:]}",
              "flash_attention_cuda",
              "src/repro_torch/kernels/csrc/flash_attention"
              + ("_f32.cu" if dt == fp32 else ".cu"),
              "src/repro/kernels/flash_attention/flash_attention.py:95",
              [b, h, kv, s, d], got,
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
              2 * (b * h + b * kv) * s * d * isz,
              plain_reps=1 if s >= 4096 else 2,
              layout="heads of a projection" if path else "contiguous",
              extra={"body": body})
        del q, k, v, got
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
        workspace_agrees("ssm_scan", ssm_scan_workspace(b, h, s, dk, dv),
                         _build.extension().ssm_scan_workspace(b, h, s, dk,
                                                               dv))
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

    k6_checks(torch, entry, gen)
    return out


# K6's forward: (B, S, W, scale of i, shift of f, reps).  xlstm-350m's
# prefill shape (B 4, S 4096, W 1024) and its train shape (B 1, S 1024);
# the train shape again with f + 6, where the forget gates stay open and
# each chunk's start state carries far (with f standard-normal the gates
# close within a chunk, so a wrong carry would not show); a ragged S 300
# over 20 features (a tail chunk, a CTA of 20 threads) and S 50 < L (one
# chunk).  The input gate is five times wider, so that the stabiliser m
# matters.
K6_SHAPES = ((4, 4096, 1024, 5.0, 0.0, 10), (1, 1024, 1024, 5.0, 0.0, 20),
             (1, 1024, 1024, 5.0, 6.0, 20), (1, 300, 20, 5.0, 0.0, 20),
             (2, 50, 40, 5.0, 0.0, 20))
# K6's backward: the train shape (with f shifted and not: open gates carry
# the chunk maps far), the ragged one and S below its chunk
K6_BWD_SHAPES = ((1, 1024, 1024, 5.0, 0.0, 20), (1, 1024, 1024, 5.0, 6.0, 20),
                 (1, 300, 20, 5.0, 0.0, 20), (2, 50, 40, 5.0, 0.0, 20))
K6_REPLACES = ("none (port-side; the reference scans _slstm_step, "
               "src/repro/models/ssm.py:210, over time in slstm_train :222)")
K6_BWD_REPLACES = ("none (port-side; the reference's gradient is the "
                   "reverse of its scan of _slstm_step, "
                   "src/repro/models/ssm.py:210, in slstm_train :222)")


def k6_checks(torch, entry, gen):
    """K6 against its plain versions.  The forward: y within 1e-4 of each
    output row's largest value (fp32 on both sides; the kernel's expf /
    tanhf and fused multiply-adds against PyTorch's own, over a
    contractive recurrence, and the chunk carry's exponentials, each <= 0);
    at the train shape also the per-step states the backward reads.  The
    bound counts 27 operations a step (each exp, log1p and tanh as one);
    the bytes (4 inputs read once, y written once) bound it.

    The backward, on the kernel forward's states: each gradient within
    1e-5 of its largest entry.  The kernel carries (dc, dn, dm) across its
    chunks through their composed affine maps and replays each chunk step
    for step; the plain loop carries step by step.  They differ in the
    maps' roundings, the elementary functions' last bits and fused
    multiply-adds; the carry's factors are exp(a - m) <= 1 and wa <= 1, so
    those roundings do not grow (tests/test_torch_slstm_grad.py holds a
    model of the three phases within 1e-6 on the CPU).  The error is taken
    per tensor, not per row: where the input
    gate never wins after a step, the true df of that step is zero and
    both sides keep only the residue of dfs fs - dfs fs, so a row can be
    all residue.  The bound counts about 60 operations a step; the bytes
    (z, i, f, o, c, n, m, dy read once, dz, di, df, do written once: 12 x 4
    a step-feature) bound it."""
    from repro_torch.kernels import (_build, slstm_scan_bwd_cuda,
                                     slstm_scan_bwd_ref, slstm_scan_cuda,
                                     slstm_scan_ref, slstm_scan_states_ref)
    from repro_torch.kernels.slstm.ops import (BWD_CHUNK, CHUNK,
                                               slstm_scan_bwd_workspace,
                                               slstm_scan_workspace)

    def inputs(b, s, w, scale_i, shift_f):
        z, i, f, o = (torch.randn(b, s, w, device="cuda", generator=gen)
                      for _ in range(4))
        i.mul_(scale_i)
        f.add_(shift_f)
        return z, i, f, o

    def label(b, s, w, shift_f):
        return f"B{b} S{s} W{w} f32" + (f" f+{shift_f:g}" if shift_f else "")

    for b, s, w, scale_i, shift_f, reps in K6_SHAPES:
        workspace_agrees("slstm_scan", slstm_scan_workspace(b, s, w),
                         _build.extension().slstm_scan_workspace(b, s, w,
                                                                 CHUNK))
        z, i, f, o = inputs(b, s, w, scale_i, shift_f)
        entry(f"K6 slstm_scan {label(b, s, w, shift_f)}", "slstm_scan_cuda",
              "src/repro_torch/kernels/csrc/slstm.cu", K6_REPLACES,
              [b, s, w], slstm_scan_cuda(z, i, f, o),
              slstm_scan_ref(z, i, f, o), 1e-4,
              lambda z=z, i=i, f=f, o=o: slstm_scan_cuda(z, i, f, o),
              lambda z=z, i=i, f=f, o=o: slstm_scan_ref(z, i, f, o),
              None, reps, 27.0 * b * s * w, PEAK_FP32, 5 * b * s * w * 4,
              plain_reps=1, library_note="no single PyTorch call computes "
              "it", layout="contiguous")
        del z, i, f, o
        torch.cuda.empty_cache()

    for b, s, w, scale_i, shift_f, reps in K6_BWD_SHAPES:
        workspace_agrees("slstm_scan_bwd", slstm_scan_bwd_workspace(b, s, w),
                         _build.extension().slstm_scan_bwd_workspace(
                             b, s, w, BWD_CHUNK))
        z, i, f, o = inputs(b, s, w, scale_i, shift_f)
        dy = torch.randn(b, s, w, device="cuda", generator=gen)
        y, c, n, m = slstm_scan_cuda(z, i, f, o, states=True)
        want_states = slstm_scan_states_ref(z, i, f, o)
        errs = {}
        for name, got, want in zip("ycnm", (y, c, n, m), want_states):
            errs[name] = compare(torch, f"K6 states {name}", got, want, 1e-4,
                                 True)[1]
        emit({"k6_states": [b, s, w], "f_shift": shift_f,
              "max_rel_err_per_row": errs, "tol": 1e-4})
        ins = (z, i, f, o, c, n, m, dy)
        got = slstm_scan_bwd_cuda(*ins)
        want = slstm_scan_bwd_ref(*ins)
        per_grad = {name: compare(torch, f"K6 backward d{name}", g, wt, 1e-5,
                                  False)[1]
                    for name, g, wt in zip("zifo", got, want)}
        entry(f"K6 slstm_scan_bwd {label(b, s, w, shift_f)}",
              "slstm_scan_bwd_cuda", "src/repro_torch/kernels/csrc/slstm.cu",
              K6_BWD_REPLACES, [b, s, w], torch.stack(got),
              torch.stack(want), 1e-5,
              lambda ins=ins: slstm_scan_bwd_cuda(*ins),
              lambda ins=ins: slstm_scan_bwd_ref(*ins),
              None, reps, 60.0 * b * s * w, PEAK_FP32, 12 * b * s * w * 4,
              plain_reps=1, library_note="no single PyTorch call computes "
              "it", layout="contiguous", per_row=False,
              extra={"max_rel_err_per_gradient": per_grad})
        del z, i, f, o, dy, y, c, n, m, ins, got, want, want_states
        torch.cuda.empty_cache()
    k6_refuses(torch, slstm_scan_cuda, slstm_scan_bwd_cuda)


def workspace_agrees(name, wrapper_floats, launcher_floats):
    """K5's and K6's wrappers (K6's backward's too) allocate the fp32
    workspace before their operators (so that a count sees it on meta and
    on the card alike), from a copy of the launcher's formula: the two
    sizes must be one."""
    check(wrapper_floats == launcher_floats,
          f"{name}: the wrapper's workspace of {wrapper_floats} floats is "
          f"not the {launcher_floats} its launcher asks")


def k6_refuses(torch, forward, backward):
    """K6 and its backward take fp32, contiguous tensors of one shape only:
    given bf16, a transposed view or (the backward) a dy of another shape,
    the binding raises with a plain message, nothing is converted or copied
    and nothing counts."""
    z = torch.zeros(1, 64, 32, device="cuda")
    cases = (
        (forward, "fp32", (z.to(torch.bfloat16),) * 4),
        (forward, "contiguous", (z.transpose(1, 2),) * 4),
        (backward, "fp32", (z.to(torch.bfloat16),) * 8),
        (backward, "contiguous", (z.transpose(1, 2),) * 8),
        (backward, "(batch, s, w) alike", (z,) * 7 + (z[:, :32],)))
    for wrapper, what, args in cases:
        before = wrapper.launches
        try:
            wrapper(*args)
            refused = ""
        except RuntimeError as exc:
            refused = str(exc).splitlines()[0]
        counted = wrapper.launches - before
        emit({"k6_refuses": what, "wrapper": wrapper.__name__,
              "message": refused, "launches_counted": counted})
        check(f"must be {what}" in refused, f"{wrapper.__name__} took inputs "
              f"that are not {what}")
        check(counted == 0, f"{wrapper.__name__} counted a refused launch "
              f"({what})")


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
    """Above 256, K4's launcher takes head dims up to the widest both wide
    bodies take (768 on an H100: the bf16 body's resident query tile beside
    its ring, the fp32 body's registers of O), and its refusal states that
    limit: read from the wrapper's refusal of d = 1000 (padded to 1024),
    which must be at least 704, the earlier wide body's limit; then, at the
    next multiple of 128 above the limit (the wrapper pads to multiples of
    128), the binding raises and nothing runs, in either type, and the
    wrapper refuses with the same limit."""
    import re
    from repro_torch.kernels import _build
    big = torch.zeros(1, 1, 128, 1000, device="cuda")
    try:
        wrapper(big, big, big)
        first = ""
    except RuntimeError as exc:
        first = str(exc).splitlines()[0]
    found = re.search(r"multiple of 64 up to (\d+),", first)
    check(found is not None, f"K4's wrapper took d = 1000 or did not state "
          f"its limit: {first!r}")
    widest = int(found.group(1))
    d = (widest // 128 + 1) * 128
    emit({"k4_widest_head_dim": widest, "refused_head_dim": d})
    check(widest >= 704, f"K4's widest head dim is {widest}, below 704")
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
        try:
            wrapper(q[..., :d - 60], q[..., :d - 60], q[..., :d - 60])
            wrapper_refused = ""
        except RuntimeError as exc:
            wrapper_refused = str(exc).splitlines()[0]
        torch.cuda.synchronize()
        untouched = bool(torch.isnan(o).all())
        counted = wrapper.launches - before
        emit({"k4_refuses_head_dim": d, "dtype": str(dt)[6:],
              "message": refused, "wrapper_message": wrapper_refused,
              "output_untouched": untouched, "launches_counted": counted})
        check("head dim must be" in refused,
              f"K4's launcher took d = {d} in {dt}")
        check(f"up to {widest}," in wrapper_refused,
              f"K4's wrapper took d = {d - 60} in {dt}")
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
            128, 0, 128, 0, 128, 0, 128, 128, 128,
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


#: K1's shapes besides 4096^3 at which every CTA tile is held to the plain
#: version, as the default is in k1_cases: (label, A, B) from a draw
K1_TILE_SHAPES = (
    ("300x700x260", lambda rnd: (rnd(300, 700), rnd(700, 260))),
    ("130x130x130 (4-byte path)", lambda rnd: (rnd(130, 130),
                                               rnd(130, 130))),
    ("2048x2048x2048, A at column offset 1 (4-byte path)",
     lambda rnd: (rnd(2048, 2049)[:, 1:], rnd(2048, 2048))),
    ("8x2048x2048x2048 (stacked batch of 8)",
     lambda rnd: (rnd(8, 2048, 2048), rnd(8, 2048, 2048))),
)
#: the largest relative error a K1 tile may show against matmul_ref: the
#: largest K1-K3 showed in the earlier runs (PERF.md); IEEE fp32 FFMAs in
#: ascending k, against the library's order
K1_TILE_TOL = 2.1e-6


def k1_tile_checks(torch, entry, rnd):
    """Every compiled CTA tile of K1's fp32 body: its registers, spills and
    occupancy (0 spill bytes), its result at 4096^3 against the plain
    version (timed beside it and beside torch.matmul: an entry of the
    kernels line) and at K1_TILE_SHAPES, each within K1_TILE_TOL and equal
    bit for bit to the default tile's (the sums' order does not depend on
    the tile); the heuristic plan equal bit for bit to no plan, on the
    default tile; and the launcher's refusal of a tile it does not
    compile."""
    from repro_torch.kernels import _build, matmul, matmul_cuda, matmul_ref
    from repro_torch.kernels.matmul import CTA_TILES, DEFAULT_CTA_TILE
    from repro_torch.perf.kernel import heuristic_plan
    ext = _build.extension()
    for tile in CTA_TILES:
        regs, spill, static, dynamic, ctas, threads, stages = \
            ext.matmul_info(*tile)
        emit({"k1_tile": list(tile), "registers": regs, "spill_bytes": spill,
              "static_smem": static, "dynamic_smem": dynamic,
              "ctas_per_sm": ctas, "threads": threads, "stages": stages})
        check(spill == 0, f"K1 tile {tile}: {spill} spill bytes")
        check(ctas >= 1, f"K1 tile {tile}: no CTA fits an SM")
    n = 4096
    a, b = rnd(n, n), rnd(n, n)
    default = matmul_cuda(a, b, tile=DEFAULT_CTA_TILE)
    for tile in CTA_TILES:
        got = matmul_cuda(a, b, tile=tile)
        check(torch.equal(got, default),
              f"K1 tile {tile} differs from the default tile at {n}^3")
        entry(f"K1 matmul {n}x{n}x{n} float32->float32 (CTA {tile[0]}x"
              f"{tile[1]})", "matmul_cuda",
              "src/repro_torch/kernels/csrc/matmul_f32.cuh",
              "src/repro/kernels/matmul/matmul.py:51", [n, n, n], got,
              matmul_ref(a, b), K1_TILE_TOL,
              lambda t=tile: matmul_cuda(a, b, tile=t),
              lambda: matmul_ref(a, b), lambda: torch.matmul(a, b), 10,
              2.0 * n ** 3, PEAK_FP32, 3 * n * n * 4,
              extra={"cta_tile": list(tile)})
        del got
    plan = heuristic_plan("matmul", (n, n, n), 4)
    before = dict(matmul_cuda.launches_by_tile)
    same = torch.equal(matmul(a, b), matmul(a, b, tiles=plan))
    torch.cuda.synchronize()
    added = {t: c - before.get(t, 0)
             for t, c in matmul_cuda.launches_by_tile.items()
             if c != before.get(t, 0)}
    emit({"k1_heuristic_plan": plan.block_dict(), "bit_identical": same,
          "launches_by_tile": {f"{t[0]}x{t[1]}": c for t, c in added.items()}})
    check(same, "K1: the heuristic plan's result differs from no plan's")
    check(added == {DEFAULT_CTA_TILE: 2},
          f"K1: no plan and the heuristic plan launched {added}")
    del a, b, default
    for label, draw in K1_TILE_SHAPES:
        a, b = draw(rnd)
        want = matmul_ref(a, b)
        default = matmul_cuda(a, b)
        errs = {}
        for tile in CTA_TILES:
            got = matmul_cuda(a, b, tile=tile)
            _abs_err, errs[f"{tile[0]}x{tile[1]}"] = compare(
                torch, f"K1 CTA {tile} {label}", got, want, K1_TILE_TOL,
                False)
            check(torch.equal(got, default),
                  f"K1 tile {tile} differs from the default tile at {label}")
        emit({"k1_tiles_at": label, "max_rel_err": errs,
              "bit_identical_to_default": True})
        del a, b, want, default
    torch.cuda.empty_cache()
    k1_refuses_tile(torch, matmul_cuda)


def k1_refuses_tile(torch, wrapper):
    """K1's launcher runs the CTA tiles it compiles: given 256 x 256 (whose
    accumulators would need every register of an SM), the binding raises
    and nothing runs or counts."""
    a = torch.zeros(128, 128, device="cuda")
    before = wrapper.launches
    try:
        wrapper(a, a, tile=(256, 256))
        refused = ""
    except RuntimeError as exc:
        refused = str(exc).splitlines()[0]
    torch.cuda.synchronize()
    counted = wrapper.launches - before
    emit({"k1_refuses_tile": [256, 256], "message": refused,
          "launches_counted": counted})
    check("a compiled CTA tile" in refused,
          "K1's launcher took a 256 x 256 CTA tile")
    check(counted == 0, "K1 counted a refused launch")


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
    from repro_torch.kernels.matmul import DEFAULT_CTA_TILE
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
        by_tile = dict(kernels.matmul_cuda.launches_by_tile)
        add_counts(TILE_LAUNCHES, by_tile)
        res = residual(torch, op, args, out)
        emit({"main_path": op, "n": N_MAIN, "dtype": "float32",
              "plan": plan_summary(plan), "wall_s": wall, "residual": res,
              "launches": counts, "k1_launches_by_tile": {
                  f"{t[0]}x{t[1]}": c for t, c in by_tile.items()}})
        check(res < 1e-4, f"main path {op}: residual {res:.3e}")
        # h100-sxm has no kernel constants: the heuristic plan, K1's
        # default tile
        check(by_tile == {DEFAULT_CTA_TILE: counts["matmul_cuda"]},
              f"main path {op}: K1 launched off its default tile: "
              f"{by_tile}")
        for name in PATH_KERNELS[op]:
            check(counts[name] > 0, f"main path {op}: {name} never launched")
        for name, count in counts.items():
            totals[name] += count
        del args, out
        torch.cuda.empty_cache()
    add_counts(totals, bf16_matmul(torch, tuner, gen))
    return totals


#: the bf16 call of the main path: linalg.matmul at n = 4096 on one card
N_BF16 = 4096


def bf16_matmul(torch, tuner, gen):
    """``linalg.matmul`` on bf16 operands at N_BF16, p = 1: the dispatch
    hands its local product to K1 in bf16, whose tensor-core body must run
    (every launch of the call on it), the result bf16 and within
    K1_BF16_OUT_TOL of ``matmul_ref`` on the same inputs (each side rounds
    its fp32 sums to bf16 once).  Returns the call's launch counts."""
    from repro_torch import kernels, linalg
    from repro_torch.devices import default_devices
    a, b = (torch.randn(N_BF16, N_BF16, device="cuda", generator=gen)
            .to(torch.bfloat16) for _ in range(2))
    plan = tuner.plan("matmul", N_BF16, devices=default_devices(),
                      dtype="bfloat16")
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = linalg.matmul(a, b, tuner=tuner)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launches()
    by_body = dict(kernels.matmul_cuda.launches_by_body)
    add_counts(BODY_LAUNCHES, by_body)
    want = kernels.matmul_ref(a, b, out_dtype=torch.bfloat16).float()
    err = float((out.float() - want).abs().max() / want.abs().max())
    emit({"main_path": "matmul", "n": N_BF16, "dtype": "bfloat16",
          "plan": plan_summary(plan), "wall_s": wall, "out_dtype":
          str(out.dtype)[6:], "max_rel_err": err, "tol": K1_BF16_OUT_TOL,
          "launches": counts, "k1_launches_by_body": by_body})
    check(out.dtype == torch.bfloat16, f"main path bf16 matmul: {out.dtype}")
    check(err < K1_BF16_OUT_TOL, f"main path bf16 matmul: rel err {err:.3e}")
    check(by_body.get("bf16_wgmma", 0) > 0
          and by_body == {"bf16_wgmma": counts["matmul_cuda"]},
          f"main path bf16 matmul: K1's bodies {by_body}")
    return counts


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


def forced_plan(algo, variant, n):
    """The plan that forces one variant: 2D on 2x2, 2.5D on 2x2x2."""
    from repro_torch.core.machine import H100_SXM
    from repro_torch.perf.kernel import tiles_for_plan
    from repro_torch.tuner.plan import ExecutionPlan
    c, g = (2, 2) if variant.startswith("2.5d") else (1, 2)
    return ExecutionPlan(
        algo=algo, variant=variant, n=n, p=c * g * g, c=c, r=1, g=g,
        local_kernel="pallas", dtype="float32", machine=H100_SXM.name,
        fingerprint="forced", predicted={},
        tiles=tiles_for_plan(H100_SXM, algo, n, g, "float32"))


def forced_variants(torch):
    """§4.2; returns each variant's output, on the host, for §11."""
    from repro_torch import kernels
    from repro_torch.linalg import ALGORITHMS
    from repro_torch.tuner.dispatch import execute
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    ops = {op: operands(torch, op, N_VARIANTS, gen)
           for op in ("matmul", "trsm", "cholesky")}
    want = {op: library_result(torch, op, args) for op, args in ops.items()}
    outputs = {}
    for algo, variant in ALGORITHMS:
        op = "matmul" if algo in ("cannon", "summa") else algo
        plan = forced_plan(algo, variant, N_VARIANTS)
        c, g = plan.c, plan.g
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
        outputs[(algo, variant)] = out.cpu()
    return outputs


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
        calls, bodies = [], None
        for _ in ("cold", "warm"):
            kernels.reset_launches()
            t0 = time.perf_counter()
            logits = step(net, tokens, **stubs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            calls.append((wall, kernels.launches(), logits))
            if not bodies:
                bodies = dict(kernels.flash_attention_cuda.launches_by_body)
        (cold, cold_counts, logits), (warm, warm_counts, warm_logits) = calls
        add_counts(K4_BODY_LAUNCHES, bodies)
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
                "k4_launches_by_body_cold": bodies,
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
# leaves room for the card's other summation orders.  Depth 1 (2 where one
# layer does not hold the path: xlstm's mLSTM and sLSTM) keeps the CPU side
# short; whisper-tiny runs at full depth (4 + 4 layers).  The VLM's
# pattern is changed for this check only: a cross layer every 2 layers (not
# 5), so that its 2 layers are one self and one cross layer at full width.
CPU_CHECKS = (
    ("starcoder2-3b", "float32", 1e-3, {"n_layers": 1},
     {"flash_attention_cuda": 1}),
    ("hymba-1.5b", "float32", 1e-3, {"n_layers": 1}, {"ssm_scan_cuda": 1}),
    ("starcoder2-3b", "bfloat16", 2e-2, {"n_layers": 1},
     {"flash_attention_cuda": 1}),
    ("xlstm-350m", "float32", 1e-3, {"n_layers": 2},
     {"ssm_scan_cuda": 1, "slstm_scan_cuda": 1}),
    ("qwen2-moe-a2.7b", "float32", 1e-3, {"n_layers": 1},
     {"flash_attention_cuda": 1}),
    ("whisper-tiny", "float32", 1e-3, {}, {"flash_attention_cuda": 4}),
    ("llama-3.2-vision-11b", "float32", 1e-3,
     {"n_layers": 2, "cross_attn_every": 2}, {"flash_attention_cuda": 1}),
)


def check_config(arch, dtype, changes):
    """The config of a §6 or §9 check: ``arch`` in ``dtype`` with
    ``changes``."""
    import dataclasses
    from repro_torch.configs import get
    cfg = get(arch)
    changes = dict(changes, dtype=dtype)
    every = changes.pop("cross_attn_every", None)
    if every:
        changes["vision"] = dataclasses.replace(cfg.vision,
                                                cross_attn_every=every)
    factor = changes.pop("capacity_factor", None)
    if factor:
        changes["moe"] = dataclasses.replace(cfg.moe,
                                             capacity_factor=factor)
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
        bodies = dict(kernels.flash_attention_cuda.launches_by_body)
        add_counts(K4_BODY_LAUNCHES, bodies)
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
                "k4_launches_by_body": bodies, "cpu_s": cpu_s}
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
        k4 = counts["flash_attention_cuda"]
        family = "fp32" if dtype == "float32" else "bf16_wgmma"
        check(k4_bodies_are(bodies, k4, family),
              f"prefill vs cpu {arch} {dtype}: K4 bodies {bodies}")
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


# -- 9. serving: the decode path, the scheduler and Engine.generate ----------

SERVE_ARCH = "starcoder2-3b"
#: the served run's depth, cut from 30 for the script's time (§12's serving
#: bench still serves qwen1.5-4b at full depth on the card)
SERVE_LAYERS = 4
SERVE_PROMPTS = (128, 512, 1000, 2000, 3000, 3900)
SERVE_NEW = 32
SERVE_CACHE = 4096
# the block kinds' one-step decode at full width, fp32: (arch, config
# changes); depth 2 keeps the CPU side short, whisper-tiny runs at full
# depth and the VLM with a cross layer every 2 layers, as in §6.  A chunk
# of chunked prefill is one MoE routing group, which drops tokens past an
# expert's capacity where one token a step never does: the MoE runs at a
# capacity factor of 16, at which 16 tokens (top-4 of 60 experts) fit every
# expert, so that the chunked decode and the per-token one route alike
# (the reference's own decode check raises the factor for the same reason)
DECODE_CHECKS = (
    ("starcoder2-3b", {"n_layers": 2}),
    ("qwen2-moe-a2.7b", {"n_layers": 2, "capacity_factor": 16.0}),
    ("xlstm-350m", {"n_layers": 2}),
    ("hymba-1.5b", {"n_layers": 2}),
    ("llama-3.2-vision-11b", {"n_layers": 2, "cross_attn_every": 2}),
    ("whisper-tiny", {}),
)
DECODE_PROMPT = 32
DECODE_NEW = 16
DECODE_CHUNK = 16
# hymba's window is 1024: its KV ring wraps after 1024 tokens
WINDOW_PROMPT = 1000
WINDOW_NEW = 48
# batch against single: (prompt length, new tokens) of three requests
STAGGERED = ((40, 12), (17, 8), (64, 10))


def cpu_op_guard(torch):
    """A dispatch mode that counts, by operator, every operation with a
    tensor on the CPU among its inputs or outputs: none may run while the
    served path runs on the card."""
    import collections
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class CpuOps(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if any(isinstance(t, torch.Tensor) and t.device.type == "cpu"
                   for t in tree_leaves((args, kwargs, out))):
                self.ops[str(func)] += 1
            return out

    return CpuOps()


class MarginLog:
    """Records, while installed, the top-2 margin of the last position's
    logits at every token ``ModelBackend`` samples (as tensors on the
    card: read after the run)."""

    def __enter__(self):
        from repro_torch.serving.scheduler import ModelBackend
        self.margins = []
        self._sample = ModelBackend._sample
        orig = self._sample

        def sample(backend, rs, logits):
            top = logits[:, -1].float().topk(2, dim=-1).values
            self.margins.append(top[0, 0] - top[0, 1])
            return orig(backend, rs, logits)

        ModelBackend._sample = sample
        return self

    def __exit__(self, *exc):
        from repro_torch.serving.scheduler import ModelBackend
        ModelBackend._sample = self._sample
        return False


def first_difference(got, want, margins):
    """The first position where two token lists differ, with the single
    run's top-2 margin there; None where they agree."""
    for j, (a, b) in enumerate(zip(got, want)):
        if a != b:
            return {"position": j, "scheduled": a, "single": b,
                    "single_top2_margin": float(margins[j])}
    return None


def staggered_run(torch, scheduler_of, prompts, new_tokens):
    """Submit one request between scheduler steps (two steps after the
    first), then run to the end, as the reference's join/evict test does.
    Returns (scheduler, step reports, wall seconds)."""
    from repro_torch.serving import Request
    sched = scheduler_of()
    reports = []
    t0 = time.perf_counter()
    for i, (p, n) in enumerate(zip(prompts, new_tokens)):
        sched.submit(Request(rid=f"r{i}", prompt=p, max_new_tokens=n))
        for _ in range(2 if i == 0 else 1):
            rep = sched.step()
            if rep is not None:
                reports.append(rep)
    reports += sched.run()
    torch.cuda.synchronize()
    return sched, reports, time.perf_counter() - t0


def serving(torch):
    """§9; returns the launch counts of its runs, summed."""
    from repro_torch import kernels
    totals = {name: 0 for name in kernels.launches()}
    t_start = time.perf_counter()
    for part in (served_run, block_kinds_decode, batch_against_single):
        t0 = time.perf_counter()
        kernels.reset_launches()
        part(torch)
        counts = kernels.launches()
        emit({"serving_part": part.__name__, "launches": counts,
              "wall_s": time.perf_counter() - t0})
        for name, n in counts.items():
            totals[name] += n
    emit({"serving_s": time.perf_counter() - t_start})
    return totals


def served_run(torch):
    """starcoder2-3b at full width and depth SERVE_LAYERS, bf16, serves six
    staggered requests, once under each policy (a cold and a warm run
    each), with telemetry recording on, so that the backend synchronizes
    the card at the end of each step's prefill and decode phases and the
    scheduler's clock reads device time; the cold FIFO run goes under the
    CPU-op guard, which fails the check if any operation touches a CPU
    tensor.  Each request's tokens are then compared with its own
    single-request ``Engine.generate``."""
    import dataclasses
    from repro_torch import telemetry
    from repro_torch.configs import get
    from repro_torch.core.machine import H100_SXM
    from repro_torch.models import build_model
    from repro_torch.serving import (Engine, FIFOPolicy, ModelBackend,
                                     ModelGuidedPolicy, Scheduler,
                                     SchedulerConfig, ServeConfig,
                                     cost_model_for)
    from repro_torch.serving.scheduler import token_int
    cfg = dataclasses.replace(get(SERVE_ARCH), n_layers=SERVE_LAYERS)
    model = build_model(cfg)
    net = model.init(SEED)                        # the current GPU
    check(all(p.device.type == "cuda" for p in net.parameters()),
          "serving: a parameter is not on the card")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    prompts = [torch.randint(0, cfg.vocab_size, (1, n), device="cuda",
                             generator=gen) for n in SERVE_PROMPTS]
    new = [SERVE_NEW] * len(prompts)
    cost = cost_model_for(cfg, H100_SXM)
    store_dir = os.path.join(HERE, "build", "serve_runs")
    shutil.rmtree(store_dir, ignore_errors=True)
    store = telemetry.RunStore(store_dir)
    telemetry.enable(store)
    tokens = {}
    try:
        for policy in (FIFOPolicy(), ModelGuidedPolicy()):
            for when in ("cold", "warm"):
                torch.cuda.reset_peak_memory_stats()
                # the cold FIFO run under the CPU-op guard: its times carry
                # the guard's cost, a Python call for every operation
                guard = (cpu_op_guard(torch)
                         if (policy.name, when) == ("fifo", "cold") else None)
                with guard or contextlib.nullcontext():
                    sched, reports, wall = staggered_run(
                        torch, lambda: Scheduler(
                            ModelBackend(model, net,
                                         max_cache_len=SERVE_CACHE),
                            cost, SchedulerConfig(max_cache_len=SERVE_CACHE,
                                                  max_batch=len(prompts)),
                            policy=policy), prompts, new)
                outs = {rid: rs.out for rid, rs in sched.finished.items()}
                check(all(t.device.type == "cuda" for out in outs.values()
                          for t in out), "serving: a token is not on the "
                      "card")
                tokens[policy.name, when] = {
                    rid: [token_int(t) for t in out]
                    for rid, out in sorted(outs.items())}
                metrics = sorted(sched.request_metrics(),
                                 key=lambda m: m["rid"])
                decode_s = sum(r.measured_decode_s for r in reports)
                decode_tokens = sum(r.decode_batch for r in reports)
                line = {
                    "serve": SERVE_ARCH, "policy": policy.name,
                    "run": when, "dtype": cfg.dtype, "layers": cfg.n_layers,
                    "prompt_lens": list(SERVE_PROMPTS),
                    "new_tokens": SERVE_NEW, "max_cache_len": SERVE_CACHE,
                    "wall_s": wall, "steps": len(reports),
                    "max_decode_batch": max(r.decode_batch
                                            for r in reports),
                    "prefill_s": sum(r.measured_prefill_s for r in reports),
                    "decode_s": decode_s, "decode_tokens": decode_tokens,
                    "predicted_prefill_s": sum(r.predicted.prefill_s
                                               for r in reports),
                    "predicted_decode_s": sum(r.predicted.decode_s
                                              for r in reports),
                    "decode_tokens_per_s": decode_tokens / decode_s,
                    "tokens_per_s": sum(len(o) for o in outs.values())
                    / wall,
                    "max_memory_allocated": torch.cuda.max_memory_allocated(),
                    "kv_blocks_free": sched.blocks.free_blocks,
                    "kv_blocks": sched.cfg.num_blocks,
                    "requests": [{k: m[k] for k in ("rid", "prompt_len",
                                                    "n_out", "ttft_s",
                                                    "tpot_s")}
                                 for m in metrics]}
                line["cpu_op_guard"] = guard is not None
                if guard is not None:
                    line["cpu_ops"] = dict(guard.ops)
                emit(line)
                check(guard is None or not guard.ops,
                      f"serving {policy.name} {when}: operations ran on the "
                      f"CPU: {line.get('cpu_ops')}")
                check(all(len(o) == SERVE_NEW for o in outs.values())
                      and len(outs) == len(prompts),
                      f"serving {policy.name} {when}: a request did not end "
                      f"with {SERVE_NEW} tokens")
                check(sched.blocks.free_blocks == sched.cfg.num_blocks,
                      f"serving {policy.name} {when}: KV blocks not "
                      "returned to the pool")
                check(line["max_decode_batch"] > 1,
                      f"serving {policy.name} {when}: no batched decode")
    finally:
        telemetry.disable()
    records = store.load()
    emit({"serve_records": len(records),
          "kinds": sorted({r.kind for r in records})})
    check(any(r.kind == "serve_step" for r in records),
          "serving: no serve_step record")

    # each request alone, through Engine.generate (the shortest under the
    # CPU-op guard), against the scheduled runs: reported, not gated
    for i, p in enumerate(prompts):
        eng = Engine(model, net, ServeConfig(max_new_tokens=SERVE_NEW,
                                             max_cache_len=SERVE_CACHE))
        guard = cpu_op_guard(torch) if i == 0 else None
        with MarginLog() as log:
            if guard is not None:
                with guard:
                    out = eng.generate(p)
            else:
                out = eng.generate(p)
        single = out[0, p.shape[1]:].tolist()
        line = {"serve_single": f"r{i}", "prompt_len": p.shape[1],
                "tokens_equal": {}}
        for (pol, when), toks in tokens.items():
            got = toks[f"r{i}"]
            line["tokens_equal"][f"{pol} {when}"] = got == single
            diff = first_difference(got, single, log.margins)
            if diff is not None:
                line.setdefault("first_difference", {})[
                    f"{pol} {when}"] = diff
        if guard is not None:
            line["cpu_ops"] = dict(guard.ops)
        emit(line)
        if guard is not None:
            check(not guard.ops, f"serving: operations ran on the CPU: "
                  f"{dict(guard.ops)}")
    del net
    torch.cuda.empty_cache()


def decode_logits(torch, model, net, seq, memory, chunk=1, max_len=None):
    """The decode path's logits (1, S, V) over ``seq`` (1, S), fed
    ``chunk`` tokens a step from empty caches on ``seq``'s device."""
    caches = model.init_cache(1, max_len or seq.shape[1], device=seq.device)
    out = []
    with torch.inference_mode():
        for t in range(0, seq.shape[1], chunk):
            lg, caches = model.decode_step(net, seq[:, t:t + chunk], caches,
                                           memory)
            out.append(lg)
    return torch.cat(out, dim=1)


def greedy_sequence(torch, model, net, prompt, memory, new, max_len):
    """The prompt followed by ``new`` greedy tokens, decoded one token a
    step on ``prompt``'s device, and the logits of every step fed."""
    caches = model.init_cache(1, max_len, device=prompt.device)
    seq, out = prompt, []
    with torch.inference_mode():
        for t in range(prompt.shape[1] + new):
            lg, caches = model.decode_step(net, seq[:, t:t + 1], caches,
                                           memory)
            out.append(lg)
            if t + 1 >= seq.shape[1] and t + 1 < prompt.shape[1] + new:
                seq = torch.cat([seq, lg[:, -1:].argmax(-1)], dim=1)
    return seq, torch.cat(out, dim=1)


def block_kinds_decode(torch):
    """Every block kind's one-step decode at full width, fp32, on the card
    against the CPU with one state dict (per step: < 1e-3 of the step's
    largest logit and the same argmax); the chunked decode against the
    per-token one on the card; hymba's KV ring across its window against
    the card's own full-sequence forward."""
    import dataclasses
    from repro_torch.launch.prefill import stub_inputs
    from repro_torch.models import build_model
    from repro_torch.models.transformer import (decoder_forward_train,
                                                lm_logits)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    for arch, changes in DECODE_CHECKS:
        cfg = check_config(arch, "float32", changes)
        model = build_model(cfg)
        net = model.init(SEED, device="cuda")
        net_cpu = type(net)(cfg, device="cpu")
        net_cpu.load_state_dict({k: v.cpu()
                                 for k, v in net.state_dict().items()})
        stubs = stub_inputs(cfg, 1, seed=SEED + 2, device="cuda")
        with torch.inference_mode():
            memory = model.encode_memory(net, stubs)
            memory_cpu = model.encode_memory(
                net_cpu, {k: v.cpu() for k, v in stubs.items()})
        prompt = torch.randint(0, cfg.vocab_size, (1, DECODE_PROMPT),
                               device="cuda", generator=gen)
        n = DECODE_PROMPT + DECODE_NEW
        t0 = time.perf_counter()
        seq, card = greedy_sequence(torch, model, net, prompt, memory,
                                    DECODE_NEW, n)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = decode_logits(torch, model, net_cpu, seq.cpu(), memory_cpu)
        cpu_s = time.perf_counter() - t0
        card = card.cpu()
        step_err = ((card - cpu).abs().amax(-1)
                    / cpu.abs().amax(-1)).flatten()
        argmax_equal = bool((card.argmax(-1) == cpu.argmax(-1)).all())
        line = {"decode_vs_cpu": arch, "layers": cfg.n_layers,
                "dtype": "float32", "config_changes": changes,
                "steps": seq.shape[1], "prompt_len": DECODE_PROMPT,
                "new_tokens": DECODE_NEW,
                "max_rel_err": float(step_err.max()), "tol": 1e-3,
                "argmax_equal_every_step": argmax_equal,
                "card_s": card_s, "cpu_s": cpu_s}
        if model.supports_chunked_prefill:
            chunked = decode_logits(torch, model, net, seq, memory,
                                    chunk=DECODE_CHUNK).cpu()
            line["chunked_vs_per_token_rel_err"] = float(
                (chunked - card).abs().max() / card.abs().max())
        emit(line)
        check(line["max_rel_err"] < 1e-3, f"decode vs cpu {arch}: rel err "
              f"{line['max_rel_err']:.3e}")
        check(argmax_equal, f"decode vs cpu {arch}: argmax differs")
        if model.supports_chunked_prefill:
            check(line["chunked_vs_per_token_rel_err"] < 1e-3,
                  f"decode {arch}: chunked against per-token rel err "
                  f"{line['chunked_vs_per_token_rel_err']:.3e}")
        del net, net_cpu, stubs, memory, memory_cpu, card, cpu
        torch.cuda.empty_cache()

    # hymba across its window: the ring of 1024 slots wraps at token 1024
    cfg = check_config("hymba-1.5b", "float32", {"n_layers": 2})
    model = build_model(cfg)
    net = model.init(SEED, device="cuda")
    n = WINDOW_PROMPT + WINDOW_NEW
    prompt = torch.randint(0, cfg.vocab_size, (1, WINDOW_PROMPT),
                           device="cuda", generator=gen)
    seq, dec = greedy_sequence(torch, model, net, prompt, None, WINDOW_NEW,
                               n)
    with torch.inference_mode():
        hidden, _ = decoder_forward_train(net, cfg, seq)
        full = lm_logits(net, cfg, hidden)
    ring = model.init_cache(1, n, device="cuda")[0]["kv"].k.shape[2]
    err = float((dec - full).abs().max() / full.abs().max())
    emit({"hymba_window": cfg.sliding_window, "ring_slots": ring,
          "tokens": n, "max_rel_err": err, "tol": 1e-3})
    check(ring == cfg.sliding_window < n, "hymba: the ring does not wrap")
    check(err < 1e-3, f"hymba across its window: rel err {err:.3e}")
    del net, dec, full
    torch.cuda.empty_cache()


def batch_against_single(torch):
    """starcoder2-3b at depth 2 and full width, fp32: three staggered
    requests through the scheduler's ``ModelBackend`` (under the CPU-op
    guard) give exactly the tokens each gives alone through
    ``Engine.generate``."""
    from repro_torch.core.machine import H100_SXM
    from repro_torch.models import build_model
    from repro_torch.serving import (Engine, ModelBackend, ModelGuidedPolicy,
                                     Scheduler, SchedulerConfig, ServeConfig,
                                     cost_model_for)
    from repro_torch.serving.scheduler import token_int
    cfg = check_config("starcoder2-3b", "float32", {"n_layers": 2})
    model = build_model(cfg)
    net = model.init(SEED, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    prompts = [torch.randint(0, cfg.vocab_size, (1, s), device="cuda",
                             generator=gen) for s, _ in STAGGERED]
    new = [n for _, n in STAGGERED]
    alone = []
    for p, n in zip(prompts, new):
        with MarginLog() as log:
            out = Engine(model, net, ServeConfig(
                max_new_tokens=n, max_cache_len=128)).generate(p)
        alone.append((out[0, p.shape[1]:].tolist(), log.margins))
    guard = cpu_op_guard(torch)
    with guard:
        sched, reports, wall = staggered_run(
            torch, lambda: Scheduler(
                ModelBackend(model, net, max_cache_len=128),
                cost_model_for(cfg, H100_SXM),
                SchedulerConfig(max_cache_len=128, max_batch=4),
                policy=ModelGuidedPolicy(step_budget_s=0.05)), prompts, new)
    line = {"batch_vs_single": "starcoder2-3b", "layers": cfg.n_layers,
            "dtype": "float32", "requests": [list(r) for r in STAGGERED],
            "steps": len(reports),
            "max_decode_batch": max(r.decode_batch for r in reports),
            "cpu_ops": dict(guard.ops), "equal": {}}
    for i, (single, margins) in enumerate(alone):
        got = [token_int(t) for t in sched.finished[f"r{i}"].out]
        line["equal"][f"r{i}"] = got == single
        diff = first_difference(got, single, margins)
        if diff is not None:
            line.setdefault("first_difference", {})[f"r{i}"] = diff
    emit(line)
    check(not guard.ops, f"batch vs single: operations ran on the CPU: "
          f"{dict(guard.ops)}")
    check(line["max_decode_batch"] > 1, "batch vs single: no batched decode")
    check(all(line["equal"].values()), "batch vs single: a request's "
          f"tokens differ from its own: {line.get('first_difference')}")
    del net
    torch.cuda.empty_cache()


# -- 10. training: the loss, its gradients, the optimizer, the trainer -------

# card against CPU, fp32, full width, depth 2 (starcoder2-3b and hymba-1.5b
# depth 1, for the script's time; whisper-tiny: full depth, the VLM with a
# cross layer every 2 layers, as in §6), one prompt a batch,
# remat off (checked on and off on the card for starcoder2-3b below):
# (arch, config changes, tokens, the launches each kernel makes in the
# card's forward).  S = 2304 takes K4 (starcoder2-3b, whisper-tiny's
# decoder) and hymba-1.5b's windowed loop; K5 and K6 take any S >= 128;
# qwen2-moe-a2.7b and the VLM take no kernel and run 256 tokens (512
# before they were cut for the script's time).  Loss within 1e-4
# relative, each parameter's gradient within 1e-3 of its largest entry: only summation orders differ (fp32 products with IEEE
# fp32, the kernels' forward, K4's and K5's twins' backward and K6's
# backward kernel against its plain version)
TRAIN_CHECKS = (
    ("starcoder2-3b", {"n_layers": 1}, 2304, {"flash_attention_cuda": 1}),
    ("hymba-1.5b", {"n_layers": 1}, 2304, {"ssm_scan_cuda": 1}),
    ("xlstm-350m", {"n_layers": 2}, 1024,
     {"ssm_scan_cuda": 1, "slstm_scan_cuda": 1, "slstm_scan_bwd_cuda": 1}),
    ("qwen2-moe-a2.7b", {"n_layers": 2}, 256, {}),
    ("whisper-tiny", {}, 2304, {"flash_attention_cuda": 4}),
    ("llama-3.2-vision-11b", {"n_layers": 2, "cross_attn_every": 2}, 256, {}),
)
TRAIN_LOSS_TOL = 1e-4
TRAIN_GRAD_TOL = 1e-3
# full width and depth through Trainer: (arch, tokens, steps, the kernels
# each step must launch)
TRAIN_FULL = (("starcoder2-3b", 4096, 4, ("flash_attention_cuda",)),
              ("xlstm-350m", 1024, 2, ("ssm_scan_cuda", "slstm_scan_cuda",
                                       "slstm_scan_bwd_cuda")))
# the loss on one fixed batch, and the restart: starcoder2-3b, depth 2,
# fp32, one prompt of 512 tokens
SMALL_TRAIN = ("starcoder2-3b", {"n_layers": 2}, 512)


def training(torch):
    """§10; returns the launch counts of its runs, summed."""
    from repro_torch import kernels
    totals = {name: 0 for name in kernels.launches()}
    t_start = time.perf_counter()
    for part in (train_against_cpu, train_full_width, loss_falls,
                 restart_matches):
        t0 = time.perf_counter()
        kernels.reset_launches()
        part(torch)
        counts = kernels.launches()
        emit({"training_part": part.__name__, "launches": counts,
              "wall_s": time.perf_counter() - t0})
        for name, n in counts.items():
            totals[name] += n
    emit({"training_s": time.perf_counter() - t_start})
    return totals


def launches_since(before):
    """Each kernel's launches since the counts ``before`` were read (§10
    reads its counts this way, so that its parts' totals keep every
    launch)."""
    from repro_torch import kernels
    return {k: n - before[k] for k, n in kernels.launches().items()}


def numpy_batch(cfg, seq, seed):
    """One prompt's tokens and next-token labels (int32), and the stub
    inputs the architecture takes (fp32), drawn with numpy."""
    import numpy as np
    from repro_torch.launch.prefill import stub_shapes
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (1, seq + 1)).astype(np.int32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    for name, shape in stub_shapes(cfg).items():
        batch[name] = (rng.standard_normal((1,) + shape)
                       * 0.1).astype(np.float32)
    return batch


def loss_and_grads(torch, model, net, batch):
    """(loss, {"ce", "aux"}, {name: gradient}) of one batch of numpy
    arrays on ``net``'s device."""
    device = next(net.parameters()).device
    names, params = zip(*net.named_parameters())
    loss, metrics = model.loss(net, {k: torch.from_numpy(v).to(device)
                                     for k, v in batch.items()})
    grads = torch.autograd.grad(loss, params)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            dict(zip(names, grads)))


def grad_errors(got, want):
    """Per parameter: the largest difference over the CPU's largest entry
    (fp32, on the host)."""
    out = {}
    for name, w in want.items():
        g = got[name].float().cpu()
        out[name] = float((g - w).abs().max()
                          / w.abs().max().clamp(min=1e-30))
    return out


def train_against_cpu(torch):
    """10.1: the loss and every parameter's gradient on the card against
    the CPU with one state dict and one numpy batch; the MoE's routing
    compared; remat on against off on the card (starcoder2-3b)."""
    import dataclasses
    from repro_torch import kernels
    from repro_torch.models import build_model
    for arch, changes, seq, want_counts in TRAIN_CHECKS:
        cfg = dataclasses.replace(check_config(arch, "float32", changes),
                                  remat=False)
        model = build_model(cfg)
        net = model.init(SEED, device="cuda")
        net_cpu = type(net)(cfg, device="cpu")
        net_cpu.load_state_dict({k: v.cpu()
                                 for k, v in net.state_dict().items()})
        batch = numpy_batch(cfg, seq, SEED + 10)
        before = kernels.launches()
        t0 = time.perf_counter()
        with RoutingLog() as card_routes:
            loss, metrics, grads = loss_and_grads(torch, model, net, batch)
            torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        counts = launches_since(before)
        t0 = time.perf_counter()
        with RoutingLog() as cpu_routes:
            loss_c, metrics_c, grads_c = loss_and_grads(torch, model,
                                                        net_cpu, batch)
        cpu_s = time.perf_counter() - t0
        loss_err = abs(float(loss) - float(loss_c)) / abs(float(loss_c))
        errs = grad_errors(grads, grads_c)
        worst = max(errs, key=errs.get)
        line = {"train_vs_cpu": arch, "layers": cfg.n_layers,
                "dtype": "float32", "tokens": seq, "config_changes": changes,
                "loss_card": float(loss), "loss_cpu": float(loss_c),
                "loss_rel_err": loss_err, "loss_tol": TRAIN_LOSS_TOL,
                "aux_card": float(metrics["aux"]),
                "aux_cpu": float(metrics_c["aux"]),
                "params": len(errs), "grad_max_rel_err": errs[worst],
                "grad_worst_param": worst, "grad_tol": TRAIN_GRAD_TOL,
                "launches": counts, "card_s": card_s, "cpu_s": cpu_s}
        routing_equal = True
        if cfg.moe:
            diffs = routing_differences(card_routes.calls, cpu_routes.calls)
            line["routing_card_vs_cpu"] = diffs
            routing_equal = not any(d["gate_idx_differs"] or d["keep_differs"]
                                    for d in diffs)
            line["gated"] = routing_equal
            check(len(card_routes.calls) == len(cpu_routes.calls)
                  == cfg.n_layers, f"train vs cpu {arch}: routing decisions "
                  f"{len(card_routes.calls)} / {len(cpu_routes.calls)}")
            check(float(metrics["aux"]) > 0, f"train vs cpu {arch}: no aux "
                  "loss")
        emit(line)
        for name, n in want_counts.items():
            check(counts[name] == n, f"train vs cpu {arch}: {name} "
                  f"launched {counts[name]} times, not {n}")
        check(torch.isfinite(loss).item(), f"train vs cpu {arch}: loss")
        if routing_equal:
            check(loss_err < TRAIN_LOSS_TOL, f"train vs cpu {arch}: loss rel "
                  f"err {loss_err:.3e}")
            check(errs[worst] < TRAIN_GRAD_TOL, f"train vs cpu {arch}: "
                  f"gradient of {worst} rel err {errs[worst]:.3e}")
        if arch == "starcoder2-3b":
            remat_against_no_remat(torch, cfg, net, batch, loss, grads)
        del net, net_cpu, grads, grads_c
        torch.cuda.empty_cache()


def remat_against_no_remat(torch, cfg, net, batch, loss, grads):
    """The same loss and gradients on the card with each layer
    checkpointed: K4 launched twice as often (the recompute), peak memory
    beside the run without."""
    import dataclasses
    from repro_torch import kernels
    from repro_torch.models import build_model
    peaks = {}
    for remat in (False, True):
        model = build_model(dataclasses.replace(cfg, remat=remat))
        before = kernels.launches()
        torch.cuda.reset_peak_memory_stats()
        l, _, g = loss_and_grads(torch, model, net, batch)
        torch.cuda.synchronize()
        peaks[remat] = (torch.cuda.max_memory_allocated(),
                        launches_since(before)["flash_attention_cuda"])
    err = max(float((g[n] - grads[n]).abs().max()
                    / grads[n].abs().max().clamp(min=1e-30)) for n in grads)
    line = {"train_remat": cfg.name, "layers": cfg.n_layers,
            "loss_rel_err": abs(float(l) - float(loss)) / abs(float(loss)),
            "grad_max_rel_err": err, "tol": 1e-5,
            "peak_memory_no_remat": peaks[False][0],
            "peak_memory_remat": peaks[True][0],
            "k4_launches_no_remat": peaks[False][1],
            "k4_launches_remat": peaks[True][1]}
    emit(line)
    check(line["loss_rel_err"] < 1e-5 and err < 1e-5,
          f"remat against no remat: rel err {err:.3e}")
    check(peaks[True][1] == 2 * peaks[False][1],
          "remat: K4 not launched again in the recompute")


class TwinTimer:
    """Adds up, while installed, the synchronized wall time of the K5 and
    K6 sites' backward passes: K5's through its twin (the recompute and
    its gradient), K6's through its backward kernel."""

    def __enter__(self):
        import torch
        from repro_torch.models import ssm
        self.s = {"SSMScan": 0.0, "SLSTMScan": 0.0}
        self._saved = []
        for name in self.s:
            fn_cls = getattr(ssm, name)
            orig = fn_cls.backward
            self._saved.append((fn_cls, orig))

            def timed(ctx, *grads, _orig=orig, _name=name):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _orig(ctx, *grads)
                torch.cuda.synchronize()
                self.s[_name] += time.perf_counter() - t0
                return out

            fn_cls.backward = staticmethod(timed)
        return self

    def __exit__(self, *exc):
        for fn_cls, orig in self._saved:
            fn_cls.backward = staticmethod(orig)
        return False


class PlainK6Calls:
    """Counts, while installed, the calls of K6's plain versions (the step,
    the forward loops, the backward loop) on CUDA tensors, wherever a
    module of the port holds them."""

    NAMES = ("slstm_step", "slstm_scan_ref", "slstm_scan_states_ref",
             "slstm_scan_bwd_ref")

    def __enter__(self):
        from repro_torch.kernels.slstm import ref
        self.calls = dict.fromkeys(self.NAMES, 0)
        self._saved = []
        for name in self.NAMES:
            orig = getattr(ref, name)

            def counted(*args, _orig=orig, _name=name):
                if args[0].is_cuda:
                    self.calls[_name] += 1
                return _orig(*args)

            for mod in list(sys.modules.values()):
                if (getattr(mod, "__name__", "").startswith("repro_torch")
                        and getattr(mod, name, None) is orig):
                    self._saved.append((mod, name, orig))
                    setattr(mod, name, counted)
        return self

    def __exit__(self, *exc):
        for mod, name, orig in self._saved:
            setattr(mod, name, orig)
        return False


def train_full_width(torch):
    """10.2: full width and depth, bf16, remat, AdamW with fp32 moments,
    through ``Trainer`` (the current GPU) and its synthetic pipeline: each
    step's synchronized wall, tokens/s, metrics, peak memory and kernel
    launches; the parameters move; then one warm starcoder2-3b step under
    the CPU-op guard (the batch drawn and moved beforehand)."""
    from repro_torch import kernels
    from repro_torch.configs import get
    from repro_torch.training import (AdamWConfig, DataConfig, TrainConfig,
                                      Trainer)
    for arch, seq, steps, wrappers in TRAIN_FULL:
        cfg = get(arch)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tr = Trainer(TrainConfig(
            model=cfg, opt=AdamWConfig(lr=3e-4, warmup_steps=20,
                                       total_steps=100),
            data=DataConfig(cfg.vocab_size, seq, 1, seed=SEED),
            n_steps=steps), seed=SEED)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        check(all(p.device.type == "cuda" for p in tr.net.parameters())
              and tr.device.type == "cuda", f"train {arch}: not on the card")
        emit({"train_init": arch, "dtype": cfg.dtype, "layers": cfg.n_layers,
              "params": sum(p.numel() for p in tr.net.parameters()),
              "remat": cfg.remat, "init_s": init_s,
              "max_memory_allocated_init": torch.cuda.max_memory_allocated()})
        name0, p0 = next(iter(tr.net.named_parameters()))
        before = p0.detach().clone()
        for step in range(steps):
            batch = tr.batch_at(step)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            counts0 = kernels.launches()
            with TwinTimer() as twins, PlainK6Calls() as plain_k6:
                t0 = time.perf_counter()
                metrics = tr.train_step(batch)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            counts = launches_since(counts0)
            out = {k: float(v) for k, v in metrics.items()}
            emit({"train_step": arch, "step": step,
                  "run": "cold" if step == 0 else "warm", "tokens": seq,
                  "wall_s": wall, "tokens_per_s": seq / wall, **out,
                  "max_memory_allocated": torch.cuda.max_memory_allocated(),
                  "launches": counts,
                  "site_backward_s": {
                      "K5 (SSMScan: the twin)": twins.s["SSMScan"],
                      "K6 (SLSTMScan: its backward kernel)":
                          twins.s["SLSTMScan"]},
                  "site_timer_note": "synchronized around each backward: "
                                     "the wall above carries those syncs",
                  "k6_plain_calls_on_cuda": plain_k6.calls})
            check(all(math.isfinite(v) for v in out.values()),
                  f"train {arch} step {step}: non-finite metrics {out}")
            check(not any(plain_k6.calls.values()), f"train {arch} step "
                  f"{step}: K6's plain versions ran on the card "
                  f"{plain_k6.calls}")
            for wrapper in wrappers:
                check(counts[wrapper] > 0, f"train {arch} step {step}: "
                      f"{wrapper} never launched")
        moved = float((p0.detach().float() - before.float()).abs().max())
        emit({"train_params_moved": arch, "param": name0,
              "max_abs_change": moved})
        check(moved > 0, f"train {arch}: the parameters did not change")
        if arch == "starcoder2-3b":
            batch = tr.batch_at(steps)
            torch.cuda.synchronize()
            guard = cpu_op_guard(torch)
            t0 = time.perf_counter()
            with guard:
                metrics = tr.train_step(batch)
                torch.cuda.synchronize()
            emit({"train_guarded_step": arch, "step": steps,
                  "wall_s": time.perf_counter() - t0,
                  "loss": float(metrics["loss"]),
                  "cpu_ops": dict(guard.ops),
                  "cpu_op_count": sum(guard.ops.values())})
            check(not guard.ops, f"train {arch}: operations ran on the CPU: "
                  f"{dict(guard.ops)}")
        del tr, before, p0
        torch.cuda.empty_cache()


def small_trainer(torch, directory=None, seed=SEED):
    """A ``Trainer`` of SMALL_TRAIN (fp32, no remat) on the card."""
    import dataclasses
    from repro_torch.training import (AdamWConfig, DataConfig, TrainConfig,
                                      Trainer)
    arch, changes, seq = SMALL_TRAIN
    cfg = dataclasses.replace(check_config(arch, "float32", changes),
                              remat=False)
    return Trainer(TrainConfig(
        model=cfg, opt=AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=20),
        data=DataConfig(cfg.vocab_size, seq, 1, seed=SEED),
        n_steps=2, checkpoint_dir=directory, checkpoint_every=100),
        seed=seed, device="cuda")


def loss_falls(torch):
    """10.3: five steps on one fixed batch; the last loss is below the
    first."""
    tr = small_trainer(torch)
    batch = tr.batch_at(0)
    losses = [float(tr.train_step(batch)["loss"]) for _ in range(5)]
    emit({"train_loss_falls": SMALL_TRAIN[0],
          "layers": tr.cfg.model.n_layers, "dtype": tr.cfg.model.dtype,
          "tokens": SMALL_TRAIN[2], "losses": losses})
    check(losses[-1] < losses[0], f"train: the loss did not fall: {losses}")
    del tr
    torch.cuda.empty_cache()


def restart_matches(torch):
    """10.4: ``Trainer.run`` checkpoints at step 2; a new Trainer (another
    seed) restores it; step 3 on each matches within 1e-5 relative (the
    embedding's backward adds with atomics, so not bitwise)."""
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        a = small_trainer(torch, d)
        report = a.run()
        b = small_trainer(torch, d, seed=SEED + 1)
        start = b.restore()
        check(report["steps"] == 2 and start == 2,
              f"restart: ran {report['steps']}, restored at {start}")
        ma = a.train_step(a.batch_at(2))
        mb = b.train_step(b.batch_at(2))
        loss_err = abs(float(ma["loss"]) - float(mb["loss"])) / abs(
            float(ma["loss"]))
        pb = dict(b.net.named_parameters())
        with torch.no_grad():
            err = max(float((p - pb[n]).abs().max()
                            / p.abs().max().clamp(min=1e-30))
                      for n, p in a.net.named_parameters())
        emit({"train_restart": SMALL_TRAIN[0], "checkpoint_step": 2,
              "restored_step": start, "loss_a": float(ma["loss"]),
              "loss_b": float(mb["loss"]), "loss_rel_err": loss_err,
              "param_max_rel_err": err, "tol": 1e-5})
        check(loss_err < 1e-5 and err < 1e-5,
              f"restart: step 3 differs (loss {loss_err:.3e}, params "
              f"{err:.3e})")
        del a, b
    torch.cuda.empty_cache()



# -- 11. the group backend: ranks as processes on the one card ---------------

# the worlds of §11 on cuda:0 (gloo): 11.1's 2D variants, 11.2 and 11.3's
# pings on 4 ranks; 11.1's 2.5D variants on 8; the contention shift on both
GROUP_WORLDS = {"2d": 4, "2.5d": 8}
#: 11.2's size, cut from N_MAIN for the script's time
N_GROUP = 8192
STAGED = "gloo, staged through pinned host memory"


def process_groups(torch, stacked):
    """§11; returns the launch counts of its path runs (11.1, 11.2), summed
    over every rank of every world."""
    from repro_torch import kernels
    from repro_torch.distributed import on_first_card, spawn
    from repro_torch.kernels import _build
    so = os.path.join(_build.BUILD_DIR, "repro_torch_kernels.so")
    built = os.stat(so).st_mtime_ns
    root = os.path.join(HERE, "build", "smoke_group")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    ranks = {}
    for kind, world in GROUP_WORLDS.items():
        ranks[kind] = spawn(group_rank, world, device_of_rank=on_first_card,
                            init_dir=os.path.join(root, kind), timeout_s=600,
                            args=(kind, os.path.join(root, f"plans_{kind}")))
    # §1 built the extension: the ranks load it and must not rebuild it
    check(os.stat(so).st_mtime_ns == built,
          "§11: a rank rebuilt the extension in build/torch_ext/")
    emit({"group_worlds": {kind: len(rs) for kind, rs in ranks.items()},
          "device": "cuda:0", "transport": STAGED,
          "load_s": {kind: [r["load_s"] for r in rs]
                     for kind, rs in ranks.items()},
          "spawn_s": time.perf_counter() - t0})
    totals = {name: 0 for name in kernels.launches()}
    for rs in ranks.values():
        for r in rs:
            for name, count in r["launches"].items():
                totals[name] += count
    group_variant_report(torch, ranks, stacked, STAGED)
    group_calls_report(torch, ranks["2d"])
    link_report(ranks)
    nccl_rows(torch, stacked)
    emit({"group_s": time.perf_counter() - t0, "launches": totals})
    return totals


def group_rank(rank, world, device, kind, plan_dir):
    """One rank of a §11 world: 11.1's forced variants of ``kind``; on the
    2D world also 11.2's model-guided calls, the Cannon overlap comparison
    and 11.3's Fig. 2 pings; on both 11.3's Figs. 3-4 contention.  Returns
    its results and its launches on the path runs (11.1, 11.2)."""
    import torch
    from repro_torch.benchmarks import fig2_alpha_beta, fig34_calibration
    from repro_torch.kernels import _build
    # settings do not cross a spawn: IEEE fp32 in this rank too
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.extension()
    out = {"load_s": time.perf_counter() - t0}
    totals = {}
    out["variants"] = group_variants(torch, rank, world, device, kind,
                                     totals)
    if kind == "2d":
        out["calls"] = group_calls(torch, rank, world, plan_dir, totals)
        out["overlap"] = cannon_overlap(torch, rank, world, plan_dir)
        out["fig2"] = {dev: fig2_alpha_beta.measure(rank, world, dev)
                       for dev in ("cuda", "cpu")}
    out["fig34"] = fig34_calibration.measure(rank, world, device)
    out["launches"] = totals
    return out


def add_counts(totals, counts):
    for name, count in counts.items():
        totals[name] = totals.get(name, 0) + count


def slowest(torch, values):
    """Each value as the slowest rank's (the group's maximum)."""
    import torch.distributed as dist
    t = torch.tensor(values, dtype=torch.float64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t.tolist()


def group_variants(torch, rank, world, device, kind, totals, only=None):
    """11.1 on one rank: each variant of ``kind`` (or of ``only``) forced
    through ``execute`` on the group, on §4's operands."""
    import torch.distributed as dist
    from repro_torch import kernels
    from repro_torch.linalg import ALGORITHMS
    from repro_torch.tuner.dispatch import execute
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    ops = {op: operands(torch, op, N_VARIANTS, gen)
           for op in ("matmul", "trsm", "cholesky")}
    out = {}
    for algo, variant in ALGORITHMS:
        if variant.startswith("2.5d") != (kind == "2.5d"):
            continue
        if only is not None and (algo, variant) not in only:
            continue
        op = "matmul" if algo in ("cannon", "summa") else algo
        plan = forced_plan(algo, variant, N_VARIANTS)
        torch.cuda.synchronize()
        kernels.reset_launches()
        got = execute(plan, *ops[op], devices=[device] * world,
                      group=dist.group.WORLD)
        torch.cuda.synchronize()
        counts = kernels.launches()
        add_counts(totals, counts)
        entry = {"launches": counts}
        if rank == 0:
            want = library_result(torch, op, ops[op])
            entry["lib_err"] = float((got - want).abs().max()
                                     / want.abs().max())
            entry["out"] = got.cpu().numpy()
        out[(algo, variant)] = entry
    del ops
    torch.cuda.empty_cache()
    return out


def group_variant_report(torch, ranks, stacked, transport):
    """11.1 / 11.4: each variant within 1e-4 of the library and 1e-6 of
    §4's stacked run (Cannon 2D and 2D_ovlp, which sum nothing, bitwise),
    its kernels launched in every rank."""
    for kind, rs in ranks.items():
        for (algo, variant), first in rs[0]["variants"].items():
            op = "matmul" if algo in ("cannon", "summa") else algo
            got = torch.from_numpy(first["out"])
            want = stacked[(algo, variant)]
            rel = float((got - want).abs().max() / want.abs().max())
            bitwise = bool(torch.equal(got, want))
            launches = [{k: v for k, v in r["variants"][(algo, variant)][
                "launches"].items() if v} for r in rs]
            emit({"group_variant": f"{algo} {variant}", "world": len(rs),
                  "transport": transport, "n": N_VARIANTS,
                  "lib_rel_err": first["lib_err"], "stacked_rel_err": rel,
                  "bitwise": bitwise, "launches": launches})
            what = f"§11 {algo} {variant} ({transport})"
            check(first["lib_err"] < 1e-4,
                  f"{what}: rel err {first['lib_err']:.3e} to the library")
            check(rel < 1e-6, f"{what}: rel err {rel:.3e} to the stacked run")
            if algo == "cannon" and variant in ("2d", "2d_ovlp"):
                check(bitwise, f"{what}: not bitwise the stacked run")
            for r, counts in zip(rs, launches):
                for name in PATH_KERNELS[op]:
                    check(counts.get(name, 0) > 0,
                          f"{what}: {name} never launched in a rank")


def group_calls(torch, rank, world, plan_dir, totals):
    """11.2 on one rank: ``linalg.matmul / trsm / cholesky`` at n = N_GROUP
    on the group, cold, then warm with ``observe=True`` (its phases)."""
    import torch.distributed as dist
    from repro_torch import kernels, linalg, telemetry
    from repro_torch.tuner import PlanCache, Tuner
    group = dist.group.WORLD
    store = telemetry.RunStore(os.path.join(plan_dir, f"runs{rank}"))
    tuner = Tuner(cache=PlanCache(os.path.join(plan_dir, f"plans{rank}")),
                  store=store)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    out = {}
    for op in ("matmul", "trsm", "cholesky"):
        args = operands(torch, op, N_GROUP, gen)
        walls = []
        for observe in (False, True):
            torch.cuda.synchronize()
            dist.barrier()
            kernels.reset_launches()
            t0 = time.perf_counter()
            res = getattr(linalg, op)(*args, tuner=tuner, group=group,
                                      observe=observe)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            add_counts(totals, kernels.launches())
        entry = {"walls": slowest(torch, walls),
                 "launches": {k: v for k, v in kernels.launches().items()
                              if v}}
        if rank == 0:
            entry["residual"] = residual(torch, op, args, res)
            plan = tuner.plan(op, N_GROUP, device_count=world,
                              platform="cuda",
                              device_kind=torch.cuda.get_device_name(0))
            entry["plan"] = plan.to_dict()
            rec = [r for r in store.load() if r.kind == "dispatch"][-1]
            entry["phases"] = dict(rec.phases)
            entry["meta"] = dict(rec.meta)
        out[op] = entry
        del args, res
        torch.cuda.empty_cache()
    return out


def cannon_overlap(torch, rank, world, plan_dir):
    """Cannon 2D against 2D_ovlp forced on the group at n = N_GROUP, in
    turns (2D, 2D_ovlp, 2D_ovlp, 2D), each observed: the paper's comparison
    with real communication."""
    import torch.distributed as dist
    from repro_torch import telemetry
    from repro_torch.tuner.dispatch import execute
    store = telemetry.RunStore(os.path.join(plan_dir, f"overlap{rank}"))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    a, b = operands(torch, "matmul", N_GROUP, gen)
    runs = []
    for variant in ("2d", "2d_ovlp", "2d_ovlp", "2d"):
        plan = forced_plan("cannon", variant, N_GROUP)
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        got = execute(plan, a, b, devices=[torch.device("cuda", 0)] * world,
                      group=dist.group.WORLD, observe=True, store=store)
        torch.cuda.synchronize()
        runs.append([variant, time.perf_counter() - t0])
    walls = slowest(torch, [w for _v, w in runs])
    out = {"runs": [[v, w] for (v, _w), w in zip(runs, walls)]}
    if rank == 0:
        want = torch.matmul(a, b)
        out["rel_err"] = float((got - want).abs().max() / want.abs().max())
        out["records"] = [{"variant": r.variant, "phases": dict(r.phases),
                           "comm_s": r.meta.get("comm_s")}
                          for r in store.load()]
    del a, b, got
    torch.cuda.empty_cache()
    return out


def group_calls_report(torch, rs):
    """11.2: the walls (the slowest rank's), the plan's prediction beside
    them, the observed phases and communication, and the same plan stacked
    on [cuda:0] * p; then Cannon 2D against 2D_ovlp."""
    from repro_torch.tuner.dispatch import execute
    from repro_torch.tuner.plan import ExecutionPlan
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    first = rs[0]["calls"]
    for op in ("matmul", "trsm", "cholesky"):
        args = operands(torch, op, N_GROUP, gen)
        e = first[op]
        plan = ExecutionPlan.from_dict(e["plan"])
        stacked = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = execute(plan, *args,
                          devices=[torch.device("cuda", 0)] * plan.p)
            torch.cuda.synchronize()
            stacked.append(time.perf_counter() - t0)
        stacked_res = residual(torch, op, args, out)
        emit({"group_call": op, "n": N_GROUP, "dtype": "float32",
              "world": len(rs), "transport": STAGED,
              "plan": plan_summary(plan),
              "wall_s": {"cold": e["walls"][0], "warm": e["walls"][1]},
              "predicted_over_warm": plan.predicted["total"] / e["walls"][1],
              "phases_s": e["phases"], "comm_s": e["meta"].get("comm_s"),
              "residual": e["residual"],
              "stacked_wall_s": {"cold": stacked[0], "warm": stacked[1]},
              "stacked_residual": stacked_res,
              "launches": [r["calls"][op]["launches"] for r in rs]})
        check(e["residual"] < 1e-4,
              f"§11 {op}: residual {e['residual']:.3e}")
        check(stacked_res < 1e-4,
              f"§11 {op} stacked: residual {stacked_res:.3e}")
        for r in rs:
            for name in PATH_KERNELS[op]:
                check(r["calls"][op]["launches"].get(name, 0) > 0,
                      f"§11 {op}: {name} never launched in a rank")
        del args, out
        torch.cuda.empty_cache()
    ov = rs[0]["overlap"]
    emit({"cannon_overlap": ov["runs"], "n": N_GROUP, "world": len(rs),
          "transport": STAGED, "records": ov["records"],
          "rel_err": ov["rel_err"]})
    check(ov["rel_err"] < 1e-4,
          f"§11 cannon overlap: rel err {ov['rel_err']:.3e}")


def link_report(ranks):
    """11.3: the Fig. 2 ping on cuda:0 (staged) and on the host with its
    fit, and each world's Figs. 3-4 contention factors (wall over
    L + beta words, the staged fit), as the benchmarks' ``measure`` gave
    them; every rank must hold the same."""
    from repro_torch.benchmarks.common import WORD_BYTES
    rs = ranks["2d"]
    for dev, transport in (("cuda", STAGED), ("cpu", "gloo, cpu tensors")):
        fig2 = rs[0]["fig2"][dev]
        check(all(r["fig2"][dev] == fig2 for r in rs),
              f"§11 ping ({dev}): ranks disagree")
        check(all(0.0 < t < 10.0 for t in fig2["ping"].values()),
              f"§11 ping ({dev}): {fig2['ping']}")
        emit({"fig2_alpha_beta": dev, "transport": transport,
              "world": len(rs), "word_bytes": WORD_BYTES, **fig2})
    for rs in ranks.values():
        fig34 = rs[0]["fig34"]
        check(all(r["fig34"] == fig34 for r in rs),
              f"§11 contention ({len(rs)} ranks): ranks disagree")
        walls = {d: f * fig34["ideal_s"]
                 for d, f in fig34["measured_factor_vs_distance"].items()}
        check(all(0.0 < w < 10.0 for w in walls.values()),
              f"§11 contention ({len(rs)} ranks): walls {walls}")
        emit({"fig34_calibration": len(rs), "transport": STAGED, **fig34})


def nccl_rank(rank, world, device):
    """11.4 on one rank: 11.1's Cannon and SUMMA 2D rows over NCCL."""
    import torch
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.extension()
    totals = {}
    return {"variants": group_variants(
        torch, rank, world, device, "2d", totals,
        only={("cannon", "2d"), ("summa", "2d")})}


def nccl_rows(torch, stacked):
    """11.4: with a card for each of a 2x2 grid's ranks, 11.1's Cannon and
    SUMMA 2D rows over NCCL (cuda:r a rank, no staging); else one line
    saying it was not run."""
    from repro_torch.distributed import card_per_rank, spawn
    count = torch.cuda.device_count()
    world = GROUP_WORLDS["2d"]
    if count < world:
        emit({"nccl": "not run", "device_count": count})
        return
    rs = spawn(nccl_rank, world, backend="nccl", device_of_rank=card_per_rank,
               init_dir=os.path.join(HERE, "build", "smoke_group", "nccl"),
               timeout_s=300)
    group_variant_report(torch, {"2d": rs}, stacked, "nccl, cuda tensors")


# -- 12. the benchmark harness on the card -----------------------------------

#: the benches of ``repro_torch.benchmarks.run`` that §12 runs on the card,
#: at ``run.CARD_SIZES``
HARNESS_BENCHES = ("fig5to8", "tuner", "serving", "obs", "kernels")
#: the kernels a fig5to8 variant must launch in every rank
FIG5TO8_KERNELS = {"cannon": ("matmul_cuda",), "summa": ("matmul_cuda",),
                   "trsm": PATH_KERNELS["trsm"],
                   "cholesky": PATH_KERNELS["cholesky"]}


def harness(torch, smi_line):
    """§12; returns the launch counts of its benches: this process's
    (tuner, serving, obs) and every fig5to8 rank's, summed."""
    import tempfile
    from repro_torch import kernels
    from repro_torch.benchmarks import run
    name, limit = smi_line.rsplit(",", 1)
    card = {"device": name.strip(),
            "power_limit_w": float(limit.strip().split()[0])}
    t0 = time.perf_counter()
    totals = {k: 0 for k in kernels.launches()}
    results = {}
    for bench in HARNESS_BENCHES:
        torch.cuda.synchronize()
        kernels.reset_launches()
        t = time.perf_counter()
        results[bench] = run.run_bench(bench, "cuda")
        torch.cuda.synchronize()
        add_counts(totals, kernels.launches())
        if bench == "kernels":
            kernels_tiles = dict(kernels.matmul_cuda.launches_by_tile)
            add_counts(TILE_LAUNCHES, kernels_tiles)
        emit({"harness": bench, "wall_s": time.perf_counter() - t,
              "sizes": run.CARD_SIZES.get(bench, {})})
        meta = results[bench].get("_meta", {})
        check({k: meta.get(k) for k in card} == card,
              f"§12 {bench}: _meta names {meta.get('device')!r}, "
              f"{meta.get('power_limit_w')!r}, not {card}")
    fig = results["fig5to8"]
    for r in fig5to8_report(fig):
        add_counts(totals, r)
    tuner_report(results["tuner"])
    serving_report(results["serving"])
    obs_report(results["obs"])
    kernels_report(results["kernels"], kernels_tiles)
    with tempfile.TemporaryDirectory() as hist:
        env = dict(os.environ, REPRO_TORCH_BENCH_HISTORY_DIR=hist,
                   PYTHONPATH=os.path.join(HERE, "src"))
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.benchmarks.run",
             "--check-regressions"], cwd=HERE, env=env, capture_output=True,
            text=True, timeout=300)
    emit({"check_regressions_rc": out.returncode,
          "tail": out.stdout.strip().splitlines()[-1:]})
    check(out.returncode == 0, "§12 --check-regressions on an empty history "
          f"exited {out.returncode}: {out.stderr[-2000:]}")
    emit({"harness_s": time.perf_counter() - t0, "launches": totals})
    return totals


def fig5to8_report(fig):
    """§12's Figs. 5-8 table; every residual < 1e-4, each variant's
    kernels launched in every rank.  Returns each rank's launches, summed
    over the routine benchmark and the variants."""
    ranks = [dict(counts) for counts in fig["calibration_launches"]]
    emit({"fig5to8": "routine benchmark",
          "launches": fig["calibration_launches"]})
    for key, row in fig["results"].items():
        algo = key.split("_", 1)[0]
        emit({"fig5to8": key, "n": fig["n"], "p": fig["p"],
              "transport": fig["transport"],
              **{k: row[k] for k in ("measured_s", "est_cal_s",
                                     "est_nocal_s", "cal_rel_err",
                                     "nocal_rel_err", "rel_residual")},
              "launches": row["launches"]})
        check(row["rel_residual"] < 1e-4,
              f"§12 fig5to8 {key}: rel residual {row['rel_residual']:.3e}")
        for r, counts in enumerate(row["launches"]):
            add_counts(ranks[r], counts)
            for kernel in FIG5TO8_KERNELS[algo]:
                check(counts.get(kernel, 0) > 0,
                      f"§12 fig5to8 {key}: {kernel} never launched in "
                      f"rank {r}")
    emit({"fig5to8": "summary", "geomean_rel_err_cal":
          fig["geomean_rel_err_cal"], "geomean_rel_err_nocal":
          fig["geomean_rel_err_nocal"], "latency_s": fig["latency_s"],
          "beta": fig["beta"], "machine_peak_per_unit":
          fig["machine_peak_per_unit"], "measured_factors":
          fig["measured_factors"], "compute_curves": fig["compute_curves"],
          "launches_by_rank": ranks})
    return ranks


def tuner_report(res):
    """The tuner bench returns only when its disk hit made no model
    evaluation; its overheads are reported."""
    emit({"tuner": {k: v for k, v in res.items()
                    if k not in ("model_eval", "_meta")},
          "model_eval": {k: res["model_eval"][k]
                         for k in ("scenarios", "min_speedup",
                                   "geomean_speedup")}})
    check(res["model_eval"]["scenarios"] >= 200,
          "§12 tuner: fewer than 200 scenarios")


def serving_report(res):
    """Phase A's records and post-refit error (reported), Phase B's gates
    and the re-key (gated)."""
    cal, gates = res["calibration"], res["gates"]
    emit({"serving": {k: v for k, v in cal.items() if k != "refit"},
          "gates": gates, "replay": {k: v for k, v in res["replay"].items()
                                     if not isinstance(v, dict)}})
    check(cal["serve_step_records"] > 0, "§12 serving: no serve_step record")
    for gate in ("model_goodput_ge_fifo", "model_beats_fifo_p95_ttft",
                 "rekey_ok"):
        check(gates[gate], f"§12 serving: {gate} fails")


def kernels_report(res, by_tile):
    """The kernel-tier sweep against the reference CI's gates (.github/
    workflows/ci.yml): the chosen tile no slower than the default, the
    refit a new revision that moved a constant; and at least four of K1's
    CTA tiles timed, each launched in the sweep."""
    refit = res["refit"]
    tiles = {tuple(row["cta_tile"]) for row in res["sweep"]}
    emit({"kernels": {k: v for k, v in res.items() if k != "_meta"},
          "launches_by_tile": {f"{t[0]}x{t[1]}": c
                               for t, c in by_tile.items()}})
    check(res["tuned_over_default"] >= 1.0,
          f"§12 kernels: tuned_over_default {res['tuned_over_default']}")
    check(refit["revision"] >= 1, f"§12 kernels: refit revision {refit}")
    check(refit["overhead_factor"][0] != refit["overhead_factor"][1]
          or refit["loop_overhead"][0] != refit["loop_overhead"][1],
          f"§12 kernels: the refit moved no constant: {refit}")
    check(len(tiles) >= 4, f"§12 kernels: {len(tiles)} CTA tiles timed")
    check(all(by_tile.get(t, 0) > 0 for t in tiles),
          f"§12 kernels: a swept tile never launched: {by_tile}")


def obs_report(res):
    emit({"obs": {k: v for k, v in res.items() if k != "_meta"}})
    check(res["serving_trace_flow_events"] > 0,
          "§12 obs: no flow event in the paired serving trace")



# -- 13. sharded training: a mesh of gloo ranks on cuda:0 ---------------------

SHARD_ARCH = "starcoder2-3b"
#: 13.1's meshes: the tensor-parallel path (KV 2 -> 1 a rank), and the
#: gather path for the KV leaves (2 KV heads over model = 4)
SHARD_EXACT = ((1, 2, 2), (1, 1, 4))
#: 13.1's and 13.2's sequence (above the 2048 at which attention takes
#: K4) and global batch
SHARD_SEQ, SHARD_BATCH = 2304, 2
#: AdamW's eps in 13.1: at step 1 Adam moves a parameter by about
#: lr * g / (|g| + eps); with 1e-8 a gradient within 1e-8 of zero, where the
#: ranks' sums add in another order, would move it by anything up to lr
SHARD_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10, eps=1e-3)
SHARD_LOSS_TOL, SHARD_PARAM_TOL = 1e-5, 1e-4
#: 13.2: bf16 at full width on (1, 2, 2), remat, AdamW, at most this many
#: layers (the script's time: 28 layers took 32 s cold and 22 s warm, 8
#: layers 15.7 and 5.9, 4 layers 19.1 and 6.9)
SHARD_PATH_MESH = (1, 2, 2)
SHARD_PATH_MAX_LAYERS = 2
SHARD_PATH_OPT = dict(lr=3e-4, warmup_steps=20, total_steps=100)
#: 13.3's mesh
SHARD_POD_MESH = (2, 1, 2)
#: 13.1 to 13.3 run in one world of this many ranks
SHARD_WORLD = 4
#: the card's memory, and what 13.2's depth leaves aside for the main
#: process and the allocators' slack
CARD_BYTES, CARD_RESERVE = 80e9, 10e9


class PlainK4Calls:
    """Counts, while installed, the calls of K4's plain version on CUDA
    tensors, wherever a module of the port holds it."""

    def __enter__(self):
        from repro_torch.kernels.flash_attention import ref
        orig, self.calls, self._saved = ref.flash_attention_ref, 0, []

        def counted(q, *args, **kw):
            if q.is_cuda:
                self.calls += 1
            return orig(q, *args, **kw)

        for mod in list(sys.modules.values()):
            if (getattr(mod, "__name__", "").startswith("repro_torch")
                    and getattr(mod, "flash_attention_ref", None) is orig):
                self._saved.append(mod)
                mod.flash_attention_ref = counted
        self._orig = orig
        return self

    def __exit__(self, *exc):
        for mod in self._saved:
            mod.flash_attention_ref = self._orig
        return False


def shard_config(dtype, layers, remat=None):
    """SHARD_ARCH at full width in ``dtype`` with ``layers`` layers (and
    ``remat`` where given)."""
    changes = {"n_layers": layers}
    if remat is not None:
        changes["remat"] = remat
    return check_config(SHARD_ARCH, dtype, changes)


def shard_batch(cfg, seq, rows=SHARD_BATCH):
    """``rows`` rows of tokens and next-token labels, and the stub inputs
    the arch takes (whisper's frames), drawn with numpy."""
    import numpy as np
    from repro_torch.launch.prefill import stub_shapes
    rng = np.random.default_rng(SEED + 13)
    tok = rng.integers(0, cfg.vocab_size, (rows, seq + 1)).astype(np.int32)
    out = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    for name, shape in stub_shapes(cfg).items():
        out[name] = (rng.standard_normal((rows,) + shape) * 0.1).astype(
            np.float32)
    return out


def shard_trainer(cfg, seq, opt, mesh=None, device="cuda",
                  rows=SHARD_BATCH):
    from repro_torch.training import (AdamWConfig, DataConfig, TrainConfig,
                                      Trainer)
    return Trainer(TrainConfig(
        model=cfg, opt=AdamWConfig(**opt),
        data=DataConfig(cfg.vocab_size, seq, rows, seed=SEED),
        n_steps=2), mesh=mesh, seed=SEED, device=device)


def rank_bytes(cfg, mesh_shape, seq):
    """The bytes one rank of a ``mesh_shape`` world holds at its peak in
    a bf16 AdamW step (fp32 moments) of ``cfg`` at ``seq``: its blocks of
    the parameters and gradients (2 bytes) and its ZeRO-1 slices of the
    two moments (8 bytes), which live through the step, then the larger
    of what the backward and the update add (the update runs after the
    activations are freed): the activations of remat (each unit's input,
    one unit's intermediates, one logits chunk and the gathered
    vocabulary leaves), or the optimizer's stacked copies of its largest
    leaf (parameter and gradient) with its fp32 temporaries and the
    gradient average's fp32 bucket; 1 GB for the context and workspaces.
    Computed from the leaves' specs on a network built on the meta
    device."""
    from repro_torch.distributed.sharding import (Mesh, block_shape,
                                                  leaf_spec, leaf_zero_spec)
    from repro_torch.models import transformer as tf
    from repro_torch.models.convert import reference_leaves
    pods, data, model = mesh_shape
    shape = ({"pod": pods, "data": data, "model": model} if pods > 1
             else {"data": data, "model": model})
    mesh = Mesh(shape)
    net = tf.Decoder(cfg, device="meta")
    params = dict(net.named_parameters())
    p_el = z_el = biggest = 0
    for path, leaf in reference_leaves(net).items():
        full = ((len(leaf.names),) if leaf.stacked else ()) + tuple(
            params[leaf.names[0]].shape)
        blk = math.prod(block_shape(full, leaf_spec(path, full, mesh), mesh))
        p_el += blk
        z_el += math.prod(block_shape(full, leaf_zero_spec(path, full, mesh),
                                      mesh))
        biggest = max(biggest, blk)
    rows = SHARD_BATCH // (pods * data)
    d, v = cfg.d_model, cfg.vocab_size
    act = (cfg.n_layers * rows * seq * d * 2
           + 24 * rows * seq * max(d, cfg.d_ff // model) * 4
           + 3 * rows * min(cfg.logits_chunk or seq, seq) * v * 4
           + 2 * v * d * 2)
    opt = 2 * biggest * 2 + 6 * (1 << 26) * 4 + 2 * (1 << 26) * 4
    return {"params": 2 * p_el, "grads": 2 * p_el, "moments": 8 * z_el,
            "optimizer": opt, "activations": act, "context": int(1e9),
            "total": 4 * p_el + 8 * z_el + max(opt, act) + int(1e9)}


def shard_path_depth(seq):
    """13.2's depth: the most layers (up to SHARD_PATH_MAX_LAYERS) at
    which four ranks' ``rank_bytes`` fit the card beside CARD_RESERVE."""
    from repro_torch.configs import get
    full = min(get(SHARD_ARCH).n_layers, SHARD_PATH_MAX_LAYERS)
    world = math.prod(SHARD_PATH_MESH)
    for layers in range(full, 0, -1):
        est = rank_bytes(shard_config("bfloat16", layers), SHARD_PATH_MESH,
                         seq)
        if world * est["total"] + CARD_RESERVE <= CARD_BYTES:
            return layers, est
    raise SmokeFailure("§13.2: not one layer fits four ranks on the card")


def sharded_training(torch):
    """§13; returns the launch counts of its path runs (every rank of
    13.1 and 13.2), summed."""
    from repro_torch import kernels
    from repro_torch.distributed import on_first_card, spawn
    from repro_torch.kernels import _build
    so = os.path.join(_build.BUILD_DIR, "repro_torch_kernels.so")
    built = os.stat(so).st_mtime_ns
    root = os.path.join(HERE, "build", "smoke_shard")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    t_start = time.perf_counter()
    launcher = shard_launcher_start(root)
    try:
        layers, est, whole_walls, whole_peak = path_unsharded(torch)
        want_losses, want_file = exact_unsharded(torch, root, grads=True)
        ep_losses, ep_file = exact_unsharded(torch, root, ep_config(),
                                             "ep_want.pt")
        decode_file = decode_unsharded(torch, root)
        profiles_unsharded(torch, root)
    except BaseException:
        launcher[0].kill()
        launcher[0].wait()
        raise
    shard_launcher_finish(*launcher)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    emit({"shard_parent_before_world": {
        "memory_allocated": torch.cuda.memory_allocated(),
        "memory_reserved": torch.cuda.memory_reserved()}})
    t0 = time.perf_counter()
    # the ranks' allocators grow their segments in place: four ranks fill
    # the card, and with fixed segments 13.2 left 5.25 GB a rank reserved
    # but unallocated (H100 80GB)
    saved = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        rs = spawn(shard_rank, SHARD_WORLD, device_of_rank=on_first_card,
                   init_dir=os.path.join(root, "world"), timeout_s=900,
                   args=(want_file, layers, ep_file, decode_file, root))
    finally:
        if saved is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = saved
    world_s = time.perf_counter() - t0
    totals = {name: 0 for name in kernels.launches()}
    add_counts(totals, path_report([r["path"] for r in rs], layers, est,
                                   whole_walls, whole_peak))
    for shape in SHARD_EXACT:
        add_counts(totals, exact_report(
            [r["exact"][shape] for r in rs], shape, want_losses))
    pods_report([r["pods"] for r in rs])
    for shape in EP_MESHES:
        add_counts(totals, ep_report([r["ep"][shape] for r in rs], shape,
                                     ep_losses))
    add_counts(totals, arctic_report([r["arctic"] for r in rs]))
    decode_report([r["decode"] for r in rs])
    add_counts(totals, profiles_report([r["profiles"] for r in rs], root))
    add_counts(totals, profiles_report([r["heads"] for r in rs], root,
                                       HEAD_RUNS, "13.8"))
    check(os.stat(so).st_mtime_ns == built,
          "§13: a rank rebuilt the extension in build/torch_ext/")
    emit({"sharded_s": time.perf_counter() - t_start, "world_s": world_s,
          "launches": totals})
    return totals


def exact_unsharded(torch, root, cfg=None, name="exact_want.pt",
                    seq=SHARD_SEQ, rows=SHARD_BATCH, grads=False):
    """13.1's (13.5's, with ``cfg``; 13.7's) reference: two unsharded fp32
    steps on the card, on ``rows`` rows of ``seq`` tokens (with
    ``grads``, the first one's gradients kept).  Returns the losses and
    the file that holds the whole parameters after them (``{"params":
    {leaf path: fp32 tensor}, "scale": {leaf path: its largest
    magnitude}}``, and ``"grads"``, ``"grad_scale"`` alike), which each
    rank reads in place."""
    cfg = cfg or shard_config("float32", 2)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in shard_batch(cfg, seq, rows).items()}
    tr = shard_trainer(cfg, seq, SHARD_OPT, rows=rows)
    kept = {}
    with RoutingLog() as routing:
        if grads:
            loss, whole = first_step(tr, batch)
            kept["grads"] = {p: torch.from_numpy(v.copy())
                             for p, v in whole.items()}
            kept["grad_scale"] = grad_scales(kept["grads"])
            losses = [loss, float(tr.train_step(batch)["loss"])]
        else:
            losses = [float(tr.train_step(batch)["loss"]) for _ in range(2)]
    want = {p: torch.from_numpy(v.copy())
            for p, v in tr._whole_leaves()[0].items()}
    del tr
    path = os.path.join(root, name)
    torch.save({"params": want,
                "scale": {p: float(w.abs().max()) for p, w in want.items()},
                "routing": [idx for idx, _ in routing.calls], **kept}, path)
    with open(path + ".losses.json", "w") as f:
        json.dump(losses, f)
    return losses, path


def path_unsharded(torch):
    """13.2's reference: the unsharded bf16 run on the card at 13.2's
    depth (``shard_path_depth``), a cold and a warm step.  Returns (the
    depth, the per-rank estimate, the step walls, the peak memory)."""
    layers, est = shard_path_depth(SHARD_SEQ)
    tr = shard_trainer(shard_config("bfloat16", layers, remat=True),
                       SHARD_SEQ, SHARD_PATH_OPT)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for step in range(2):
        batch = tr.batch_at(step)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.train_step(batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    del tr, batch
    emit({"shard_path_unsharded": SHARD_ARCH, "layers": layers,
          "seq": SHARD_SEQ, "batch": SHARD_BATCH, "step_wall_s": walls,
          "max_memory_allocated": peak})
    return layers, est, walls, peak


def check_k4(rs, tag, family):
    """K4 launched in every rank of ``rs``, every launch on a body of
    ``family`` (:func:`on_body`), its plain version on no CUDA tensor;
    returns the ranks' launches summed."""
    totals = {}
    emit({"k4_bodies": tag, "by_rank": [r["k4_by_body"] for r in rs]})
    for rank, r in enumerate(rs):
        check(r["on_card"], f"{tag}: a rank's tensors left the card")
        check(r["launches"]["flash_attention_cuda"] > 0,
              f"{tag}: K4 never launched in rank {rank}")
        k4 = r["launches"]["flash_attention_cuda"]
        check(k4_bodies_are(r["k4_by_body"], k4, family), f"{tag}: K4 "
              f"bodies {r['k4_by_body']} in rank {rank}, not {family} "
              "alone")
        add_counts(K4_BODY_LAUNCHES, r["k4_by_body"])
        check(r["k4_plain"] == 0, f"{tag}: K4's plain version ran on the "
              f"card in rank {rank}")
        add_counts(totals, r["launches"])
    return totals


def exact_report(rs, shape, want_losses):
    """13.1's gates on one mesh's ranks: loss within SHARD_LOSS_TOL
    relative, every rank's block of every parameter within
    SHARD_PARAM_TOL of the whole parameter's largest entry, K4."""
    tag = "x".join(map(str, shape))
    errs = {}
    for r in rs:
        for p, e in r["errs"].items():
            errs[p] = max(errs.get(p, 0.0), e)
    worst = max(errs, key=errs.get)
    loss_err = max(abs(l - w) / abs(w) for r in rs
                   for l, w in zip(r["losses"], want_losses))
    emit({"shard_exact": tag, "world": len(rs), "losses": rs[0]["losses"],
          "unsharded_losses": want_losses, "loss_rel_err": loss_err,
          "param_rel_err_max": errs[worst], "param_worst": worst,
          "k4_launches_by_rank": [r["launches"]["flash_attention_cuda"]
                                  for r in rs],
          "k4_plain_on_cuda_by_rank": [r["k4_plain"] for r in rs],
          "tp_modules": rs[0]["tp"], "init_s": rs[0]["init_s"],
          "step_wall_s_slowest": [max(r["step_wall_s"][i] for r in rs)
                                  for i in range(2)],
          "collectives_rank0": rs[0]["collectives"],
          "compare_s": rs[0]["compare_s"]})
    check(loss_err < SHARD_LOSS_TOL,
          f"§13.1 {tag}: loss rel err {loss_err:.3e}")
    check(errs[worst] < SHARD_PARAM_TOL,
          f"§13.1 {tag}: {worst} rel err {errs[worst]:.3e}")
    check(all(r["leaves_match"] for r in rs), f"§13.1 {tag}: leaves differ")
    return check_k4(rs, f"§13.1 {tag}", "fp32")


def path_report(rs, layers, est, whole_walls, whole_peak):
    """13.2's report (step walls, peaks, collectives) and gates: finite
    losses, K4, each rank's peak below the unsharded run's."""
    peaks = [r["peak"] for r in rs]
    emit({"shard_path": SHARD_ARCH, "mesh": SHARD_PATH_MESH,
          "layers": layers, "seq": SHARD_SEQ, "batch": SHARD_BATCH,
          "estimate_per_rank": est,
          "step_wall_s_slowest": [max(r["walls"][i] for r in rs)
                                  for i in range(len(rs[0]["walls"]))],
          "step_wall_s_by_rank": [r["walls"] for r in rs],
          "unsharded_step_wall_s": whole_walls,
          "peak_by_rank": peaks, "unsharded_peak": whole_peak,
          "peak_reserved_by_rank": [r["peak_reserved"] for r in rs],
          "collectives_by_step_rank0": rs[0]["stats"],
          "k4_launches_by_rank": [r["launches"]["flash_attention_cuda"]
                                  for r in rs],
          "k4_plain_on_cuda_by_rank": [r["k4_plain"] for r in rs],
          "losses": rs[0]["losses"], "init_s": [r["init_s"] for r in rs]})
    for r in rs:
        check(all(math.isfinite(x) for x in r["losses"]),
              f"§13.2: non-finite loss {r['losses']}")
    check(max(peaks) < whole_peak, f"§13.2: a rank's peak {max(peaks)} is "
          f"not below the unsharded run's {whole_peak}")
    return check_k4(rs, "§13.2", "bf16_wgmma")


def pods_report(rs):
    """13.3's gates: ``compress_pod_mean`` over SHARD_POD_MESH on the
    card, each pod with a gradient of its own, against the CPU on the
    same inputs: the quantizer bitwise on every pod's input, the mean
    over the gathered payloads and the new error within 1e-6."""
    r = rs[0]
    emit({"shard_pods": SHARD_POD_MESH,
          "quantizer_bitwise": r["quantizer_bitwise"],
          "mean_err": max(x["mean_err"] for x in rs),
          "err_err": max(x["err_err"] for x in rs)})
    check(all(x["quantizer_bitwise"] for x in rs), "§13.3: the card's int8 "
          "quantization differs from the CPU's")
    check(max(x["mean_err"] for x in rs) <= 1e-6,
          f"§13.3: mean err {r['mean_err']:.3e}")
    check(max(x["err_err"] for x in rs) <= 1e-6,
          f"§13.3: new error err {r['err_err']:.3e}")


#: seconds §13.4's launcher may run
LAUNCHER_TIMEOUT_S = 300


def shard_launcher_start(root):
    """13.4: starts ``launch/train.py --smoke --mesh 1,2,2 --steps 3`` as a
    subprocess on the card (4 gloo ranks on cuda:0), its output to files
    under ``root``; returns (process, start time, stdout path, stderr
    path)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(HERE, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    out, err = (os.path.join(root, f"launcher.{k}") for k in ("out", "err"))
    t0 = time.perf_counter()
    with open(out, "w") as fo, open(err, "w") as fe:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch",
             "qwen1.5-4b", "--smoke", "--mesh", "1,2,2", "--steps", "3"],
            cwd=HERE, env=env, stdout=fo, stderr=fe)
    return proc, t0, out, err


def shard_launcher_finish(proc, t0, out, err):
    """13.4's gate: exit 0 and ``steps=3 restarts=0``."""
    try:
        proc.wait(timeout=max(1.0, LAUNCHER_TIMEOUT_S
                              - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    with open(out) as f:
        lines = f.read().strip().splitlines()
    with open(err) as f:
        stderr = f.read()
    emit({"shard_launcher": "qwen1.5-4b --smoke --mesh 1,2,2 --steps 3",
          "returncode": proc.returncode, "last": lines[-2:],
          "wall_s": time.perf_counter() - t0})
    check(proc.returncode == 0 and lines and lines[-1] == "steps=3 restarts=0",
          f"§13.4: the launcher failed: {stderr[-2000:]}")


def shard_rank(rank, world, device, want_file, layers, ep_file,
               decode_file, root):
    """One rank of §13's world: 13.2 (first, on a fresh allocator: it
    fills the card), 13.1 on each SHARD_EXACT mesh, 13.3, 13.5 on each
    EP_MESHES mesh and arctic-480b's forward, 13.6, then 13.7 and 13.8,
    each on a mesh of its own over the world."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.extension()
    out = {"path": shard_rank_path(torch, make_mesh(*SHARD_PATH_MESH),
                                   layers), "exact": {}}
    gc.collect()
    torch.cuda.empty_cache()
    for shape in SHARD_EXACT:
        out["exact"][shape] = shard_rank_exact(torch, make_mesh(*shape),
                                               want_file)
        gc.collect()
        torch.cuda.empty_cache()
    out["pods"] = shard_rank_pods(torch, make_mesh(*SHARD_POD_MESH))
    out["ep"] = {}
    for shape in EP_MESHES:
        gc.collect()
        torch.cuda.empty_cache()
        out["ep"][shape] = shard_rank_exact(torch, make_mesh(*shape),
                                            ep_file, ep_config())
    gc.collect()
    torch.cuda.empty_cache()
    out["arctic"] = arctic_rank(torch, make_mesh(*ARCTIC_MESH))
    gc.collect()
    torch.cuda.empty_cache()
    out["decode"] = decode_rank(torch, make_mesh(*DECODE_MESH), decode_file)
    gc.collect()
    torch.cuda.empty_cache()
    meshes = {shape: make_mesh(*shape) for shape in sorted(
        {run[1] for run in PROFILE_RUNS + HEAD_RUNS})}
    out["profiles"] = profile_rank(torch, meshes, root, PROFILE_RUNS)
    out["heads"] = profile_rank(torch, meshes, root, HEAD_RUNS)
    return out


def on_card(tr) -> bool:
    """Every parameter and moment of the trainer on the card."""
    ts = list(tr.net.parameters())
    for tree in (tr.opt_state.mu, tr.opt_state.nu):
        ts += list((tree or {}).values())
    return all(t.is_cuda for t in ts)


def block_errors(torch, tr, want_file):
    """Each leaf's error in this rank's block of it against the same
    block of the unsharded run's (read in place from ``want_file``),
    relative to the whole leaf's largest magnitude; and whether the leaf
    paths match."""
    from repro_torch.distributed.sharding import shard_of
    from repro_torch.models.convert import reference_leaves
    want = torch.load(want_file, mmap=True)
    named = dict(tr.net.named_parameters())
    errs = {}
    for path, leaf in reference_leaves(tr.net).items():
        rows = [named[n].detach() for n in leaf.names]
        got = torch.stack(rows) if leaf.stacked else rows[0]
        w = shard_of(want["params"][path], tr.layout.specs[path], tr.mesh)
        errs[path] = (float((got - w.to(got.device)).abs().max())
                      / max(want["scale"][path], 1e-30))
    return errs, set(errs) == set(want["params"])


def shard_rank_exact(torch, mesh, want_file, cfg=None):
    """13.1's (13.5's, with ``cfg``) rank: two steps on ``mesh`` against
    the unsharded run's parameters in ``want_file``; the shapes of the
    all-gathers over ``model`` and the expert banks' blocks and modes."""
    from repro_torch import kernels
    from repro_torch.distributed import (collective_stats,
                                         reset_collective_stats)
    cfg = cfg or shard_config("float32", 2)
    batch = shard_batch(cfg, SHARD_SEQ)
    t0 = time.perf_counter()
    tr = shard_trainer(cfg, SHARD_SEQ, SHARD_OPT, mesh=mesh)
    rows = {k: torch.from_numpy(v).cuda() for k, v in tr.rows(batch).items()}
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    kernels.reset_launches()
    reset_collective_stats()
    losses, walls = [], []
    with PlainK4Calls() as plain, ModelGathers(mesh) as gathers, \
            RoutingLog() as routing:
        for _ in range(2):
            t0 = time.perf_counter()
            losses.append(float(tr.train_step(rows)["loss"]))
            walls.append(time.perf_counter() - t0)
    counts = kernels.launches()
    bodies = dict(kernels.flash_attention_cuda.launches_by_body)
    stats = collective_stats()
    t0 = time.perf_counter()
    errs, leaves_match = block_errors(torch, tr, want_file)
    # the routing of the rank's groups (forward and recompute, by layer)
    # against the unsharded run's same groups
    want_routing = torch.load(want_file, mmap=True)["routing"]
    flips = []
    for (idx, _), whole in zip(routing.calls, want_routing):
        g0 = mesh.axis_index(mesh.batch_axes) * idx.shape[0]
        flips.append(int((idx != whole[g0:g0 + idx.shape[0]]).any(-1).sum()))
    banks = {n: (p.placement.mode if hasattr(p, "placement") else None,
                 tuple(p.shape)) for n, p in tr.net.named_parameters()
             if n.rsplit(".", 1)[-1] in ("w_up", "w_gate", "w_down")}
    return {"losses": losses, "launches": counts, "k4_plain": plain.calls,
            "k4_by_body": bodies, "on_card": on_card(tr),
            "init_s": init_s, "step_wall_s": walls,
            "collectives": stats, "errs": errs, "leaves_match": leaves_match,
            "compare_s": time.perf_counter() - t0,
            "model_gathers": gathers.shapes, "banks": banks,
            "routing_flips": flips,
            "tp": sorted(n for n, m in tr.net.named_modules()
                         if getattr(m, "tp", None) is not None)}


def shard_rank_path(torch, mesh, layers):
    from repro_torch import kernels
    from repro_torch.distributed import (collective_stats,
                                         reset_collective_stats)
    cfg = shard_config("bfloat16", layers, remat=True)
    t0 = time.perf_counter()
    tr = shard_trainer(cfg, SHARD_SEQ, SHARD_PATH_OPT, mesh=mesh)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    walls, stats, losses = [], [], []
    with PlainK4Calls() as plain:
        for step in range(2):
            batch = tr.batch_at(step)
            torch.cuda.synchronize()
            reset_collective_stats()
            t0 = time.perf_counter()
            m = tr.train_step(batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            stats.append(collective_stats())
            losses.append(float(m["loss"]))
    return {"walls": walls, "stats": stats, "losses": losses,
            "peak": torch.cuda.max_memory_allocated(),
            "peak_reserved": torch.cuda.max_memory_reserved(),
            "init_s": init_s,
            "launches": kernels.launches(), "k4_plain": plain.calls,
            "k4_by_body": dict(kernels.flash_attention_cuda.launches_by_body),
            "on_card": on_card(tr)}


def shard_rank_pods(torch, mesh):
    import numpy as np
    from repro_torch.training import compression
    rng = np.random.default_rng(SEED + 17)
    g = rng.standard_normal((3072, 1024)).astype(np.float32)
    e = (rng.standard_normal(g.shape) * 1e-3).astype(np.float32)
    pod = mesh.coords["pod"]
    mine = g * (1 + pod)
    mg, ne = compression.compress_pod_mean(
        {"w": torch.from_numpy(mine).cuda()}, {"w": torch.from_numpy(e).cuda()},
        mesh)
    want, bitwise = 0.0, True
    for p in range(mesh.shape["pod"]):
        x = torch.from_numpy(g * (1 + p) + e)
        q, s = compression._quantize(x)
        qc, _ = compression._quantize(x.cuda())
        bitwise = bitwise and torch.equal(qc.cpu(), q)
        want = want + compression._dequantize(q, s)
        if p == pod:
            want_err = x - compression._dequantize(q, s)
    want = want / mesh.shape["pod"]
    return {"quantizer_bitwise": bool(bitwise),
            "mean_err": float((mg["w"].cpu() - want).abs().max()),
            "err_err": float((ne["w"].cpu() - want_err).abs().max())}

# -- 13.5 the expert-parallel step, 13.6 the sharded decode ------------------

#: 13.5: qwen2-moe at full width in fp32, depth 1 (2 until its two
#: steps' 21 s were cut for the script's time), S and batch as 13.1's;
#: its 60 experts divide model = 4, so the banks take "ep".  (1, 2, 2)
#: was cut for the script's time (two steps took 38 s there)
EP_ARCH = "qwen2-moe-a2.7b"
EP_MESHES = ((1, 1, 4),)
#: 13.5: arctic-480b's forward at full width in bf16, depth 1, B 1 x S
#: SHARD_SEQ, its weights drawn on each rank's blocks only
ARCTIC_ARCH, ARCTIC_MESH = "arctic-480b", (1, 1, 4)
#: half of one whole arctic layer's banks: 3 x 128 x 7168 x 4864 x 2 B / 2
ARCTIC_BYTES = 13.39e9
#: 13.6: three archs at full width in fp32, depth 2, on (1, 1, 4): a
#: DECODE_PROMPT-token chunk (token by token where the arch takes one),
#: then DECODE_STEPS one-token steps, DECODE_ROWS rows, DECODE_SLOTS slots
DECODE_MESH = (1, 1, 4)
MESH_DECODE_ARCHS = ("starcoder2-3b", "xlstm-350m", "qwen2-moe-a2.7b")
MESH_DECODE_PROMPT, MESH_DECODE_STEPS = 16, 16
MESH_DECODE_ROWS, MESH_DECODE_SLOTS = 2, 32
MESH_DECODE_TOL = 1e-5


def ep_config():
    return check_config(EP_ARCH, "float32", {"n_layers": 1})


class ModelGathers:
    """Records, while installed, the operand shape and storage of every
    all-gather over the ``model`` axis of ``mesh`` (the collectives of the
    sharding module and the models)."""

    def __init__(self, mesh):
        self.group = (mesh.group("model") if mesh.shape.get("model", 1) > 1
                      else None)
        self.shapes, self.ptrs = [], set()

    def __enter__(self):
        from repro_torch.distributed import process_group as pg
        self._pg, self._orig = pg, pg.all_gather

        def recorded(x, group=None, *, dim=0):
            if group is not None and group is self.group:
                self.shapes.append(tuple(x.shape))
                self.ptrs.add(x.data_ptr())
            return self._orig(x, group, dim=dim)

        pg.all_gather = recorded
        return self

    def __exit__(self, *exc):
        self._pg.all_gather = self._orig
        return False


def ep_report(rs, shape, want_losses):
    """13.5's gates on one mesh's ranks: 13.1's (loss, every block, K4),
    every bank leaf in mode "ep", and no all-gather over ``model`` of a
    bank's block."""
    tag = "x".join(map(str, shape))
    errs = {}
    for r in rs:
        for p, e in r["errs"].items():
            errs[p] = max(errs.get(p, 0.0), e)
    worst = max(errs, key=errs.get)
    loss_err = max(abs(l - w) / abs(w) for r in rs
                   for l, w in zip(r["losses"], want_losses))
    modes = sorted({m for r in rs for m, _ in r["banks"].values()},
                   key=str)
    bank_gathers = sum(1 for r in rs for g in r["model_gathers"]
                       if g in {b for _, b in r["banks"].values()})
    emit({"shard_ep": EP_ARCH, "mesh": tag, "world": len(rs),
          "losses": rs[0]["losses"], "unsharded_losses": want_losses,
          "loss_rel_err": loss_err, "param_rel_err_max": errs[worst],
          "param_worst": worst, "bank_modes": modes,
          "bank_blocks": sorted({b for _, b in rs[0]["banks"].values()}),
          "model_gathers_rank0": len(rs[0]["model_gathers"]),
          "bank_gathers_over_model": bank_gathers,
          "topk_differs_by_route_call": [sum(x) for x in zip(
              *(r["routing_flips"] for r in rs))],
          "k4_launches_by_rank": [r["launches"]["flash_attention_cuda"]
                                  for r in rs],
          "k4_plain_on_cuda_by_rank": [r["k4_plain"] for r in rs],
          "init_s": rs[0]["init_s"],
          "step_wall_s_slowest": [max(r["step_wall_s"][i] for r in rs)
                                  for i in range(2)],
          "collectives_rank0": rs[0]["collectives"]})
    check(loss_err < SHARD_LOSS_TOL,
          f"§13.5 {tag}: loss rel err {loss_err:.3e}")
    check(errs[worst] < SHARD_PARAM_TOL,
          f"§13.5 {tag}: {worst} rel err {errs[worst]:.3e}")
    check(all(r["leaves_match"] for r in rs), f"§13.5 {tag}: leaves differ")
    check(modes == ["ep"], f"§13.5 {tag}: bank modes {modes}")
    check(bank_gathers == 0, f"§13.5 {tag}: {bank_gathers} all-gathers "
          f"over model of an expert bank's block")
    return check_k4(rs, f"§13.5 {tag}", "fp32")


def materialise(torch, net, mesh, seed):
    """Draw ``net``'s parameters (this rank's blocks, on ``meta``) on the
    card: the blocks cut over the mesh from a generator seeded by the
    rank, the whole ones from one seeded alike on every rank; normal(0,
    1/sqrt(d_in)) weights of the whole leaf's d_in (0.02 the
    embeddings), unit norm scales, zero biases.  A 3-D block is drawn an
    expert at a time, so no whole fp32 bank is held."""
    own = torch.Generator(device="cuda").manual_seed(seed + 1 + mesh.rank)
    shared = torch.Generator(device="cuda").manual_seed(seed)
    # to_empty makes new parameters: their placements are carried over
    placements = {n: p.placement for n, p in net.named_parameters()
                  if hasattr(p, "placement")}
    net.to_empty(device="cuda")
    with torch.no_grad():
        for name, p in net.named_parameters():
            where = placements.get(name)
            if where is not None:
                p.placement = where
            cut = where is not None and (where.dim is not None
                                         or where.fsdp is not None)
            gen = own if cut else shared
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "scale":
                p.fill_(1.0)
            elif leaf == "b":
                p.zero_()
            else:
                whole = list(p.shape)
                if where is not None and where.dim is not None:
                    whole[where.dim] *= mesh.shape["model"]
                std = (0.02 if name.startswith("embed")
                       else whole[-2] ** -0.5)
                for part in (p if p.dim() == 3 else (p,)):
                    part.copy_(torch.randn(part.shape, generator=gen,
                                           device="cuda").mul_(std))


def arctic_rank(torch, mesh):
    """13.5's arctic-480b forward on this rank: the network built on
    ``meta``, cut to the rank's blocks, drawn on the card
    (:func:`materialise`), then the prefill step of one row of
    SHARD_SEQ tokens under the mesh; the peak memory, the logits, K4."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.launch.prefill import make_prefill_step
    from repro_torch.models import build_model
    cfg = check_config(ARCTIC_ARCH, "bfloat16", {"n_layers": 1})
    model = build_model(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    net = model.init(None, device="meta")
    model.shard(net, mesh)
    materialise(torch, net, mesh, SEED + 31)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    held = sum(p.numel() * p.element_size() for p in net.parameters())
    modes = sorted({p.placement.mode for n, p in net.named_parameters()
                    if n.rsplit(".", 1)[-1] in ("w_up", "w_gate",
                                                "w_down")}, key=str)
    rng = np.random.default_rng(SEED + 37)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (1, SHARD_SEQ)).astype(np.int64)).cuda()
    prefill = make_prefill_step(model)
    kernels.reset_launches()
    t0 = time.perf_counter()
    with PlainK4Calls() as plain, ModelGathers(mesh) as gathers, \
            use_mesh(mesh):
        logits = prefill(net, tokens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    banks = {tuple(p.shape) for n, p in net.named_parameters()
             if n.rsplit(".", 1)[-1] in ("w_up", "w_gate", "w_down")}
    out = {"peak": torch.cuda.max_memory_allocated(), "before": before,
           "params_held": held, "init_s": init_s, "wall_s": wall,
           "finite": bool(torch.isfinite(logits.float()).all()),
           "logits_shape": tuple(logits.shape), "bank_modes": modes,
           "bank_gathers": sum(g in banks for g in gathers.shapes),
           "launches": kernels.launches(), "k4_plain": plain.calls,
           "k4_by_body": dict(kernels.flash_attention_cuda.launches_by_body),
           "on_card": all(p.is_cuda for p in net.parameters())}
    del net, logits
    return out


def arctic_report(rs):
    """13.5's arctic gates: each rank's peak under ARCTIC_BYTES, finite
    logits, the banks "ep" and never gathered over model, K4."""
    peaks = [r["peak"] for r in rs]
    emit({"shard_arctic": ARCTIC_ARCH, "mesh": ARCTIC_MESH, "layers": 1,
          "seq": SHARD_SEQ, "peak_by_rank": peaks, "limit": ARCTIC_BYTES,
          "allocated_before_by_rank": [r["before"] for r in rs],
          "params_held_by_rank": [r["params_held"] for r in rs],
          "init_s": [r["init_s"] for r in rs],
          "forward_wall_s": [r["wall_s"] for r in rs],
          "logits_shape": rs[0]["logits_shape"],
          "bank_modes": rs[0]["bank_modes"],
          "bank_gathers_over_model": sum(r["bank_gathers"] for r in rs),
          "k4_launches_by_rank": [r["launches"]["flash_attention_cuda"]
                                  for r in rs],
          "k4_plain_on_cuda_by_rank": [r["k4_plain"] for r in rs]})
    check(max(peaks) < ARCTIC_BYTES, f"§13.5 arctic: a rank's peak "
          f"{max(peaks)} B is not under {ARCTIC_BYTES}")
    check(all(r["finite"] for r in rs), "§13.5 arctic: non-finite logits")
    check(rs[0]["bank_modes"] == ["ep"],
          f"§13.5 arctic: bank modes {rs[0]['bank_modes']}")
    check(all(r["bank_gathers"] == 0 for r in rs),
          "§13.5 arctic: an expert bank gathered over model")
    return check_k4(rs, "§13.5 arctic", "bf16_wgmma")


def mesh_decode_tokens(cfg):
    import numpy as np
    rng = np.random.default_rng(SEED + 41)
    return rng.integers(0, cfg.vocab_size, (
        MESH_DECODE_ROWS, MESH_DECODE_PROMPT + MESH_DECODE_STEPS)).astype(
            np.int64)


def mesh_decode_run(torch, model, net, caches, tokens, mesh=None):
    """13.6's schedule: the prompt in one chunk (token by token where the
    arch takes one), then one token a step; every step's logits (on the
    host) and the caches."""
    from repro_torch.serving.engine import make_serve_step
    step = make_serve_step(model, mesh)
    s1 = MESH_DECODE_PROMPT if model.supports_chunked_prefill else 1
    cuts = list(range(0, MESH_DECODE_PROMPT, s1)) + list(range(
        MESH_DECODE_PROMPT, MESH_DECODE_PROMPT + MESH_DECODE_STEPS))
    ends = cuts[1:] + [MESH_DECODE_PROMPT + MESH_DECODE_STEPS]
    out = []
    for a, b in zip(cuts, ends):
        logits, caches = step(net, torch.from_numpy(tokens[:, a:b]).cuda(),
                              caches)
        out.append(logits.float().cpu())
    return out, caches


def decode_unsharded(torch, root):
    """13.6's reference: each arch's unsharded decode on the card.
    Returns the file of ``{arch: every step's last logits}``."""
    from repro_torch.models import build_model
    want = {}
    for arch in MESH_DECODE_ARCHS:
        cfg = check_config(arch, "float32", {"n_layers": 2})
        model = build_model(cfg)
        net = model.init(SEED, device="cuda")
        caches = model.init_cache(MESH_DECODE_ROWS, MESH_DECODE_SLOTS,
                                  device="cuda")
        want[arch], _ = mesh_decode_run(torch, model, net, caches,
                                        mesh_decode_tokens(cfg))
        del net, caches
        gc.collect()
        torch.cuda.empty_cache()
    path = os.path.join(root, "decode_want.pt")
    torch.save(want, path)
    return path


def decode_rank(torch, mesh, want_file):
    """13.6 on this rank: each arch's network drawn whole from the seed
    and cut to its blocks, its caches built as blocks, the schedule run
    under the mesh; the logits' error against the unsharded decode's, the
    argmax, and the cache bytes held on the leaves the specs cut."""
    from repro_torch.models import build_model
    want = torch.load(want_file)
    out = {}
    for arch in MESH_DECODE_ARCHS:
        cfg = check_config(arch, "float32", {"n_layers": 2})
        model = build_model(cfg)
        net = model.init(SEED, device="cuda")
        model.shard(net, mesh)
        caches = model.init_cache(MESH_DECODE_ROWS, MESH_DECODE_SLOTS,
                                  device="cuda", mesh=mesh)
        whole = model.init_cache(MESH_DECODE_ROWS, MESH_DECODE_SLOTS,
                                 device="meta")
        held = total = 0
        for blk, full in zip(caches, whole):
            for key, st in blk.items():
                for f in st._fields:
                    b, w = getattr(st, f), getattr(full[key], f)
                    if b.shape != w.shape:
                        held += b.numel() * b.element_size()
                        total += w.numel() * w.element_size()
        t0 = time.perf_counter()
        got, caches = mesh_decode_run(torch, model, net, caches,
                                      mesh_decode_tokens(cfg), mesh)
        wall = time.perf_counter() - t0
        errs = [float((g - w).abs().max() / w.abs().max())
                for g, w in zip(got, want[arch])]
        out[arch] = {"err": max(errs), "steps": len(got),
                     "argmax_equal": all(torch.equal(g.argmax(-1),
                                                     w.argmax(-1))
                                         for g, w in zip(got, want[arch])),
                     "finite": all(bool(torch.isfinite(g).all())
                                   for g in got),
                     "cut_bytes_held": held, "cut_bytes_whole": total,
                     "wall_s": wall}
        del net, caches
        gc.collect()
        torch.cuda.empty_cache()
    return out


def decode_report(rs):
    """13.6's gates: every step's logits within MESH_DECODE_TOL of the
    unsharded decode's largest, the same argmax, and each rank's cache
    bytes on the cut leaves a quarter of the whole's."""
    m = math.prod(DECODE_MESH)
    for arch in MESH_DECODE_ARCHS:
        a = [r[arch] for r in rs]
        err = max(x["err"] for x in a)
        emit({"shard_decode": arch, "mesh": DECODE_MESH,
              "rows": MESH_DECODE_ROWS, "slots": MESH_DECODE_SLOTS,
              "steps": a[0]["steps"], "logits_rel_err": err,
              "argmax_equal": all(x["argmax_equal"] for x in a),
              "cut_bytes_held_by_rank": [x["cut_bytes_held"] for x in a],
              "cut_bytes_whole": a[0]["cut_bytes_whole"],
              "wall_s_by_rank": [x["wall_s"] for x in a]})
        check(all(x["finite"] for x in a), f"§13.6 {arch}: non-finite logits")
        check(err <= MESH_DECODE_TOL, f"§13.6 {arch}: logits rel err "
              f"{err:.3e}")
        check(all(x["argmax_equal"] for x in a), f"§13.6 {arch}: argmax "
              "differs from the unsharded decode's")
        check(a[0]["cut_bytes_whole"] > 0, f"§13.6 {arch}: no cache leaf cut")
        check(all(x["cut_bytes_held"] * m == x["cut_bytes_whole"]
                  for x in a), f"§13.6 {arch}: a rank's cut cache bytes "
              f"are not 1/{m} of the whole's")

# -- 13.7 the reference's dp_sp and seq_sp profiles -----------------------------

#: 13.7: (profile, mesh, arch, sequence, global batch, layers), each fp32
#: at full width on its own mesh of §13's world: starcoder2-3b under
#: dp_sp, one row a rank; under seq_sp with 13.1's batch (576 positions a
#: rank, the reference 13.1's own run); xlstm-350m under seq_sp at S 1024
#: (its mLSTM on 1 of the 4 heads a rank and its sLSTM on 256 of the 1024
#: features, each on the gathered sequence: K5, K6 and K6's backward)
PROFILE_RUNS = (("dp_sp", (1, 2, 2), "starcoder2-3b", SHARD_SEQ, 4, 2),
                ("seq_sp", (1, 1, 4), "starcoder2-3b", SHARD_SEQ,
                 SHARD_BATCH, 2),
                ("seq_sp", (1, 1, 4), "xlstm-350m", 1024, SHARD_BATCH, 2))
#: 13.8, the head-parallel blocks under the baseline rules, as 13.7's
#: runs: xlstm-350m at depth 2 on (1, 1, 4), 13.7's xlstm batch and
#: unsharded run (the mLSTM on 1 of its 4 heads a rank, the sLSTM on 256
#: of its 1024 features); whisper-tiny at full depth (None) on (1, 2, 2),
#: S 2304 (the decoder's self-attention takes K4): 3 of its 6 heads a rank
#: in the encoder's and the decoder's self-attention and in the
#: cross-attention
HEAD_RUNS = (("baseline", (1, 1, 4), "xlstm-350m", 1024, SHARD_BATCH, 2),
             ("baseline", (1, 2, 2), "whisper-tiny", SHARD_SEQ,
              SHARD_BATCH, None))
#: the kernels each arch's runs in 13.7 and 13.8 must launch in every rank
PROFILE_KERNELS = {
    "starcoder2-3b": ("flash_attention_cuda",),
    "whisper-tiny": ("flash_attention_cuda",),
    "xlstm-350m": ("ssm_scan_cuda", "slstm_scan_cuda",
                   "slstm_scan_bwd_cuda")}
#: each leaf's first-step gradient against the unsharded one's, relative
#: to its largest entry
PROFILE_GRAD_TOL = 1e-5
#: leaves whose gradient is zero in exact arithmetic, and the leaf whose
#: gradient gives their scale: a bias on the keys adds q . b to every
#: score of a query's row, which the softmax cancels, so either side's
#: gradient is rounding noise of the size of its weight's gradient's
#: rounding, and against its own largest entry it compares noise to noise
ZERO_GRADIENT_SCALE = {"attn/wk/b": "attn/wk/w"}


def first_step(tr, batch):
    """The trainer's first step on ``batch`` (this rank's rows), as
    ``train_step`` takes it, with its gradients kept on the way: (the
    loss, the gradients as whole leaves on the host, gathered)."""
    from repro_torch.training.trainer import apply_update, step_gradients
    means, grads = step_gradients(tr.model, tr.net, batch, tr.layout)
    whole = tr.whole(grads)
    tr.opt_state, _ = apply_update(tr.cfg.opt, tr.net, grads, tr.opt_state,
                                   tr.layout)
    return float(means["loss"]), whole


def grad_scales(grads):
    """Each leaf's scale for its gradient's error: its largest entry
    (ZERO_GRADIENT_SCALE's leaves: their weight's)."""
    out = {p: float(g.abs().max()) for p, g in grads.items()}
    for p in grads:
        for tail, other in ZERO_GRADIENT_SCALE.items():
            if p.endswith(tail):
                out[p] = out[p[:-len(tail)] + other]
    return out


def profile_config(run):
    """The fp32 config of a 13.7 or 13.8 run: full width, its depth."""
    _, _, arch, _, _, layers = run
    return check_config(arch, "float32",
                        {} if layers is None else {"n_layers": layers})


def profile_file(root, run):
    """The file of a 13.7 or 13.8 run's unsharded reference."""
    _, _, arch, seq, rows, layers = run
    if (arch, seq, rows, layers) == (SHARD_ARCH, SHARD_SEQ, SHARD_BATCH, 2):
        return os.path.join(root, "exact_want.pt")     # 13.1's
    return os.path.join(root,
                        f"profile_want_{arch}_{seq}_{rows}_{layers}.pt")


def profiles_unsharded(torch, root):
    """13.7's and 13.8's references that 13.1's is not: two unsharded
    steps (and the first step's gradients) of each other (arch, seq,
    rows, layers)."""
    for run in PROFILE_RUNS + HEAD_RUNS:
        path = profile_file(root, run)
        if not os.path.exists(path):
            exact_unsharded(torch, root, profile_config(run),
                            os.path.basename(path), run[3], run[4],
                            grads=True)
            gc.collect()
            torch.cuda.empty_cache()


def profile_rank(torch, world_mesh, root, runs):
    """13.7 (13.8) on this rank: each of ``runs`` on a view of its mesh
    under the profile's rules, two steps (the first through its parts,
    ``step_gradients`` then ``apply_update``, as ``train_step`` runs
    them): the first step's gradient blocks and the parameter blocks
    after two steps against the unsharded run's, the losses, the peak
    memory, the collectives by kind, the launches; the tensor-parallel
    modules among the attention, SSM and xLSTM blocks, and the
    ``"tp"`` leaves that an all-gather over ``model`` took."""
    from repro_torch import kernels
    from repro_torch.distributed import (collective_stats,
                                         reset_collective_stats)
    from repro_torch.distributed.sharding import shard_of
    from repro_torch.launch.specs import rules_for
    from repro_torch.models.attention import Attention
    from repro_torch.models.convert import reference_leaves
    from repro_torch.models.ssm import MLSTM, SLSTM, SSD
    from repro_torch.training.trainer import apply_update, step_gradients
    out = []
    for run in runs:
        profile, shape, arch, seq, rows, _ = run
        mesh = world_mesh[shape].with_rules(rules_for(arch, profile))
        cfg = profile_config(run)
        want_file = profile_file(root, run)
        want = torch.load(want_file, mmap=True)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tr = shard_trainer(cfg, seq, SHARD_OPT, mesh=mesh, rows=rows)
        batch = {k: torch.from_numpy(v).cuda()
                 for k, v in tr.rows(shard_batch(cfg, seq, rows)).items()}
        kernels.reset_launches()
        reset_collective_stats()
        with PlainK4Calls() as plain, PlainK6Calls() as plain_k6, \
                ModelGathers(mesh) as gathers:
            # the first step as train_step takes it, its gradient blocks
            # compared on the way
            t0 = time.perf_counter()
            means, grads = step_gradients(tr.model, tr.net, batch,
                                          tr.layout)
            gerrs = {}
            for path, leaf in reference_leaves(tr.net).items():
                blk = [grads[n].float() for n in leaf.names]
                got = torch.stack(blk) if leaf.stacked else blk[0]
                w = shard_of(want["grads"][path], tr.layout.specs[path],
                             tr.mesh).to(got.device)
                gerrs[path] = (float((got - w).abs().max())
                               / max(want["grad_scale"][path], 1e-30))
                del blk, got, w
            tr.opt_state, _ = apply_update(tr.cfg.opt, tr.net, grads,
                                           tr.opt_state, tr.layout)
            losses = [float(means["loss"])]
            torch.cuda.synchronize()
            walls = [time.perf_counter() - t0]
            t0 = time.perf_counter()
            losses.append(float(tr.train_step(batch)["loss"]))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        counts = kernels.launches()
        bodies = dict(kernels.flash_attention_cuda.launches_by_body)
        stats = collective_stats()
        errs, leaves_match = block_errors(torch, tr, want_file)
        tp_leaves = {n: p for n, p in tr.net.named_parameters()
                     if getattr(p, "placement", None) is not None
                     and p.placement.mode == "tp"}
        out.append({"losses": losses, "grad_errs": gerrs, "errs": errs,
                    "blocks": sorted(
                        n for n, m in tr.net.named_modules()
                        if isinstance(m, (Attention, MLSTM, SLSTM, SSD))),
                    "tp": sorted(n for n, m in tr.net.named_modules()
                                 if getattr(m, "tp", None) is not None),
                    "tp_leaves": len(tp_leaves),
                    "tp_leaf_gathers": sorted(
                        n for n, p in tp_leaves.items()
                        if p.data_ptr() in gathers.ptrs),
                    "leaves_match": leaves_match,
                    "peak": torch.cuda.max_memory_allocated(),
                    "step_wall_s": walls, "launches": counts,
                    "k4_plain": plain.calls, "k4_by_body": bodies,
                    "k6_plain": sum(plain_k6.calls.values()),
                    "bytes_by_kind": stats["bytes_by_kind"],
                    "calls_by_kind": stats["calls_by_kind"],
                    "staged_bytes": stats["staged_bytes"],
                    "batch_axes": tr.mesh.batch_axes,
                    "rows": batch["tokens"].shape[0],
                    "on_card": on_card(tr)})
        del tr, batch, grads
    return out


def profiles_report(rs, root, runs=PROFILE_RUNS, section="13.7"):
    """13.7's (13.8's) gates on each run's ranks: loss within
    SHARD_LOSS_TOL relative, every block of every parameter within
    SHARD_PARAM_TOL and of every first-step gradient within
    PROFILE_GRAD_TOL of the unsharded run's; PROFILE_KERNELS launched in
    every rank, no plain version on a CUDA tensor.  13.8's also: every
    attention, SSM and xLSTM block tensor-parallel, and no all-gather over
    ``model`` of a ``"tp"`` leaf, in every rank."""
    totals = {}
    for j, run in enumerate(runs):
        profile, shape, arch, seq, rows, layers = run
        tag = f"§{section} {profile} {arch} {'x'.join(map(str, shape))}"
        a = [r[j] for r in rs]
        want_losses = unsharded_losses(root, run)
        errs, gerrs = {}, {}
        for x in a:
            for p, e in x["errs"].items():
                errs[p] = max(errs.get(p, 0.0), e)
            for p, e in x["grad_errs"].items():
                gerrs[p] = max(gerrs.get(p, 0.0), e)
        worst, gworst = max(errs, key=errs.get), max(gerrs, key=gerrs.get)
        loss_err = max(abs(l - w) / abs(w) for x in a
                       for l, w in zip(x["losses"], want_losses))
        need = PROFILE_KERNELS[arch]
        emit({"shard_profile" if section == "13.7" else "shard_heads":
              profile, "arch": arch, "mesh": shape, "seq": seq,
              "global_batch": rows, "layers": layers or "full",
              "tp_modules": a[0]["tp"],
              "tp_leaves_by_rank": [x["tp_leaves"] for x in a],
              "tp_leaf_gathers_over_model_by_rank": [
                  len(x["tp_leaf_gathers"]) for x in a],
              "batch_axes": a[0]["batch_axes"],
              "rows_by_rank": [x["rows"] for x in a],
              "losses": a[0]["losses"], "unsharded_losses": want_losses,
              "loss_rel_err": loss_err, "param_rel_err_max": errs[worst],
              "param_worst": worst, "grad_rel_err_max": gerrs[gworst],
              "grad_worst": gworst,
              "peak_by_rank": [x["peak"] for x in a],
              "step_wall_s_slowest": [max(x["step_wall_s"][i] for x in a)
                                      for i in range(2)],
              "collective_bytes_by_kind_rank0": a[0]["bytes_by_kind"],
              "collective_calls_by_kind_rank0": a[0]["calls_by_kind"],
              "staged_bytes_rank0": a[0]["staged_bytes"],
              "launches_by_rank": [{k: x["launches"][k] for k in need}
                                   for x in a],
              "k4_plain_on_cuda_by_rank": [x["k4_plain"] for x in a],
              "k4_launches_by_body_by_rank": [x["k4_by_body"] for x in a],
              "k6_plain_on_cuda_by_rank": [x["k6_plain"] for x in a]})
        check(loss_err < SHARD_LOSS_TOL, f"{tag}: loss rel err "
              f"{loss_err:.3e}")
        check(errs[worst] < SHARD_PARAM_TOL,
              f"{tag}: {worst} rel err {errs[worst]:.3e}")
        check(gerrs[gworst] < PROFILE_GRAD_TOL,
              f"{tag}: {gworst}'s gradient rel err {gerrs[gworst]:.3e}")
        check(all(x["leaves_match"] for x in a), f"{tag}: leaves differ")
        for rank, x in enumerate(a):
            if section == "13.8":
                check(x["tp"] and set(x["blocks"]) <= set(x["tp"]),
                      f"{tag}: blocks not tensor-parallel in rank {rank}: "
                      f"{sorted(set(x['blocks']) - set(x['tp']))}")
                check(not x["tp_leaf_gathers"], f"{tag}: rank {rank} "
                      f"gathered tp leaves {x['tp_leaf_gathers']}")
            check(x["on_card"], f"{tag}: a rank's tensors left the card")
            for k in need:
                check(x["launches"][k] > 0,
                      f"{tag}: {k} never launched in rank {rank}")
            check(x["k4_plain"] == 0 and x["k6_plain"] == 0,
                  f"{tag}: a plain version ran on the card in rank {rank}")
            k4 = x["launches"]["flash_attention_cuda"]
            check(k4_bodies_are(x["k4_by_body"], k4, "fp32"),
                  f"{tag}: K4 bodies {x['k4_by_body']} in rank {rank}")
            add_counts(K4_BODY_LAUNCHES, x["k4_by_body"])
            add_counts(totals, x["launches"])
    return totals


def unsharded_losses(root, run):
    """The unsharded losses of a 13.7 or 13.8 run (``exact_unsharded``
    keeps them beside its file)."""
    with open(profile_file(root, run) + ".losses.json") as f:
        return json.load(f)


# -- 14. the dry run ------------------------------------------------------------

DRY_ARCH = "starcoder2-3b"
DRY_MESH = (16, 16)
#: 14.3: decode cells, rank 0 of DRY_MESH on meta, then on the card
DRY_DECODE = (("starcoder2-3b", "decode_32k"), ("xlstm-350m", "long_500k"))
#: the predicted peak a rank under which 14.2's train depth stays
DRY_TRAIN_BYTES = 60e9
DRY_COUNT_TOL = 1e-9
DRY_PEAK_TOL = 0.30
#: 14.4: DRY_ARCH's train_4k cell under the reference's other profiles,
#: rank 0 of DRY_MESH on meta, then on the card at 14.2's depth rule
DRY_PROFILES = ("dp_sp", "seq_sp")


def dry_run(torch):
    """§14; returns the launch counts of 14.2's card runs."""
    from repro_torch import kernels
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.mesh import counting_mesh
    t_start = time.perf_counter()
    out_dir = os.path.join(HERE, "build", "smoke_dryrun")
    shutil.rmtree(out_dir, ignore_errors=True)
    mesh = counting_mesh(DRY_MESH, 0)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    def cell(shape, device, layers=None, arch=DRY_ARCH,
             profile="baseline"):
        tag = f"{profile}-{device}-{layers or 'full'}"
        return run_cell(arch, shape, mesh, "pod",
                        os.path.join(out_dir, tag), force=True,
                        verbose=False, device=device, layers=layers,
                        profile=profile)

    meta = {shape: cell(shape, "meta") for shape in ("train_4k",
                                                     "prefill_32k")}
    decode = {(arch, shape): cell(shape, "meta", arch=arch)
              for arch, shape in DRY_DECODE}
    for r in list(meta.values()) + list(decode.values()):
        emit({"dryrun_meta": dry_terms(r)})
    layers, train_meta = dry_train_depth(cell, meta["train_4k"])
    # 14.4: the train cell under each other profile, its depth by 14.2's
    # rule on its own meta counts
    profiled = []
    for profile in DRY_PROFILES:
        full = cell("train_4k", "meta", profile=profile)
        emit({"dryrun_meta": dry_terms(full), "profile": profile})
        depth, want = dry_train_depth(
            lambda shape, device, layers=None, arch=DRY_ARCH:
            cell(shape, device, layers, arch, profile), full)
        profiled.append((profile, want, depth))
    totals = {name: 0 for name in kernels.launches()}
    # the train step's predicted peak is 72 of the card's 79 GiB: after
    # §1-§13 fixed segments left 12.9 GiB reserved but unallocated in it
    # (a run out of memory), so §14 grows its segments in place
    emit({"dryrun_before_card": {
        "memory_allocated": torch.cuda.memory_allocated(),
        "memory_reserved": torch.cuda.memory_reserved()}})
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    try:
        runs = [(DRY_ARCH, "prefill_32k", meta["prefill_32k"], None,
                 "baseline"),
                (DRY_ARCH, "train_4k", train_meta, layers, "baseline")]
        runs += [(arch, shape, want, None, "baseline")
                 for (arch, shape), want in decode.items()]
        runs += [(DRY_ARCH, "train_4k", want, depth, profile)
                 for profile, want, depth in profiled]
        for arch, shape, want, depth, profile in runs:
            kernels.reset_launches()
            with PlainK4Calls() as plain:
                got = cell(shape, "cuda", depth, arch, profile)
            counts = kernels.launches()
            add_counts(totals, counts)
            gc.collect()
            torch.cuda.empty_cache()
            dry_report(got, want, counts, plain.calls)
    finally:
        torch.cuda.memory._set_allocator_settings("expandable_segments:False")
    emit({"dryrun_s": time.perf_counter() - t_start, "launches": totals})
    return totals


def dry_train_depth(cell, full):
    """14.2's train depth: the most layers whose predicted peak stays
    under DRY_TRAIN_BYTES, at least 2, from the peak at depth 2 and at
    full depth (it grows by one layer's stash and blocks a layer), with
    the meta count at that depth."""
    two = cell("train_4k", "meta", 2)
    p2 = two["memory_analysis"]["total_bytes"]
    pf = full["memory_analysis"]["total_bytes"]
    n = full["layers"]
    per_layer = max((pf - p2) / (n - 2), 1.0)
    layers = int(max(2, min(n, 2 + (DRY_TRAIN_BYTES - p2) // per_layer)))
    at = (two if layers == 2 else full if layers == n
          else cell("train_4k", "meta", layers))
    emit({"dryrun_train_depth": layers, "predicted_peak_at_2": p2,
          "predicted_peak_full": pf, "predicted_peak": at[
              "memory_analysis"]["total_bytes"], "limit": DRY_TRAIN_BYTES,
          "note": "at least 2 layers: the limit is not met at any depth"
          if at["memory_analysis"]["total_bytes"] > DRY_TRAIN_BYTES
          else "under the limit"})
    return layers, at


def dry_terms(r):
    keys = ("arch", "shape", "layers", "batch_rows", "compute_term",
            "memory_term", "collective_term", "dominant", "bound_time",
            "roofline_fraction", "useful_flops_fraction", "flops_by_type",
            "memory_bytes", "collective_breakdown", "collective_counts",
            "fits_hbm", "fsdp", "microbatches", "compile_s", "notes")
    out = {k: r.get(k) for k in keys}
    out["peak_bytes"] = r["memory_analysis"]["total_bytes"]
    return out


def dry_report(got, want, counts, plain_calls):
    """14.2's (14.3's) gates on one card run against its meta count; a
    decode step launches no kernel (as the reference's decode reaches no
    Pallas kernel)."""
    tag = f"§14 {got['arch']}@{got['shape']} {got['profile']}"
    pairs = {"memory_bytes": (got["memory_bytes"], want["memory_bytes"])}
    for key in ("flops_by_type", "collective_breakdown", "collective_counts"):
        check(set(got[key]) == set(want[key]),
              f"{tag}: {key} kinds differ: {got[key]} vs {want[key]}")
        pairs.update({f"{key}/{k}": (got[key][k], want[key][k])
                      for k in want[key]})
    worst = max(abs(a - b) / max(abs(b), 1e-30) for a, b in pairs.values())
    m = got["measured"]
    peak, predicted = m["max_memory_allocated"], \
        want["memory_analysis"]["total_bytes"]
    gap = (peak - predicted) / predicted
    bound = max(want["compute_term"], want["memory_term"])
    emit({"dryrun_card": dry_terms(got), "profile": got["profile"],
          "layers": got["layers"],
          "count_rel_err": worst, "tol": DRY_COUNT_TOL,
          "max_memory_allocated": peak, "predicted_peak": predicted,
          "peak_gap": gap, "peak_tol": DRY_PEAK_TOL,
          "allocated_before": m["allocated_before"],
          "cold_s": m["cold_s"], "warm_s": m["warm_s"],
          "cold_note": "the counted run: its wall carries the count's "
                       "host work",
          "bound_compute_memory_s": bound,
          "warm_over_bound": m["warm_s"] / bound if bound else None,
          "launches": counts, "k4_plain_on_cuda": plain_calls,
          "card": m["card"]})
    for name, (a, b) in pairs.items():
        check(abs(a - b) <= DRY_COUNT_TOL * max(abs(b), 1e-30),
              f"{tag}: the card's {name} {a} is not the meta count {b}")
    check(abs(gap) <= DRY_PEAK_TOL, f"{tag}: measured peak {peak:.4g} B is "
          f"{gap:+.1%} off the predicted {predicted:.4g} B")
    check(plain_calls == 0, f"{tag}: K4's plain version ran on the card")
    if got["kind"] != "decode":
        check(counts["flash_attention_cuda"] > 0, f"{tag}: K4 never launched")


# -- 15. the examples -----------------------------------------------------------

#: §15's examples in the order they run, with their arguments
EXAMPLES = (("quickstart", []), ("linalg_25d_demo", []),
            ("serve_batched", []),
            ("train_e2e", ["--smoke", "--steps", "20", "--batch", "4",
                           "--seq", "128"]))
#: seconds the examples' subprocess may take
EXAMPLES_TIMEOUT_S = 600

#: runs each example's ``main`` in one process on the card: the counts set
#: to 0 before and read after it, its output captured; prints one JSON line
EXAMPLES_DRIVER = r"""
import contextlib, importlib, io, json, os, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from repro_torch import kernels, obs, telemetry
out = {}
for name, argv in json.loads(sys.argv[2]):
    # the quickstart records as the reference's CI runs it
    if name == "quickstart":
        os.environ["REPRO_TELEMETRY"] = "1"
    else:
        os.environ.pop("REPRO_TELEMETRY", None)
    telemetry.reset()
    obs.reset()
    mod = importlib.import_module("repro_torch.examples." + name)
    torch.cuda.synchronize()
    kernels.reset_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        ret = mod.main(argv + ["--device", "cuda"])
    torch.cuda.synchronize()
    rec = {"wall_s": time.perf_counter() - t0,
           "launches": kernels.launches(),
           "stdout": buf.getvalue().splitlines()}
    if name == "train_e2e":
        rec.update(steps=ret["steps"], restarts=ret["restarts"],
                   losses=[h["loss"] for h in ret["history"]])
    out[name] = rec
print(json.dumps(out))
"""


def tree_stamp(root):
    """{relative path: (size, mtime_ns)} of every file under ``root``."""
    out = {}
    for base, _, files in os.walk(root):
        for name in files:
            path = os.path.join(base, name)
            st = os.stat(path)
            out[os.path.relpath(path, root)] = (st.st_size, st.st_mtime_ns)
    return out


def examples(torch):
    """§15; returns the launch counts of the four examples.

    The examples run in a subprocess: this process built its process-wide
    tuner and run store sections ago, under the checkout's locations, and
    the port resolves a location when such an object is built."""
    import tempfile

    from repro_torch import kernels, telemetry
    from repro_torch.core import calibration as cal
    from repro_torch.tuner import build_default_registry
    t_start = time.perf_counter()
    art = os.path.join(HERE, "artifacts")
    art_before = tree_stamp(art)
    totals = {name: 0 for name in kernels.launches()}
    with tempfile.TemporaryDirectory(prefix="smoke_examples_") as root:
        # the joint fit's starting point stands in for the two-minute fit
        with open(os.path.join(root, "hopper_joint_torch.json"), "w") as f:
            json.dump({"theta": [float(x) for x in cal.THETA0]}, f)
        env = dict(os.environ, REPRO_TORCH_ARTIFACTS=root)
        for name in ("REPRO_TORCH_TELEMETRY_DIR", "REPRO_TORCH_PLAN_DIR",
                     "REPRO_TORCH_BENCH_HISTORY_DIR", "REPRO_TELEMETRY",
                     "REPRO_OBS"):
            env.pop(name, None)
        # train_e2e checkpoints to its default directory, under the root
        args = [[name, argv] for name, argv in EXAMPLES]
        proc = subprocess.run(
            [sys.executable, "-c", EXAMPLES_DRIVER,
             os.path.join(HERE, "src"), json.dumps(args)],
            cwd=root, env=env, capture_output=True, text=True,
            timeout=EXAMPLES_TIMEOUT_S)
        check(proc.returncode == 0,
              f"§15: an example failed: {proc.stderr[-3000:]}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        for name, _ in EXAMPLES:
            check(name in res, f"§15: {name} did not finish")
            r = res[name]
            emit({"example": name, "wall_s": r["wall_s"],
                  "launches": r["launches"], "stdout": r["stdout"]})
            add_counts(totals, r["launches"])
        tel = os.path.join(root, "telemetry_torch")
        with open(os.path.join(tel, "report.json")) as f:
            report = json.load(f)
        store = telemetry.RunStore(tel)
        runs = [r for fp in store.fingerprints() for r in store.load(fp)
                if r.meta.get("agg") == "best5"]
        before = telemetry.accuracy_report(
            telemetry.join(runs, build_default_registry()))
    quick, train = res["quickstart"], res["train_e2e"]
    emit({"quickstart": {
        "n_rows": report["overall"]["n_rows"],
        "mean_rel_err_before_refit": before["overall"]["mean_rel_err"],
        "mean_rel_err_after_refit": report["overall"]["mean_rel_err"],
        "reference_ci_bar": 0.35,
        "k1_launches": quick["launches"]["matmul_cuda"]},
        "train_e2e": {"steps": train["steps"],
                      "restarts": train["restarts"],
                      "first_loss": train["losses"][0],
                      "last_loss": train["losses"][-1]}})
    check(report["overall"]["n_rows"] >= 16,
          f"§15: the quickstart's report has {report['overall']['n_rows']} "
          "rows, not 16")
    check(quick["launches"]["matmul_cuda"] > 0,
          "§15: K1 never launched in the quickstart's loop")
    check(train["steps"] == 20
          and all(math.isfinite(x) for x in train["losses"]),
          f"§15: train_e2e ran {train['steps']} steps, losses "
          f"{train['losses']}")
    art_after = tree_stamp(art)
    changed = sorted(set(art_after.items()) ^ set(art_before.items()))
    check(not changed, f"§15 wrote under the checkout's artifacts/: "
          f"{changed[:8]}")
    emit({"examples_s": time.perf_counter() - t_start, "launches": totals})
    return totals


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
