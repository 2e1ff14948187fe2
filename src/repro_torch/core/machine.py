"""Machine descriptions for the performance-model engine.

The paper's methodology (González-Domínguez et al., 2014) parameterizes a
machine by: per-process peak flops (one process per NUMA domain with ``t``
BLAS threads on Hopper), network latency ``L``, contention-free inverse
bandwidth ``beta`` (seconds/word), and the contention-calibration surfaces
``C_avg(d)`` / ``C_max(p, d)``.  We keep the same parameterization and add
the TPU-side constants (HBM bandwidth/capacity, ICI link bandwidth) needed
by the roofline analysis and by the TPU adaptation of the models.

Units: seconds, flop/s, bytes, and "words" (``word_bytes`` per element —
8 for the paper's doubles, 2 for bf16 on TPU).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Optional


@dataclasses.dataclass(frozen=True)
class KernelConstants:
    """Intra-kernel phase-model constants (the WSE-2 SUMMA exemplar's
    parameterization, adapted to Pallas grids): per-kernel time decomposes
    into H2D streaming, issue/execute cycles inflated by a measured
    overhead factor plus per-grid-step loop cost, and D2H write-back —
    with H2D/D2H bandwidths kept separate because write-back gather
    patterns are consistently slower than operand broadcast.

    Seed values come from ``benchmarks/bench_kernels.py`` sweeps;
    ``telemetry.refit_kernels`` recalibrates them from recorded per-kernel
    phase times (revision-bumped, never in place).
    """

    fma_rate: float          # flop/s for MXU-shaped (dgemm) inner loops
    vpu_rate: float          # flop/s for column-recurrence (VPU) work
    bw_h2d: float            # B/s operand streaming into on-chip memory
    bw_d2h: float            # B/s result write-back (gather side; slower)
    c_h2d: float             # s fixed input-side setup per kernel launch
    c_d2h: float             # s fixed output-side setup per kernel launch
    overhead_factor: float   # >= 1 multiplier on pure issue/execute time
    loop_overhead: float     # s per grid step (index math, task switch)
    vmem_bytes: float        # usable on-chip bytes for one step's blocks


@dataclasses.dataclass(frozen=True)
class Machine:
    name: str
    # -- compute ------------------------------------------------------------
    peak_flops_per_unit: float      # one "process unit": NUMA domain / TPU chip
    threads_per_unit: int           # BLAS threads per process (Hopper: 6; TPU: 1)
    units_per_node: int             # NUMA domains per node / chips per host
    mem_per_unit: float             # bytes of memory available to one unit
    # -- network ------------------------------------------------------------
    word_bytes: int                 # bytes per "word" in the alpha-beta model
    latency: float                  # L  [s]
    inv_bandwidth: float            # beta  [s/word], contention-free
    link_bandwidth: float           # per-direction per-link  [B/s]
    torus_dims: int                 # 3 for Gemini 3D torus, 2 for v5e ICI,
                                    # 0 for an all-to-all fabric (crossbar)
    # -- memory system (None when not modeled, e.g. the paper's Hopper) -----
    hbm_bandwidth: Optional[float] = None   # [B/s] per unit
    # -- cross-pod (multi-pod meshes only) -----------------------------------
    dcn_bandwidth: Optional[float] = None   # per-host DCN [B/s]
    notes: str = ""
    # -- intra-kernel tier (None: no Pallas profile -> heuristic tiles) ------
    kernel_constants: Optional[KernelConstants] = None
    # -- profile revision ----------------------------------------------------
    # Bumped (never mutated in place) when measured-run feedback refits the
    # profile or drift detection declares the current one stale.  The
    # fingerprint hashes it, so every revision owns distinct plan-cache and
    # telemetry keys.
    revision: int = 0

    @property
    def peak_flops_per_thread(self) -> float:
        return self.peak_flops_per_unit / self.threads_per_unit

    def fingerprint(self) -> str:
        """Short stable hash of every dataclass field.  Any profile change —
        re-measured peak, new beta, a drift-bumped ``revision`` — yields a
        new fingerprint, which is what keys the tuner plan cache and the
        telemetry run store."""
        blob = json.dumps(dataclasses.asdict(self), sort_keys=True,
                          default=str)
        return hashlib.sha256(blob.encode()).hexdigest()[:12]

    @classmethod
    def from_dict(cls, d: dict) -> "Machine":
        """Rebuild a profile from ``dataclasses.asdict`` output (a JSON
        round-trip included): the nested ``kernel_constants`` dict becomes a
        :class:`KernelConstants` again, so the fingerprint is unchanged and
        plans frozen against the profile keep their cache keys."""
        d = dict(d)
        kc = d.get("kernel_constants")
        if isinstance(kc, dict):
            d["kernel_constants"] = KernelConstants(**kc)
        return cls(**d)

    def peak_flops(self, units: int) -> float:
        return units * self.peak_flops_per_unit

    def peak_for(self, dtype: str) -> float:
        """One unit's dense peak for operands of ``dtype`` (a torch type's
        name, ``"bfloat16"``): the profile's own by type where
        :data:`TYPE_PEAKS` lists it, else ``peak_flops_per_unit``, the one
        peak the other profiles model.  A profile listed there raises for a
        type it does not list, rather than price it at another type's
        peak."""
        peaks = TYPE_PEAKS.get(self.name)
        if peaks is None:
            return self.peak_flops_per_unit
        if dtype not in peaks:
            raise KeyError(f"{self.name} has no peak for {dtype} operands "
                           f"(it lists {sorted(peaks)})")
        return peaks[dtype]

    def contention_free_bandwidth(self) -> float:
        """Bytes/s implied by beta (large-message plateau)."""
        return self.word_bytes / self.inv_bandwidth


# ---------------------------------------------------------------------------
# Hopper — Cray XE6 (paper Table I).  The latency and plateau bandwidth are
# digitized from paper Fig. 2 (UPC one-sided ping): L ~= 1.5 us and a large-
# message plateau of ~5.9 GB/s (per-direction peak is 7 GB/s).
# One process unit = one NUMA domain = 6 cores * 8.4 Gflop/s.
# ---------------------------------------------------------------------------
HOPPER = Machine(
    name="hopper-cray-xe6",
    peak_flops_per_unit=6 * 8.4e9,
    threads_per_unit=6,
    units_per_node=4,
    mem_per_unit=32e9 / 4,
    word_bytes=8,
    latency=1.5e-6,
    inv_bandwidth=8.0 / 5.9e9,      # s/word (doubles) at the Fig. 2 plateau
    link_bandwidth=7.0e9,
    torus_dims=3,
    hbm_bandwidth=25.6e9,
    notes="Paper target platform (Table I / Fig. 2).",
)

# ---------------------------------------------------------------------------
# TPU v5e — the adaptation target of this framework (one unit = one chip).
# Constants fixed by the assignment: 197 TFLOP/s bf16, 16 GB HBM @ 819 GB/s,
# ~50 GB/s per ICI link, 2D ICI torus within a 16x16 pod, DCN between pods.
# latency: ~1 us per ICI hop is a standard planning number.
# ---------------------------------------------------------------------------
TPU_V5E = Machine(
    name="tpu-v5e",
    peak_flops_per_unit=197e12,
    threads_per_unit=1,
    units_per_node=4,                # chips per host
    mem_per_unit=16e9,
    word_bytes=2,                    # bf16
    latency=1.0e-6,
    inv_bandwidth=2.0 / 50e9,        # s/word over one ICI link
    link_bandwidth=50e9,
    torus_dims=2,
    hbm_bandwidth=819e9,
    dcn_bandwidth=25e9,
    notes="Adaptation target (assignment constants).",
    # Kernel-tier seeds (planning numbers, refit from telemetry): MXU at
    # the bf16 peak, VPU two orders down; H2D streams at HBM rate while
    # D2H write-back pays the gather-side penalty (the WSE-2 exemplar
    # measures ~3x — we seed 2x for the TPU's memory system).
    kernel_constants=KernelConstants(
        fma_rate=197e12, vpu_rate=4e12,
        bw_h2d=819e9, bw_d2h=410e9,
        c_h2d=2e-6, c_d2h=5e-6,
        overhead_factor=1.35, loop_overhead=1.5e-6,
        vmem_bytes=96 * 1024 * 1024),
)

# ---------------------------------------------------------------------------
# A CPU host run as N ranks.  Its alpha/beta/C tables are meant to be
# *measured* by the calibration benchmarks — the values here are only
# fallbacks so the model engine stays usable before calibration has run.
# ---------------------------------------------------------------------------
CPU_HOST = Machine(
    name="cpu-host",
    peak_flops_per_unit=5.0e9,       # conservative 1-core f64 dgemm; re-measured
    threads_per_unit=1,
    units_per_node=8,
    mem_per_unit=4e9,
    word_bytes=8,
    latency=5.0e-6,
    inv_bandwidth=8.0 / 8e9,
    link_bandwidth=8e9,
    torus_dims=1,
    hbm_bandwidth=20e9,
    notes="Host CPU 'machine' used for live validation of the methodology.",
    # Interpret-path seeds: the Pallas interpreter charges heavy per-grid-
    # step overhead, which is exactly what bench_kernels measures and
    # refit_kernels recalibrates; these fallbacks only need the right
    # ordering (steps expensive, bandwidth cheap-ish) to rank tiles sanely.
    kernel_constants=KernelConstants(
        fma_rate=5e9, vpu_rate=5e8,
        bw_h2d=8e9, bw_d2h=4e9,
        c_h2d=2e-4, c_d2h=2e-4,
        overhead_factor=2.0, loop_overhead=5e-4,
        vmem_bytes=96 * 1024 * 1024),
)

# ---------------------------------------------------------------------------
# NVIDIA H100 SXM — the port's card (one unit = one GPU).  Every constant is
# a spec-sheet seed, not a measurement: 67 TFLOP/s IEEE fp32 on the CUDA
# cores (the local kernels compute in fp32 FFMA), 80 GB of HBM3 at
# 3.35 TB/s, NVLink 4 at 450 GB/s each way to every other card of an
# 8-GPU host (all to all, so no torus: one hop).  The latency is a planning
# number for a small NVLink/NCCL transfer.  No kernel-constants block: the
# kernel tier falls back to heuristic tiles until a measured refit exists.
# Named "h100-sxm": HOPPER above is the paper's Cray XE6.
# ---------------------------------------------------------------------------
H100_SXM = Machine(
    name="h100-sxm",
    peak_flops_per_unit=67e12,
    threads_per_unit=1,
    units_per_node=8,
    mem_per_unit=80e9,
    word_bytes=4,                    # fp32
    latency=5.0e-6,
    inv_bandwidth=4.0 / 450e9,       # s/word over one NVLink direction
    link_bandwidth=450e9,
    torus_dims=0,                    # NVSwitch: the simulator's Crossbar
    hbm_bandwidth=3.35e12,
    notes="NVIDIA H100 SXM 80GB; spec-sheet seeds (data sheet peaks), "
          "not measured.",
)

#: the H100's kernel-tier seed for ``benchmarks/bench_kernels.py``, which
#: registers ``dataclasses.replace(H100_SXM, kernel_constants=
#: H100_KERNEL_SEED)`` in a registry of its own and refits it from K1's tile
#: sweep on the card.  It is not attached to ``H100_SXM``: the candidate
#: grid of ``perf/kernel.py`` speaks the TPU's VMEM blocks, so the card's
#: dispatch keeps the heuristic plan, which K1 maps to its default tile.
H100_KERNEL_SEED = KernelConstants(
    # data sheet: 67 TFLOP/s IEEE fp32 FFMA on the CUDA cores, for the
    # products and the column recurrences alike (no TF32)
    fma_rate=67e12, vpu_rate=67e12,
    # data sheet: 3.35 TB/s of HBM3, read and written alike
    bw_h2d=3.35e12, bw_d2h=3.35e12,
    # planning numbers: about 5 us a kernel launch, half charged to each
    # side, and 100 ns for one of the model's grid steps (a block of C
    # through one block of K) on 132 SMs; the refit moves the latter
    c_h2d=2.5e-6, c_d2h=2.5e-6,
    overhead_factor=1.0, loop_overhead=1e-7,
    # the data sheet's 50 MB L2, which K1's grouped raster keeps its strips
    # of A and B in: every plan of the sweep fits it
    vmem_bytes=50 * 1024 * 1024)

#: dense peaks of one unit by operand type, for the profiles whose data
#: sheets give more than one (a table beside the profiles rather than a
#: field of :class:`Machine`, whose fields and fingerprint are the
#: reference's): the H100's tensor cores for bf16 and fp16, 67 TFLOP/s
#: IEEE fp32 on the CUDA cores (no TF32, as the port computes fp32)
TYPE_PEAKS = {
    H100_SXM.name: {"bfloat16": 989e12, "float16": 989e12,
                    "float32": 67e12},
}

MACHINES = {m.name: m for m in (HOPPER, TPU_V5E, CPU_HOST, H100_SXM)}
