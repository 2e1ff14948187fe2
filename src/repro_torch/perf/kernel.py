"""The intra-kernel tier of the performance-model stack.

The algorithm tier (``perf.models``) stops at whole-op granularity: a
``Compute`` leaf charges ``flops / (peak * efficiency)``.  This module
models what happens *inside* one Pallas kernel launch as a function of the
tile (block) shape, in the phase style of the WSE-2 SUMMA exemplar
(``cycles = FMACS * (1 + Mt) * overhead``, H2D/D2H asymmetry, tile-size
amortization against the on-chip memory limit):

    T_kernel(tile) = T_h2d + T_compute + T_d2h

    T_h2d     = c_h2d * launches + bytes_in(tile)  / bw_h2d
    T_compute = (flops_mxu / fma_rate + flops_vpu / vpu_rate)
                  * overhead_factor + steps(tile) * loop_overhead
    T_d2h     = c_d2h * launches + bytes_out(tile) / bw_d2h

subject to the feasibility gate ``vmem_bytes(tile) <= machine VMEM``.
``bytes_in`` counts *per-grid-step* operand traffic — for matmul it is
``M*K*N * (1/bn + 1/bm) * itemsize``, the classic tile-size/traffic
tradeoff (larger tiles move less data but need more on-chip memory; the
data-movement lower bounds of Ballard et al., arXiv:0902.2537, bound what
any tile plan can save).  Padded dimensions are used throughout, so the
padding waste of an oversized tile and the amortization win of a larger
one trade off inside one formula.

Everything evaluates vectorized over numpy arrays of candidate tiles —
``KernelModel.choose`` scores the whole candidate grid in one pass, like
the scenario engine in ``perf.evaluate`` — and the constants live in
``Machine.kernel_constants`` (seeded by ``benchmarks/bench_kernels.py``,
recalibrated by ``telemetry.refit_kernels``).  When a machine profile has
no kernel-constants block, ``heuristic_plan`` reproduces today's
hard-coded wrapper blocks exactly, so the tuner can always stand down.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

#: block-dimension names per kernel family, in wrapper argument order.
KERNEL_DIMS: Dict[str, Tuple[str, ...]] = {
    "matmul": ("bm", "bn", "bk"),
    "trsm": ("block",),
    "cholesky": ("block",),
    "flash_attention": ("bq", "bkv"),
    "ssm_scan": ("bs",),
}

#: local kernels each dispatchable algorithm executes, in resolution order
#: (matmul first: trsm/cholesky charge their dgemm-shaped work at the
#: already-chosen matmul tile).
ALGO_KERNELS: Dict[str, Tuple[str, ...]] = {
    "cannon": ("matmul",),
    "summa": ("matmul",),
    "trsm": ("matmul", "trsm"),
    "cholesky": ("matmul", "trsm", "cholesky"),
}

#: the MXU/VPU lane tile — no block dimension below this is ever emitted.
MIN_TILE = 128

#: candidate block sizes per dimension (powers of two from the lane tile).
CANDIDATE_SIZES = (128, 256, 512, 1024)

#: default VMEM budget for the heuristic path — headroom out of ~128 MB,
#: shared with ``kernels.common`` (defined here so the model layer stays
#: free of array-framework imports).
VMEM_BUDGET = 96 * 1024 * 1024

_ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4, "float64": 8}


def itemsize_of(dtype) -> int:
    """Bytes per element for a dtype or dtype-name (bf16-aware)."""
    name = getattr(dtype, "name", None) or str(dtype)
    size = _ITEMSIZE.get(name)
    if size is not None:
        return size
    return int(np.dtype(name).itemsize)


def _round_up(x, m):
    """Elementwise round-up to a multiple (numpy-broadcasting)."""
    x = np.asarray(x, dtype=float)
    m = np.asarray(m, dtype=float)
    return np.ceil(x / m) * m


# ---------------------------------------------------------------------------
# TilePlan — the resolved block-shape decision for one kernel family
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """Block sizes for one kernel launch.  Frozen and tuple-backed so it is
    hashable — the kernel wrappers take it as a jit-static argument and the
    dispatch executor memoizes on it."""

    kernel: str
    blocks: Tuple[Tuple[str, int], ...]   # ((dim, size), ...) wrapper order
    source: str = "heuristic"             # "heuristic" | "model" | "explicit"

    @classmethod
    def make(cls, kernel: str, source: str = "explicit",
             **dims: int) -> "TilePlan":
        names = KERNEL_DIMS[kernel]
        missing = [d for d in names if d not in dims]
        extra = [d for d in dims if d not in names]
        if missing or extra:
            raise ValueError(f"{kernel} tile needs dims {names}; "
                             f"missing {missing}, extra {extra}")
        return cls(kernel, tuple((d, int(dims[d])) for d in names), source)

    @classmethod
    def from_blocks(cls, kernel: str, blocks: Mapping[str, int],
                    source: str = "explicit") -> "TilePlan":
        return cls.make(kernel, source=source, **dict(blocks))

    def __getitem__(self, dim: str) -> int:
        for d, v in self.blocks:
            if d == dim:
                return v
        raise KeyError(dim)

    def get(self, dim: str, default: Optional[int] = None) -> Optional[int]:
        for d, v in self.blocks:
            if d == dim:
                return v
        return default

    def block_dict(self) -> Dict[str, int]:
        return dict(self.blocks)

    def sizes(self) -> Tuple[int, ...]:
        return tuple(v for _d, v in self.blocks)

    def to_dict(self) -> dict:
        return {"kernel": self.kernel, "blocks": dict(self.blocks),
                "source": self.source}

    @classmethod
    def from_dict(cls, d: Mapping) -> "TilePlan":
        return cls.from_blocks(d["kernel"], d["blocks"],
                               source=d.get("source", "explicit"))


# ---------------------------------------------------------------------------
# Work decomposition per kernel family (vectorized over tile arrays)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class KernelWork:
    """What one kernel invocation does, as numpy arrays broadcast over the
    candidate-tile axes: the raw material of both the time model and the
    refit design matrix."""

    flops_mxu: np.ndarray    # dgemm-shaped flops (padded dims)
    flops_vpu: np.ndarray    # column-recurrence / elementwise flops
    bytes_in: np.ndarray     # operand bytes streamed on-chip (per-step sum)
    bytes_out: np.ndarray    # result bytes written back
    steps: np.ndarray        # total grid steps across all launches
    launches: np.ndarray     # pallas_call launches (fixed setup each)
    vmem_bytes: np.ndarray   # peak on-chip bytes of one step's blocks


def _matmul_work(shape, tiles, itemsize):
    # shape entries may themselves be arrays (best_time broadcasts a whole
    # problem-edge axis against the candidate-tile axis)
    m, k, n = (np.asarray(x, dtype=float) for x in shape)
    bm = np.asarray(tiles["bm"], dtype=float)
    bn = np.asarray(tiles["bn"], dtype=float)
    bk = np.asarray(tiles["bk"], dtype=float)
    mp, kp, np_ = _round_up(m, bm), _round_up(k, bk), _round_up(n, bn)
    gm, gn, gk = mp / bm, np_ / bn, kp / bk
    steps = gm * gn * gk
    return KernelWork(
        flops_mxu=2.0 * mp * np_ * kp,
        flops_vpu=np.zeros_like(steps),
        # A-block refetched per N-tile, B-block per M-tile: the 1/bn + 1/bm
        # traffic law that makes tile choice a memory/bandwidth tradeoff.
        bytes_in=steps * (bm * bk + bk * bn) * itemsize,
        bytes_out=gm * gn * bm * bn * itemsize,
        steps=steps,
        launches=np.ones_like(steps),
        vmem_bytes=((bm * bk + bk * bn + bm * bn) * itemsize
                    + bm * bn * 4.0),
    )


def _mm_tile_sizes(mm_tile: Optional[TilePlan]) -> Tuple[float, float, float]:
    if mm_tile is None:
        return 256.0, 256.0, 512.0        # the historical default blocks
    return (float(mm_tile["bm"]), float(mm_tile["bn"]), float(mm_tile["bk"]))


def _trsm_work(shape, tiles, itemsize, mm_tile=None):
    """X U = B with U (n, n), B (m, n), blocked at ``block``: n/b diagonal
    back-substitutions on the VPU + n/b - 1 trailing dgemm updates whose
    aggregate flops are tile-independent but whose launch/step overheads
    amortize with larger blocks."""
    m, n = (float(x) for x in shape)
    b = np.asarray(tiles["block"], dtype=float)
    mp = _round_up(m, MIN_TILE)
    np_ = _round_up(n, b)
    nb = np_ / b
    bm_mm, bn_mm, bk_mm = _mm_tile_sizes(mm_tile)
    # trailing updates: sum_j 2 * mp * b * (np_ - (j+1) b) = mp*np_*(np_-b)
    mxu = mp * np_ * (np_ - b)
    mm_steps = mxu / (2.0 * bm_mm * bn_mm * bk_mm)
    # diagonal solves: one matvec per column -> 2*mp*b flops, b columns/blk
    vpu = 2.0 * mp * b * np_
    diag_steps = nb * np.maximum(mp / 256.0, 1.0)   # trsm_diag row blocks
    # traffic: U blocks once (nb * b*b + upper panels ~ np_^2/2), B panels
    # in and X panels out once per diagonal block, update tails in+out.
    tri = np_ * np_ / 2.0 + np_ * b / 2.0
    bytes_in = (tri + 2.0 * nb * mp * b + mp * (np_ - b)) * itemsize
    bytes_out = (nb * mp * b + mp * (np_ - b)) * itemsize
    return KernelWork(
        flops_mxu=mxu,
        flops_vpu=vpu,
        bytes_in=bytes_in,
        bytes_out=bytes_out,
        steps=diag_steps + mm_steps,
        launches=2.0 * nb - 1.0,          # nb diag solves + nb-1 dgemms
        vmem_bytes=(b * b + 256.0 * b) * itemsize + 256.0 * b * 4.0,
    )


def _cholesky_work(shape, tiles, itemsize, mm_tile=None):
    """Right-looking blocked Cholesky at block ``b``: nb VPU diagonal
    factors, nb-1 panel solves (VPU diag + dgemm tails) and nb-1 trailing
    syrk updates on the MXU."""
    (n,) = (float(x) for x in shape)
    b = np.asarray(tiles["block"], dtype=float)
    np_ = _round_up(n, b)
    nb = np_ / b
    bm_mm, bn_mm, bk_mm = _mm_tile_sizes(mm_tile)
    # rows_j = np_ - (j+1) b for j = 0..nb-2
    sum_rows = np_ * (nb - 1.0) - b * nb * (nb - 1.0) / 2.0
    sum_rows2 = b * b * (nb - 1.0) * nb * (2.0 * nb - 1.0) / 6.0
    # syrk trailing updates + trsm-tail dgemms
    mxu = 2.0 * b * sum_rows2 + b * b * sum_rows
    mm_steps = mxu / (2.0 * bm_mm * bn_mm * bk_mm)
    # diagonal factors (~2/3 b^3 each) + panel back-substitutions
    vpu = nb * (2.0 / 3.0) * b ** 3 + 2.0 * b * b * sum_rows
    diag_steps = nb + (nb - 1.0) * np.maximum(sum_rows
                                              / np.maximum(nb - 1.0, 1.0)
                                              / 256.0, 1.0)
    bytes_in = (nb * b * b + 2.0 * b * sum_rows + 2.0 * sum_rows2) * itemsize
    bytes_out = (nb * b * b + b * sum_rows + sum_rows2) * itemsize
    return KernelWork(
        flops_mxu=mxu,
        flops_vpu=vpu,
        bytes_in=bytes_in,
        bytes_out=bytes_out,
        steps=diag_steps + mm_steps,
        launches=3.0 * nb - 2.0,
        vmem_bytes=(b * b * 2.0) * itemsize + b * b * 4.0,
    )


def _flash_work(shape, tiles, itemsize, causal=False):
    bh, sq, skv, d = (float(x) for x in shape)
    bq = np.asarray(tiles["bq"], dtype=float)
    bkv = np.asarray(tiles["bkv"], dtype=float)
    sqp, skvp = _round_up(sq, bq), _round_up(skv, bkv)
    dp = _round_up(d, MIN_TILE)
    gq, gk = sqp / bq, skvp / bkv
    # causal skips blocks above the diagonal: ~ (1 + 1/gk)/2 of the work
    frac = (1.0 + 1.0 / gk) / 2.0 if causal else 1.0
    steps = bh * gq * gk * frac
    return KernelWork(
        flops_mxu=4.0 * bh * sqp * skvp * dp * frac,   # QK^T and PV
        flops_vpu=6.0 * bh * sqp * skvp * frac,        # exp/max/rescale
        bytes_in=(bh * (sqp * dp * gk + 2.0 * skvp * dp * gq)
                  * frac * itemsize),
        bytes_out=bh * sqp * dp * itemsize,
        steps=steps,
        launches=np.ones_like(steps),
        vmem_bytes=((bq * dp + 2.0 * bkv * dp) * itemsize
                    + (bq * dp + 2.0 * bq * 128.0) * 4.0),
    )


def _ssm_work(shape, tiles, itemsize):
    bh, s, dk, dv = (float(x) for x in shape)
    bs = np.asarray(tiles["bs"], dtype=float)
    sp = _round_up(s, bs)
    gc = sp / bs
    steps = bh * gc
    return KernelWork(
        # intra-chunk scores + intra y + inter y + state update
        flops_mxu=bh * gc * (2.0 * bs * bs * (dk + dv)
                             + 4.0 * bs * dk * dv),
        flops_vpu=6.0 * bh * sp * bs,                  # cumsum/exp/mask
        bytes_in=bh * sp * (2.0 * dk + dv + 1.0) * itemsize,
        bytes_out=bh * sp * dv * itemsize,
        steps=steps,
        launches=np.ones_like(steps),
        vmem_bytes=(bs * (2.0 * dk + 2.0 * dv + 1.0) * itemsize
                    + dk * dv * 4.0),
    )


def kernel_work(kernel: str, shape: Sequence[float],
                tiles: Mapping[str, np.ndarray], itemsize: int, *,
                mm_tile: Optional[TilePlan] = None,
                causal: bool = False) -> KernelWork:
    """The work decomposition of one ``kernel`` invocation on ``shape`` at
    the given tile sizes (arrays broadcast over candidate axes).

    Shapes: matmul ``(m, k, n)``; trsm ``(m, n)``; cholesky ``(n,)``;
    flash_attention ``(bh, sq, skv, d)``; ssm_scan ``(bh, s, dk, dv)``.
    ``mm_tile`` is the already-resolved matmul tile that trsm/cholesky
    charge their dgemm-shaped trailing updates at.
    """
    if kernel == "matmul":
        return _matmul_work(shape, tiles, itemsize)
    if kernel == "trsm":
        return _trsm_work(shape, tiles, itemsize, mm_tile=mm_tile)
    if kernel == "cholesky":
        return _cholesky_work(shape, tiles, itemsize, mm_tile=mm_tile)
    if kernel == "flash_attention":
        return _flash_work(shape, tiles, itemsize, causal=causal)
    if kernel == "ssm_scan":
        return _ssm_work(shape, tiles, itemsize)
    raise ValueError(f"unknown kernel family {kernel!r}; "
                     f"known: {sorted(KERNEL_DIMS)}")


# ---------------------------------------------------------------------------
# Heuristic plans — today's hard-coded wrapper blocks, verbatim
# ---------------------------------------------------------------------------


def heuristic_matmul_blocks(m: int, n: int, k: int, bytes_per_el: int,
                            vmem_budget: Optional[int] = None
                            ) -> Tuple[int, int, int]:
    """The wrapper's historical block choice: start at (256, 256, 512),
    shrink K first, then M/N together, until the blocks fit the budget.

    Unlike the original loop this terminates unconditionally: once every
    dimension has bottomed out at the 128 floor we bail with the floor
    blocks even if they still exceed a tiny budget (the kernel then runs
    VMEM-oversubscribed rather than the picker spinning forever), and the
    budget is a parameter instead of a module constant.
    """
    budget = VMEM_BUDGET if vmem_budget is None else int(vmem_budget)
    bm, bn, bk = 256, 256, 512

    def over(bm, bn, bk):
        # the historical cost formula (f32 accumulator; out block ignored)
        return (bm * bk + bk * bn) * bytes_per_el + bm * bn * 4 > budget

    while over(bm, bn, bk):
        if bk > MIN_TILE:
            bk //= 2
        elif bm > MIN_TILE or bn > MIN_TILE:
            bm, bn = max(MIN_TILE, bm // 2), max(MIN_TILE, bn // 2)
        else:
            break                         # floor-and-bail: nothing to shrink
    return bm, bn, bk


def _divide_down(total: int, start: int) -> int:
    """Largest block <= start that divides ``total`` by repeated halving,
    flooring at MIN_TILE — the wrappers' divisibility loop."""
    b = min(start, total) if total >= MIN_TILE else start
    while total % b != 0 and b > MIN_TILE:
        b //= 2
    return b


def heuristic_plan(kernel: str, shape: Sequence[int], itemsize: int,
                   vmem_budget: Optional[int] = None) -> TilePlan:
    """The tile plan today's wrappers implicitly use — the stand-down path
    when a machine has no kernel-constants profile, and the golden baseline
    the bit-identity tests pin."""
    if kernel == "matmul":
        m, k, n = shape
        bm, bn, bk = heuristic_matmul_blocks(int(m), int(n), int(k),
                                             itemsize, vmem_budget)
        return TilePlan.make("matmul", source="heuristic",
                             bm=bm, bn=bn, bk=bk)
    if kernel == "trsm":
        return TilePlan.make("trsm", source="heuristic", block=256)
    if kernel == "cholesky":
        return TilePlan.make("cholesky", source="heuristic", block=256)
    if kernel == "flash_attention":
        _bh, sq, skv, _d = shape
        sqp = int(_round_up(sq, MIN_TILE))
        skvp = int(_round_up(skv, MIN_TILE))
        return TilePlan.make("flash_attention", source="heuristic",
                             bq=_divide_down(sqp, 256),
                             bkv=_divide_down(skvp, 256))
    if kernel == "ssm_scan":
        _bh, s, _dk, _dv = shape
        sp = int(_round_up(s, MIN_TILE))
        return TilePlan.make("ssm_scan", source="heuristic",
                             bs=_divide_down(sp, 256))
    raise ValueError(f"unknown kernel family {kernel!r}")


# ---------------------------------------------------------------------------
# Candidate grids
# ---------------------------------------------------------------------------


def candidate_tiles(kernel: str, shape: Sequence[int]
                    ) -> Dict[str, np.ndarray]:
    """The flattened candidate-tile grid for one kernel/shape: per block
    dimension every power-of-two size from the 128 lane tile up to (one
    step past) the relevant padded extent, meshed and flattened so the
    model scores all combinations in one vectorized pass.

    trsm/cholesky candidates are restricted to blocks that divide the
    problem edge — their wrappers fall back to the oracle otherwise.
    """
    dims = KERNEL_DIMS[kernel]
    extent = _dim_extents(kernel, shape)
    per_dim = []
    for d in dims:
        cap = int(_round_up(min(extent[d], CANDIDATE_SIZES[-1]), MIN_TILE))
        sizes = [s for s in CANDIDATE_SIZES if s <= cap] or [MIN_TILE]
        if cap not in sizes and cap <= CANDIDATE_SIZES[-1]:
            sizes.append(cap)             # the exact padded edge (no waste)
        if kernel in ("trsm", "cholesky"):
            n = int(extent[d])
            sizes = [s for s in sizes if n % s == 0] or [MIN_TILE]
        per_dim.append(sorted(set(sizes)))
    grids = np.meshgrid(*[np.asarray(s, dtype=float) for s in per_dim],
                        indexing="ij")
    return {d: g.reshape(-1) for d, g in zip(dims, grids)}


def _dim_extents(kernel: str, shape: Sequence[int]) -> Dict[str, int]:
    if kernel == "matmul":
        m, k, n = shape
        return {"bm": int(m), "bn": int(n), "bk": int(k)}
    if kernel == "trsm":
        _m, n = shape
        return {"block": int(n)}
    if kernel == "cholesky":
        (n,) = shape
        return {"block": int(n)}
    if kernel == "flash_attention":
        _bh, sq, skv, _d = shape
        return {"bq": int(sq), "bkv": int(skv)}
    if kernel == "ssm_scan":
        _bh, s, _dk, _dv = shape
        return {"bs": int(s)}
    raise ValueError(kernel)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class KernelPhases:
    """Per-phase predicted seconds, arrays over the candidate axes."""

    h2d: np.ndarray
    compute: np.ndarray
    d2h: np.ndarray

    @property
    def total(self) -> np.ndarray:
        return self.h2d + self.compute + self.d2h


class KernelModel:
    """Tile-parameterized kernel-time prediction for one machine profile."""

    def __init__(self, machine):
        kc = getattr(machine, "kernel_constants", None)
        if kc is None:
            raise ValueError(
                f"machine {getattr(machine, 'name', machine)!r} has no "
                "kernel_constants profile; use heuristic_plan instead")
        self.machine = machine
        self.kc = kc

    # -- evaluation -----------------------------------------------------------
    def phase_times(self, kernel: str, shape: Sequence[float],
                    tiles: Mapping[str, np.ndarray], itemsize: int, *,
                    mm_tile: Optional[TilePlan] = None,
                    causal: bool = False) -> KernelPhases:
        work = kernel_work(kernel, shape, tiles, itemsize,
                           mm_tile=mm_tile, causal=causal)
        return self.phases_of(work)

    def phases_of(self, work: KernelWork) -> KernelPhases:
        kc = self.kc
        pure = work.flops_mxu / kc.fma_rate + work.flops_vpu / kc.vpu_rate
        return KernelPhases(
            h2d=kc.c_h2d * work.launches + work.bytes_in / kc.bw_h2d,
            compute=pure * kc.overhead_factor
            + work.steps * kc.loop_overhead,
            d2h=kc.c_d2h * work.launches + work.bytes_out / kc.bw_d2h,
        )

    def feasible(self, kernel: str, shape: Sequence[float],
                 tiles: Mapping[str, np.ndarray], itemsize: int
                 ) -> np.ndarray:
        work = kernel_work(kernel, shape, tiles, itemsize)
        return work.vmem_bytes <= self.kc.vmem_bytes

    def time(self, kernel: str, shape: Sequence[float], plan: TilePlan,
             itemsize: int, *, mm_tile: Optional[TilePlan] = None,
             causal: bool = False) -> float:
        tiles = {d: np.asarray(float(v)) for d, v in plan.blocks}
        return float(self.phase_times(kernel, shape, tiles, itemsize,
                                      mm_tile=mm_tile, causal=causal).total)

    # -- selection ------------------------------------------------------------
    def choose(self, kernel: str, shape: Sequence[int], itemsize: int, *,
               mm_tile: Optional[TilePlan] = None,
               causal: bool = False) -> TilePlan:
        """The model-chosen tile: vectorized argmin of predicted total time
        over the VMEM-feasible candidate grid.  Falls back to the heuristic
        plan when no candidate fits (tiny budgets) — never raises."""
        cands = candidate_tiles(kernel, shape)
        work = kernel_work(kernel, shape, cands, itemsize,
                           mm_tile=mm_tile, causal=causal)
        ok = work.vmem_bytes <= self.kc.vmem_bytes
        if not bool(np.any(ok)):
            return heuristic_plan(kernel, shape, itemsize)
        total = self.phases_of(work).total
        j = int(np.argmin(np.where(ok, total, np.inf)))
        return TilePlan.make(kernel, source="model",
                             **{d: int(cands[d][j]) for d in cands})

    def best_time(self, kernel: str, shapes, itemsize: int) -> np.ndarray:
        """Model-optimal kernel seconds over an array of problem edges —
        the evaluate-hook entry point.  ``shapes`` is a dict of per-dim
        arrays broadcast against each other (e.g. square dgemm blocks:
        ``{"m": b, "k": b, "n": b}``)."""
        if kernel != "matmul":
            raise NotImplementedError(
                "best_time currently serves the dgemm evaluate hook only")
        m = np.asarray(shapes["m"], dtype=float).reshape(-1)
        k = np.asarray(shapes["k"], dtype=float).reshape(-1)
        n = np.asarray(shapes["n"], dtype=float).reshape(-1)
        edge = int(max(1.0, float(np.max([m.max(initial=1.0),
                                          k.max(initial=1.0),
                                          n.max(initial=1.0)]))))
        cands = candidate_tiles("matmul", (edge, edge, edge))
        tiles = {d: v[:, None] for d, v in cands.items()}   # (T, 1)
        work = kernel_work("matmul", (m[None, :], k[None, :], n[None, :]),
                           tiles, itemsize)
        ok = work.vmem_bytes <= self.kc.vmem_bytes
        total = np.where(ok, self.phases_of(work).total, np.inf)
        return np.min(total, axis=0)


# ---------------------------------------------------------------------------
# Tuner integration
# ---------------------------------------------------------------------------


def tiles_for_plan(machine, algo: str, n: int, g: int,
                   dtype: str) -> Dict[str, Dict[str, int]]:
    """Resolved tile plans for every local kernel an execution plan needs:
    the model's choice when the machine profile carries kernel constants,
    today's heuristic blocks otherwise.  Keys are kernel family names,
    values plain block dicts (JSON-shaped for the plan cache)."""
    kernels = ALGO_KERNELS.get(algo)
    if not kernels:
        return {}
    itemsize = itemsize_of(dtype)
    # dispatch pads the global problem to a multiple of g, then each rank
    # owns an (nb x nb) local block
    nb = int(math.ceil(float(n) / float(g))) if g else int(n)
    shapes = {"matmul": (nb, nb, nb), "trsm": (nb, nb), "cholesky": (nb,)}
    model = None
    if getattr(machine, "kernel_constants", None) is not None:
        model = KernelModel(machine)
    out: Dict[str, Dict[str, int]] = {}
    mm_tile: Optional[TilePlan] = None
    for kern in kernels:
        if model is None:
            tp = heuristic_plan(kern, shapes[kern], itemsize)
        else:
            tp = model.choose(kern, shapes[kern], itemsize, mm_tile=mm_tile)
        if kern == "matmul":
            mm_tile = tp
        out[kern] = tp.block_dict()
    return out
