"""Online recalibration: residuals -> a new machine-profile revision.

The paper parameterizes its models once from portable benchmarks; this
module closes the loop by *re*-parameterizing them from production
residuals (Bienz et al.'s measurement-driven refinement of alpha-beta
models, applied to the calibrated surfaces here):

* compute side — a Nelder--Mead fit (``core.fitting``) of a speed scale
  and a block-size shape factor against the compute-dominated residual
  rows updates every :class:`EfficiencyCurve`; speed beyond the physical
  ``eff_max`` ceiling is attributed to the machine's measured peak
  (exactly what ``measured_compute_model`` does offline);
* comm side — a ridge-regularized least-squares scale
  (``core.fitting.ridge_lstsq``) on the comm-dominated rows rescales the
  ``C_avg`` / ``C_max`` surfaces into a fresh :class:`CalibrationTable`.

Nothing is mutated in place: ``refit`` returns a :class:`RefitResult`
holding a revision-bumped :class:`Machine` plus new surfaces, and
``apply`` registers that revision, which changes the machine fingerprint
and thereby retires every stale plan-cache entry and telemetry file.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np

from ..core.fitting import multistart_nelder_mead, ridge_lstsq
from ..core.machine import KernelConstants, Machine
from ..core.perfmodel import Calibration, CalibrationTable, EfficiencyCurve
from ..perf.kernel import KernelModel, TilePlan, itemsize_of, kernel_work
from .residuals import Residual, split_comm_comp

#: fitted scales are clamped to this symmetric range — a refit may move a
#: profile a lot (the CPU fallback constants are conservative on purpose)
#: but never to absurdity.
MAX_SCALE = 64.0


@dataclasses.dataclass
class RefitResult:
    """A candidate machine-profile revision, not yet registered."""

    machine: Machine                            # revision bumped, peak updated
    efficiency: Dict[str, EfficiencyCurve]
    calibration: Calibration
    speed_scale: float          # fitted compute speed multiplier (>1: faster)
    shape_scale: float          # fitted multiplier on every curve's n0
    comm_scale: float           # fitted multiplier on C_avg / C_max
    n_comp_rows: int
    n_comm_rows: int

    @property
    def fingerprint(self) -> str:
        return self.machine.fingerprint()

    def apply(self, registry) -> Machine:
        """Register the revision (same name, bumped ``revision`` field) so
        subsequent planning and recording use it."""
        registry.register_machine(self.machine, self.efficiency,
                                  self.calibration, overwrite=True)
        return self.machine


def refit(rows: Sequence[Residual], registry=None,
          machine_name: Optional[str] = None, *,
          ridge_lam: float = 2.0, n_starts: int = 3) -> RefitResult:
    """Fit a profile revision to residual rows (``source == "model"``).

    ``ridge_lam`` regularizes both fits toward "no change": a handful of
    noisy runs nudges the profile, a consistent bias moves it.
    """
    if registry is None:
        from ..tuner.registry import DEFAULT_REGISTRY
        registry = DEFAULT_REGISTRY
    rows = [r for r in rows if r.source == "model"]
    if not rows:
        raise ValueError("refit needs at least one model-source residual row")
    machine_name = machine_name or rows[0].machine
    rows = [r for r in rows if r.machine == machine_name]
    if not rows:
        raise ValueError(f"no residual rows for machine {machine_name!r} — "
                         "refusing to emit an evidence-free revision")
    surface = registry.machine(machine_name)
    # One median-ratio representative per scenario: wall-clock spikes (GC,
    # noisy neighbors) must not drag the squared-loss fits.
    comm_rows, comp_rows = split_comm_comp(_robust_rows(rows))

    comm_scale = _fit_comm_scale(comm_rows, ridge_lam)
    speed, shape = _fit_compute(comp_rows, surface, comm_scale, ridge_lam,
                                n_starts)

    # Decompose the speed scale: what eff_max can absorb stays in the
    # curves; the remainder is a re-measured peak (curves cannot exceed 1).
    efficiency = {}
    max_eff = max(c.eff_max for c in surface.efficiency.values())
    eff_part = min(speed, 0.98 / max_eff) if max_eff > 0 else 1.0
    eff_part = max(eff_part, 0.02 / max_eff) if max_eff > 0 else 1.0
    peak_part = speed / eff_part
    for rout, curve in surface.efficiency.items():
        new_max = float(np.clip(curve.eff_max * eff_part, 1e-3, 0.98))
        new_n0 = float(np.clip(curve.n0 * shape, 1.0, 1e7))
        efficiency[rout] = EfficiencyCurve(
            new_max, new_n0, eff_min=min(curve.eff_min, new_max / 2.0))

    calibration = _scaled_calibration(surface.calibration, comm_scale,
                                      [r.p for r in rows])
    machine = dataclasses.replace(
        surface.machine,
        peak_flops_per_unit=surface.machine.peak_flops_per_unit * peak_part,
        revision=surface.machine.revision + 1)
    return RefitResult(machine=machine, efficiency=efficiency,
                       calibration=calibration, speed_scale=speed,
                       shape_scale=shape, comm_scale=comm_scale,
                       n_comp_rows=len(comp_rows), n_comm_rows=len(comm_rows))


def _robust_rows(rows: Sequence[Residual]) -> List[Residual]:
    """The median-log-ratio row of every (op, variant, n, p, c, phase)
    group — the fit's view of the data, outlier-proof by construction."""
    groups: Dict[tuple, List[Residual]] = {}
    for r in rows:
        key = (r.op, r.variant, r.n, r.p, r.c, r.phase)
        groups.setdefault(key, []).append(r)
    out: List[Residual] = []
    for group in groups.values():
        group.sort(key=lambda r: r.log_ratio)
        out.append(group[(len(group) - 1) // 2])
    return out


def _fit_comm_scale(comm_rows: Sequence[Residual], lam: float) -> float:
    """Ridge scalar in log space: measured ~= comm_scale * predicted."""
    if not comm_rows:
        return 1.0
    y = np.array([r.log_ratio for r in comm_rows])
    theta = ridge_lstsq(np.ones((y.size, 1)), y, lam=lam)[0]
    return float(np.clip(math.exp(theta), 1.0 / MAX_SCALE, MAX_SCALE))


def _block_of(r: Residual) -> float:
    """Nominal local block size of a residual's scenario — ``n / g`` on the
    (c, g, g) grid — used to re-evaluate the efficiency curve shape without
    re-walking the program."""
    g = math.sqrt(max(float(r.p) / max(float(r.c), 1.0), 1.0))
    return max(float(r.n) / g, 1.0)


def _fit_compute(comp_rows: Sequence[Residual], surface, comm_scale: float,
                 lam: float, n_starts: int):
    """Nelder--Mead over (log speed, log shape).

    A row's adjusted prediction divides its compute seconds by
    ``speed * eff_shape(block)/eff_old(block)`` and scales its comm
    seconds by the already-fitted ``comm_scale`` — so the fit targets
    exactly the part of the residual the compute model owns.
    """
    if not comp_rows:
        return 1.0, 1.0
    eff = surface.efficiency.get("dgemm") or next(iter(
        surface.efficiency.values()))
    blocks = np.array([_block_of(r) for r in comp_rows])
    meas = np.array([r.measured for r in comp_rows])
    pcomp = np.array([max(r.pred_comp, 0.0) for r in comp_rows])
    pcomm = np.array([max(r.pred_comm, 0.0) for r in comp_rows])
    # exposed may be < comm + comp under overlap: scale both ledgers and
    # keep the row's exposed/serialized ratio fixed
    exposed = np.array([r.predicted for r in comp_rows])
    serial = np.maximum(pcomp + pcomm, 1e-300)
    overlap_keep = exposed / serial
    eff_old = eff.ev(blocks)

    def loss(theta):
        la, lb = float(theta[0]), float(theta[1])
        a = math.exp(np.clip(la, -math.log(MAX_SCALE), math.log(MAX_SCALE)))
        b = math.exp(np.clip(lb, -2.0, 2.0))
        # same floor as EfficiencyCurve.ev, so the loss matches what the
        # rebuilt curve will actually predict after apply()
        eff_new = eff.eff_max * (1.0 - np.exp(-blocks / (b * eff.n0)))
        eff_new = np.maximum(eff_new, eff.eff_min)
        pred = (pcomp * eff_old / (a * eff_new)
                + pcomm * comm_scale) * overlap_keep
        resid = np.log(meas) - np.log(np.maximum(pred, 1e-300))
        return float(np.mean(resid ** 2)
                     + 0.01 * lam * (la ** 2 + lb ** 2) / max(meas.size, 1))

    theta, _ = multistart_nelder_mead(loss, np.array([0.0, 0.0]),
                                      n_starts=n_starts, max_iter=300)
    speed = float(np.clip(math.exp(theta[0]), 1.0 / MAX_SCALE, MAX_SCALE))
    shape = float(np.clip(math.exp(theta[1]), math.exp(-2.0), math.exp(2.0)))
    return speed, shape


# ---------------------------------------------------------------------------
# Kernel-tier recalibration: recorded per-kernel phase times -> new constants
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class KernelRefitResult:
    """A candidate kernel-constants revision, not yet registered."""

    machine: Machine                # revision bumped, kernel_constants swapped
    constants: KernelConstants
    compute_scale: float    # fitted multiplier on the issue/execute term
    loop_scale: float       # fitted multiplier on the per-grid-step term
    h2d_scale: float        # fitted time multiplier on the H2D phase
    d2h_scale: float        # fitted time multiplier on the D2H phase
    n_rows: int

    @property
    def fingerprint(self) -> str:
        return self.machine.fingerprint()

    def apply(self, registry) -> Machine:
        """Register the revision (efficiency/calibration surfaces carried
        over unchanged — this refit only owns the kernel constants)."""
        surface = registry.machine(self.machine.name)
        registry.register_machine(self.machine, surface.efficiency,
                                  surface.calibration, overwrite=True)
        return self.machine


def _kernel_rows(records, machine_name: str):
    """(record, KernelWork, measured-phase dict) for every usable
    ``kernel:<family>`` run record on this machine."""
    rows = []
    for rec in records:
        op = getattr(rec, "op", "")
        if not op.startswith("kernel:") or rec.machine != machine_name:
            continue
        meta = getattr(rec, "meta", None) or {}
        shape = meta.get("shape")
        tile = meta.get("tile")
        if not shape or not tile:
            continue
        kernel = op.split(":", 1)[1]
        itemsize = int(meta.get("itemsize") or itemsize_of(rec.dtype))
        tiles = {d: np.asarray(float(v)) for d, v in dict(tile).items()}
        mm_tile = meta.get("mm_tile")
        mm = TilePlan.from_blocks("matmul", mm_tile) if mm_tile else None
        try:
            work = kernel_work(kernel, [float(x) for x in shape], tiles,
                               itemsize, mm_tile=mm)
        except (ValueError, KeyError):
            continue
        rows.append((rec, work))
    return rows


def _phase_time_scale(meas: np.ndarray, pred: np.ndarray,
                      lam: float) -> float:
    """Ridge log-ratio scalar (regularized toward 1): how much longer the
    phase really takes than the model says."""
    keep = (meas > 0) & (pred > 0)
    if not np.any(keep):
        return 1.0
    y = np.log(meas[keep] / pred[keep])
    theta = ridge_lstsq(np.ones((y.size, 1)), y, lam=lam)[0]
    return float(np.clip(math.exp(theta), 1.0 / MAX_SCALE, MAX_SCALE))


def refit_kernels(records, registry=None,
                  machine_name: Optional[str] = None, *,
                  ridge_lam: float = 2.0) -> KernelRefitResult:
    """Fit a kernel-constants revision to recorded per-kernel phase times
    (``op == "kernel:<family>"`` run records, as ``benchmarks/bench_kernels``
    emits: ``meta`` carries shape/tile/itemsize, phases carry measured
    seconds for ``execute`` — or ``h2d``/``compute``/``d2h`` when the
    harness can split them).

    The compute side is a two-feature linear ridge fit: measured compute
    seconds against the model's issue/execute term and its per-grid-step
    term, regularized toward "no change", so consistent evidence moves
    ``overhead_factor`` and ``loop_overhead`` *independently* — that ratio
    is exactly what tile selection trades off.  Transfer phases (when
    present) refit as log-ratio scalars on ``bw_h2d`` / ``bw_d2h``.
    """
    if registry is None:
        from ..tuner.registry import DEFAULT_REGISTRY
        registry = DEFAULT_REGISTRY
    records = list(records)
    if machine_name is None:
        for rec in records:
            if getattr(rec, "op", "").startswith("kernel:"):
                machine_name = rec.machine
                break
    if machine_name is None:
        raise ValueError("refit_kernels needs at least one kernel:* record")
    surface = registry.machine(machine_name)
    kc = surface.machine.kernel_constants
    if kc is None:
        raise ValueError(f"machine {machine_name!r} has no kernel_constants "
                         "block to refit")
    rows = _kernel_rows(records, machine_name)
    if not rows:
        raise ValueError(f"no usable kernel:* records for {machine_name!r}")
    model = KernelModel(surface.machine)

    pure = np.array([float(w.flops_mxu / kc.fma_rate
                           + w.flops_vpu / kc.vpu_rate) for _r, w in rows])
    steps = np.array([float(w.steps) for _r, w in rows])
    phases = [model.phases_of(w) for _r, w in rows]
    pred_h2d = np.array([float(ph.h2d) for ph in phases])
    pred_d2h = np.array([float(ph.d2h) for ph in phases])

    def meas(name):
        return np.array([float(r.phases.get(name, 0.0)) for r, _w in rows])

    m_h2d, m_cmp, m_d2h, m_exec = (meas(k) for k in
                                   ("h2d", "compute", "d2h", "execute"))
    # un-split records: charge everything past the predicted transfer
    # phases to the compute fit (on the interpret path compute dominates)
    whole = (m_cmp == 0.0) & (m_exec > 0.0)
    m_cmp = np.where(whole,
                     np.maximum(m_exec - pred_h2d - pred_d2h, 0.0), m_cmp)

    # measured_compute ~= s_exec * (pure * overhead) + s_loop * (steps * loop)
    x1 = pure * kc.overhead_factor
    x2 = steps * kc.loop_overhead
    keep = (m_cmp > 0) & (x1 + x2 > 0)
    if np.any(keep):
        X = np.stack([x1[keep], x2[keep]], axis=1)
        y = m_cmp[keep] - X.sum(axis=1)
        # regularize the *deltas*: theta = 1 + ridge(X, y - X.1) pulls
        # toward "constants already right", mirroring the log-space fits
        scale = float(np.mean(X.sum(axis=1))) or 1.0
        theta = 1.0 + ridge_lstsq(X / scale, y / scale, lam=ridge_lam)
        s_exec, s_loop = (float(np.clip(t, 1.0 / MAX_SCALE, MAX_SCALE))
                          for t in theta)
    else:
        s_exec = s_loop = 1.0
    s_h2d = _phase_time_scale(m_h2d, pred_h2d, ridge_lam)
    s_d2h = _phase_time_scale(m_d2h, pred_d2h, ridge_lam)

    constants = dataclasses.replace(
        kc,
        overhead_factor=max(1.0, kc.overhead_factor * s_exec),
        loop_overhead=kc.loop_overhead * s_loop,
        bw_h2d=kc.bw_h2d / s_h2d,
        bw_d2h=kc.bw_d2h / s_d2h)
    machine = dataclasses.replace(surface.machine,
                                  kernel_constants=constants,
                                  revision=surface.machine.revision + 1)
    return KernelRefitResult(machine=machine, constants=constants,
                             compute_scale=s_exec, loop_scale=s_loop,
                             h2d_scale=s_h2d, d2h_scale=s_d2h,
                             n_rows=len(rows))


def _scaled_calibration(old: Calibration, comm_scale: float,
                        ps: Sequence[int]) -> Calibration:
    """A fresh CalibrationTable sampling the old surfaces scaled by the
    fitted factor (floored at the C >= 1 contract)."""
    if abs(comm_scale - 1.0) < 1e-12:
        return old
    grid_p = sorted({2.0, 4.0, 16.0, 64.0, 256.0}
                    | {float(max(p, 2)) for p in ps})
    grid_d = [1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0]
    avg = {d: max(1.0, float(old.c_avg(d)) * comm_scale) for d in grid_d}
    mx = {(p, d): max(1.0, float(old.c_max(p, d)) * comm_scale)
          for p in grid_p for d in grid_d}
    return CalibrationTable(avg=avg, mx=mx)
