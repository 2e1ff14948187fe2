"""The paper's performance-model primitives.

Three ingredients (paper §IV):

* ``ComputeModel`` — ``T_rout(d, t)``: time of a local numerical routine at
  block size ``d`` with ``t`` threads, from measured/parametric efficiency
  curves (paper Fig. 1).
* ``CommModel`` — the alpha-beta ideal time ``T_comm_ideal(w) = L + beta*w``
  (paper Fig. 2) scaled by the contention **calibration factors**:

      T_comm(w, d)          = C_avg(d)      * (L + beta*w)
      T_comm_sync(p, w, d)  = C_max(p, d)   * (L + beta*w)

  ``C_max`` is used when a synchronization makes every process wait for the
  slowest one; ``C_avg`` otherwise.  ``d`` is the "communication distance"
  (rank difference; hops on the torus, roughly).
* ``CalibrationTable`` / ``ParametricCalibration`` — the C surfaces, either
  tabulated from the contention micro-benchmark (paper Figs. 3-4) with
  interpolation + the paper's polynomial-regression extrapolation in ``p``,
  or as a fitted closed form.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Mapping, Optional, Sequence

import numpy as np

from .fitting import polyfit, polyval
from .machine import Machine


# ---------------------------------------------------------------------------
# Calibration surfaces
# ---------------------------------------------------------------------------


class Calibration:
    """Interface: C_avg(d) and C_max(p, d), both >= 1.

    The ``_vec`` variants evaluate elementwise over numpy arrays (the
    cost-IR evaluator in ``repro_torch.perf`` calls them on whole scenario
    grids); the default implementations fall back to the scalar methods,
    subclasses override with closed-form numpy where possible.
    """

    def c_avg(self, d: float) -> float:
        raise NotImplementedError

    def c_max(self, p: float, d: float) -> float:
        raise NotImplementedError

    def c_avg_vec(self, d):
        return np.vectorize(self.c_avg, otypes=[float])(d)

    def c_max_vec(self, p, d):
        return np.vectorize(self.c_max, otypes=[float])(p, d)


class IdentityCalibration(Calibration):
    """No contention — the paper's ``est_NoCal`` baseline."""

    def c_avg(self, d: float) -> float:
        return 1.0

    def c_max(self, p: float, d: float) -> float:
        return 1.0

    def c_avg_vec(self, d):
        return 1.0

    def c_max_vec(self, p, d):
        return 1.0


@dataclasses.dataclass
class ParametricCalibration(Calibration):
    """Closed-form surfaces, fit either to micro-benchmarks or to published
    tables.  Shape choices follow the paper's empirical findings (§IV):

    * ``C_avg`` depends only on distance, is >= 1 and grows with ``d``;
    * ``C_max`` additionally grows with the total process count ``p``.

    C_avg(d)    = 1 + a1 * log2(1 + d)^a2
    C_max(p, d) = C_avg(d) * (1 + b1 * log2(max(p, 2))^b2 * log2(1 + d)^b3)
    """

    a1: float = 0.15
    a2: float = 1.3
    b1: float = 0.02
    b2: float = 1.6
    b3: float = 0.9

    def c_avg(self, d: float) -> float:
        d = max(float(d), 0.0)
        return 1.0 + abs(self.a1) * math.log2(1.0 + d) ** abs(self.a2)

    def c_max(self, p: float, d: float) -> float:
        p = max(float(p), 2.0)
        d = max(float(d), 0.0)
        growth = abs(self.b1) * math.log2(p) ** abs(self.b2) * math.log2(1.0 + d) ** abs(self.b3)
        return self.c_avg(d) * (1.0 + growth)

    def c_avg_vec(self, d):
        d = np.maximum(np.asarray(d, dtype=float), 0.0)
        return 1.0 + abs(self.a1) * np.log2(1.0 + d) ** abs(self.a2)

    def c_max_vec(self, p, d):
        p = np.maximum(np.asarray(p, dtype=float), 2.0)
        d = np.maximum(np.asarray(d, dtype=float), 0.0)
        growth = (abs(self.b1) * np.log2(p) ** abs(self.b2)
                  * np.log2(1.0 + d) ** abs(self.b3))
        return self.c_avg_vec(d) * (1.0 + growth)

    def params(self) -> np.ndarray:
        return np.array([self.a1, self.a2, self.b1, self.b2, self.b3])

    @classmethod
    def from_params(cls, v: Sequence[float]) -> "ParametricCalibration":
        return cls(*[float(x) for x in v])


@dataclasses.dataclass
class CalibrationTable(Calibration):
    """Tabulated calibration surfaces from the contention micro-benchmark.

    ``avg``: distance -> C_avg.   ``mx``: (p, distance) -> C_max.
    Interpolation is linear in log2(distance); extrapolation of C_max beyond
    the largest measured ``p`` uses the paper's polynomial regression (in
    log2 p, per distance, degree ``extrapolation_degree``).
    """

    avg: Mapping[float, float]
    mx: Mapping[tuple[float, float], float]
    extrapolation_degree: int = 2

    def __post_init__(self):
        self._avg_d = np.array(sorted(self.avg.keys()), dtype=float)
        self._avg_v = np.array([self.avg[d] for d in self._avg_d], dtype=float)
        self._ps = np.array(sorted({p for p, _ in self.mx.keys()}), dtype=float)
        self._ds = np.array(sorted({d for _, d in self.mx.keys()}), dtype=float)
        # Dense (p, d) grid; missing cells filled by nearest measured p.
        grid = np.empty((self._ps.size, self._ds.size))
        for i, p in enumerate(self._ps):
            for j, d in enumerate(self._ds):
                if (p, d) in self.mx:
                    grid[i, j] = self.mx[(p, d)]
                else:
                    cands = [self.mx[(pp, dd)] for (pp, dd) in self.mx if dd == d]
                    grid[i, j] = float(np.mean(cands)) if cands else 1.0
        self._grid = grid
        # Per-distance polynomial regression of C_max in log2(p) — used for
        # extrapolation to core counts beyond the benchmark (paper §VI-B).
        self._poly = []
        deg = min(self.extrapolation_degree, max(1, self._ps.size - 1))
        for j in range(self._ds.size):
            self._poly.append(polyfit(np.log2(self._ps), grid[:, j], deg))

    @staticmethod
    def _interp_logd(ds: np.ndarray, vs: np.ndarray, d: float) -> float:
        d = max(float(d), float(ds[0]))
        x = math.log2(1.0 + d)
        xs = np.log2(1.0 + ds)
        return float(np.interp(x, xs, vs))

    def c_avg(self, d: float) -> float:
        return max(1.0, self._interp_logd(self._avg_d, self._avg_v, d))

    def c_max(self, p: float, d: float) -> float:
        p = max(float(p), float(self._ps[0]))
        if p <= self._ps[-1]:
            # bilinear: interp in log2 p between bracketing measured rows
            lo = int(np.searchsorted(self._ps, p, side="right") - 1)
            lo = min(max(lo, 0), self._ps.size - 1)
            hi = min(lo + 1, self._ps.size - 1)
            vlo = self._interp_logd(self._ds, self._grid[lo], d)
            vhi = self._interp_logd(self._ds, self._grid[hi], d)
            if hi == lo:
                return max(1.0, vlo)
            t = (math.log2(p) - math.log2(self._ps[lo])) / (
                math.log2(self._ps[hi]) - math.log2(self._ps[lo]))
            return max(1.0, vlo + t * (vhi - vlo))
        # Polynomial-regression extrapolation beyond the measured range.
        vals = np.array([polyval(c, math.log2(p)) for c in self._poly])
        return max(1.0, self._interp_logd(self._ds, vals, d))

    # -- vectorized surfaces (same math as the scalar methods, elementwise
    # over numpy arrays — the cost-IR evaluator calls these on whole
    # scenario grids) -------------------------------------------------------
    def c_avg_vec(self, d):
        d = np.maximum(np.asarray(d, dtype=float), float(self._avg_d[0]))
        x = np.log2(1.0 + d)
        xs = np.log2(1.0 + self._avg_d)
        return np.maximum(1.0, np.interp(x, xs, self._avg_v))

    def c_max_vec(self, p, d):
        p = np.maximum(np.asarray(p, dtype=float), float(self._ps[0]))
        d = np.asarray(d, dtype=float)
        p, d = np.broadcast_arrays(p, d)
        shape = p.shape
        pf = p.ravel()
        xs = np.log2(1.0 + self._ds)
        x = np.log2(1.0 + np.maximum(d.ravel(), float(self._ds[0])))
        ix = np.arange(pf.size)
        # in-range: distance-interpolate every measured p row, then lerp in
        # log2 p between the bracketing rows (as the scalar bilinear path)
        rows = np.stack([np.interp(x, xs, row) for row in self._grid]) \
            if pf.size else np.empty((self._ps.size, 0))
        lo = np.clip(np.searchsorted(self._ps, pf, side="right") - 1,
                     0, self._ps.size - 1)
        hi = np.minimum(lo + 1, self._ps.size - 1)
        vlo, vhi = rows[lo, ix], rows[hi, ix]
        lp, lps = np.log2(pf), np.log2(self._ps)
        denom = lps[hi] - lps[lo]
        t = np.where(denom > 0, (lp - lps[lo]) / np.where(denom > 0, denom, 1.0),
                     0.0)
        val = np.where(hi == lo, vlo, vlo + t * (vhi - vlo))
        # beyond the measured range: per-distance polynomial regression in
        # log2 p, then the same log-distance interpolation per element
        beyond = pf > self._ps[-1]
        if np.any(beyond):
            vals = np.stack([polyval(c, lp) for c in self._poly])
            k = np.clip(np.searchsorted(xs, x, side="right") - 1,
                        0, xs.size - 1)
            k1 = np.minimum(k + 1, xs.size - 1)
            y0, y1 = vals[k, ix], vals[k1, ix]
            dx = xs[k1] - xs[k]
            tt = np.clip(np.where(dx > 0, (x - xs[k])
                                  / np.where(dx > 0, dx, 1.0), 0.0), 0.0, 1.0)
            val = np.where(beyond, y0 + tt * (y1 - y0), val)
        return np.maximum(1.0, val).reshape(shape)

    # -- (de)serialization ---------------------------------------------------
    def to_json(self) -> str:
        return json.dumps({
            "avg": [[float(d), float(v)] for d, v in self.avg.items()],
            "max": [[float(p), float(d), float(v)] for (p, d), v in self.mx.items()],
            "deg": self.extrapolation_degree,
        })

    @classmethod
    def from_json(cls, s: str) -> "CalibrationTable":
        obj = json.loads(s)
        return cls(
            avg={d: v for d, v in obj["avg"]},
            mx={(p, d): v for p, d, v in obj["max"]},
            extrapolation_degree=obj.get("deg", 2),
        )


# ---------------------------------------------------------------------------
# Communication model
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CommModel:
    """alpha-beta model + calibration factors (paper §IV).

    ``w`` is in *words* (``machine.word_bytes`` bytes each), matching the
    paper's seconds/word ``beta``.
    """

    machine: Machine
    calibration: Calibration

    def t_ideal(self, w: float) -> float:
        return self.machine.latency + self.machine.inv_bandwidth * float(w)

    def t_comm(self, w: float, d: float) -> float:
        return self.calibration.c_avg(d) * self.t_ideal(w)

    def t_comm_sync(self, p: float, w: float, d: float) -> float:
        return self.calibration.c_max(p, d) * self.t_ideal(w)

    def without_calibration(self) -> "CommModel":
        return CommModel(self.machine, IdentityCalibration())


# ---------------------------------------------------------------------------
# Computation model
# ---------------------------------------------------------------------------

#: flops of each square-block routine at block size n (numpy-compatible:
#: the cost-IR evaluator calls these on whole scenario grids)
ROUTINE_FLOPS = {
    "dgemm": lambda n: 2.0 * n ** 3,
    "dtrsm": lambda n: 1.0 * n ** 3,
    "dsyrk": lambda n: 1.0 * n ** 3,
    "dpotrf": lambda n: n ** 3 / 3.0,
    "dgetrf": lambda n: 2.0 * n ** 3 / 3.0,
}


@dataclasses.dataclass
class EfficiencyCurve:
    """Fraction-of-peak of a local routine vs. block size (paper Fig. 1).

    eff(n) = eff_max * (1 - exp(-n / n0)), floored at ``eff_min``.
    Parameters are measured (``calibration.bench_routines``) or digitized
    from the paper's Fig. 1 for Hopper.
    """

    eff_max: float
    n0: float
    eff_min: float = 0.05

    def __call__(self, n: float) -> float:
        return max(self.eff_min, self.eff_max * (1.0 - math.exp(-float(n) / self.n0)))

    def ev(self, n):
        """Elementwise over numpy arrays (same curve as ``__call__``)."""
        n = np.asarray(n, dtype=float)
        return np.maximum(self.eff_min,
                          self.eff_max * (1.0 - np.exp(-n / self.n0)))


# Digitized from paper Fig. 1 (LibSci on Hopper, 6 threads / NUMA domain).
# dgetrf is not in Fig. 1; its curve follows dpotrf's shape with the higher
# plateau of a dgemm-rich panel factorization.
HOPPER_EFFICIENCY = {
    "dgemm": EfficiencyCurve(0.92, 350.0),
    "dtrsm": EfficiencyCurve(0.85, 500.0),
    "dsyrk": EfficiencyCurve(0.88, 420.0),
    "dpotrf": EfficiencyCurve(0.70, 600.0),
    "dgetrf": EfficiencyCurve(0.75, 550.0),
}

# TPU v5e MXU: efficiency driven by tile alignment (128x128 MXU); a block
# below ~512 leaves the MXU starved.  These are planning curves; on-hardware
# they would be re-measured by the same benchmark.
TPU_EFFICIENCY = {
    "dgemm": EfficiencyCurve(0.95, 640.0),
    "dtrsm": EfficiencyCurve(0.60, 1024.0),   # tri-solve maps poorly to MXU
    "dsyrk": EfficiencyCurve(0.90, 640.0),
    "dpotrf": EfficiencyCurve(0.45, 1024.0),
    "dgetrf": EfficiencyCurve(0.50, 1024.0),  # pivot/solve-heavy, like dpotrf
}


@dataclasses.dataclass
class ComputeModel:
    """``T_rout(d, t)`` (paper §IV).

    Thread scaling is linear in ``t`` up to ``machine.threads_per_unit`` —
    this matches the paper's use of ``T_rout(bs, t-1)`` when one thread is
    dedicated to communication in the overlapped variants.
    Rectangular operations are modeled as several consecutive square
    operations (paper §IV) via ``t_rect``.
    """

    machine: Machine
    efficiency: Mapping[str, EfficiencyCurve]

    def t_rout(self, rout: str, n: float, t: Optional[int] = None) -> float:
        if n <= 0:
            return 0.0
        t = self.machine.threads_per_unit if t is None else t
        t = max(1, min(t, self.machine.threads_per_unit))
        flops = ROUTINE_FLOPS[rout](float(n))
        eff = self.efficiency[rout](n)
        return flops / (self.machine.peak_flops_per_thread * t * eff)

    def t_rect(self, rout: str, m: float, n: float, t: Optional[int] = None) -> float:
        """(m, n) rectangular op as ceil(max/min) consecutive square ops of
        the smaller dimension (paper §IV)."""
        if m <= 0 or n <= 0:
            return 0.0
        small, big = (m, n) if m <= n else (n, m)
        return math.ceil(big / small) * self.t_rout(rout, small, t)


def hopper_compute_model() -> ComputeModel:
    from .machine import HOPPER
    return ComputeModel(HOPPER, HOPPER_EFFICIENCY)


def tpu_compute_model() -> ComputeModel:
    from .machine import TPU_V5E
    return ComputeModel(TPU_V5E, TPU_EFFICIENCY)
