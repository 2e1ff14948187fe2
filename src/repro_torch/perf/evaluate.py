"""Evaluation of cost-IR programs: scalar or vectorized, one calibration site.

``evaluate_program`` walks a :class:`repro_torch.perf.ir.Program` once and returns
arrays — evaluate a single scenario by passing scalars, or a whole
``(n, p, c, r)`` grid by passing numpy arrays (everything broadcasts).

Contention calibration is applied in exactly one place — the ``_t_comm`` /
``_t_comm_sync`` helpers below — and the paper's three estimator flavors
are evaluation *options*, not rebuilt contexts:

* ``est_Cal``   (``mode="cal"``, default): the context's C_avg/C_max surfaces;
* ``est_NoCal`` (``mode="nocal"``): C = 1 everywhere;
* ``est_ideal`` (``mode="ideal"``): C = 1 and zero latency — the pure
  bandwidth bound.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import numpy as np

from .ir import (Collective, Compute, Loop, Node, Overlap, P2P, Program, Seq,
                 SyncP2P)

#: bump when model semantics change incompatibly — consumers (the plan
#: cache) embed this so predictions from older equations are invalidated.
MODEL_VERSION = "ir-1"

EVAL_MODES = ("cal", "nocal", "ideal")


@dataclasses.dataclass(frozen=True)
class EvalOptions:
    """How to evaluate: which estimator flavor (see module docstring).

    ``kernel_tier=True`` routes dgemm-shaped Compute leaves through the
    intra-kernel model (``perf.kernel.KernelModel.best_time``: model-optimal
    tiled time including H2D/D2H transfer and launch overheads) instead of
    the efficiency-curve surface — only on machines whose profile carries a
    ``kernel_constants`` block; others keep the curve path.  Off by
    default, so existing predictions are bit-identical.
    """

    mode: str = "cal"
    kernel_tier: bool = False

    def __post_init__(self):
        if self.mode not in EVAL_MODES:
            raise ValueError(f"mode must be one of {EVAL_MODES}, "
                             f"got {self.mode!r}")


@dataclasses.dataclass
class PhaseCost:
    """One labeled phase of a program: exposed (overlap-aware) seconds plus
    the serialized comm/comp ledgers.  Arrays when the env is a grid."""

    exposed: np.ndarray
    comm: np.ndarray
    comp: np.ndarray


@dataclasses.dataclass
class EvalResult:
    """Structured evaluation output (supersedes the ad-hoc ``terms`` dict
    of the pre-IR ``ModelResult``): totals plus a per-phase breakdown, all
    broadcast to the scenario grid's shape."""

    total: np.ndarray
    comm: np.ndarray
    comp: np.ndarray
    phases: Dict[str, PhaseCost]

    def terms(self) -> Dict[str, np.ndarray]:
        """Back-compat view: phase label -> exposed seconds."""
        return {name: ph.exposed for name, ph in self.phases.items()}


class _Evaluator:
    """One walk of a program against (machine surface, env, options)."""

    def __init__(self, ctx, env: Dict[str, np.ndarray], options: EvalOptions):
        # Imported here, not at module top: repro_torch.core.algorithms imports
        # repro_torch.perf for its shims, so a top-level core import would cycle.
        from ..core.perfmodel import ROUTINE_FLOPS
        self.routine_flops = ROUTINE_FLOPS
        self.env = env
        self.options = options
        comm = ctx.comm
        self.machine = comm.machine
        self.latency = 0.0 if options.mode == "ideal" else comm.machine.latency
        self.beta = comm.machine.inv_bandwidth
        self.calibrated = options.mode == "cal"
        self.calibration = comm.calibration
        self.comp_machine = ctx.comp.machine
        self.efficiency = ctx.comp.efficiency
        self.kernel_model = None
        if options.kernel_tier and \
                getattr(self.comp_machine, "kernel_constants", None) \
                is not None:
            from .kernel import KernelModel
            self.kernel_model = KernelModel(self.comp_machine)
        self.phases: Dict[str, PhaseCost] = {}

    # -- the single calibration site ----------------------------------------
    def _t_ideal(self, w):
        return self.latency + self.beta * w

    def _c_avg(self, d):
        if not self.calibrated:
            return 1.0
        return self.calibration.c_avg_vec(d)

    def _c_max(self, d):
        if not self.calibrated:
            return 1.0
        return self.calibration.c_max_vec(self.env["p"], d)

    def _t_comm(self, w, d):
        return self._c_avg(d) * self._t_ideal(w)

    def _t_comm_sync(self, w, d):
        return self._c_max(d) * self._t_ideal(w)

    # -- leaf costs ----------------------------------------------------------
    def _t_rout(self, routine: str, block, threads):
        m = self.comp_machine
        block = np.asarray(block, dtype=float)
        if self.kernel_model is not None and routine == "dgemm":
            # intra-kernel tier: model-optimal tiled dgemm time (incl.
            # transfer and launch terms) for the local (b, b, b) block
            edges = np.maximum(block.reshape(-1), 1.0)
            t_k = self.kernel_model.best_time(
                "matmul", {"m": edges, "k": edges, "n": edges},
                int(m.word_bytes)).reshape(block.shape)
            return np.where(block > 0, t_k, 0.0)
        t = m.threads_per_unit if threads is None else threads
        t = np.clip(t, 1, m.threads_per_unit)
        flops = self.routine_flops[routine](block)
        eff = self.efficiency[routine].ev(block)
        out = flops / (m.peak_flops_per_thread * t * eff)
        return np.where(block > 0, out, 0.0)

    def _collective(self, kind: str, q, w, d):
        return _collective_time(kind, self.env["p"], q, w, d,
                                self._t_ideal, self._c_avg, self._c_max)

    # -- walk ----------------------------------------------------------------
    def run(self, root: Node):
        """Evaluate a program root, recording its top-level phases.

        Only the root Seq's direct children become named phases — a label
        on a Seq nested inside e.g. an Overlap branch is structural, not a
        phase (its cost is already accounted to the enclosing phase).
        """
        if not isinstance(root, Seq):
            e, cm, cp = self.visit(root)
            self._record("total", e, cm, cp)
            return e, cm, cp
        tot_e = tot_cm = tot_cp = 0.0
        for i, (label, child) in enumerate(root.children):
            e, cm, cp = self.visit(child)
            tot_e = tot_e + e
            tot_cm = tot_cm + cm
            tot_cp = tot_cp + cp
            self._record(label if label is not None else f"phase{i}",
                         e, cm, cp)
        return tot_e, tot_cm, tot_cp

    def visit(self, node: Node):
        """Returns the (exposed, comm, comp) second triple of ``node``."""
        if isinstance(node, Compute):
            t = None if node.threads is None else node.threads.ev(self.env)
            s = self._t_rout(node.routine, node.block.ev(self.env), t)
            return s, 0.0, s
        if isinstance(node, P2P):
            s = self._t_comm(node.words.ev(self.env), node.dist.ev(self.env))
            return s, s, 0.0
        if isinstance(node, SyncP2P):
            s = self._t_comm_sync(node.words.ev(self.env),
                                  node.dist.ev(self.env))
            return s, s, 0.0
        if isinstance(node, Collective):
            s = self._collective(node.kind, node.q.ev(self.env),
                                 node.words.ev(self.env),
                                 node.dist.ev(self.env))
            return s, s, 0.0
        if isinstance(node, Loop):
            e, cm, cp = self.visit(node.body)
            k = node.count.ev(self.env)
            return e * k, cm * k, cp * k
        if isinstance(node, Overlap):
            return self._overlap(node)
        if isinstance(node, Seq):
            tot_e = tot_cm = tot_cp = 0.0
            for _label, child in node.children:
                e, cm, cp = self.visit(child)
                tot_e = tot_e + e
                tot_cm = tot_cm + cm
                tot_cp = tot_cp + cp
            return tot_e, tot_cm, tot_cp
        raise TypeError(f"unknown IR node {type(node).__name__}")

    def _record(self, label: str, e, cm, cp):
        ph = self.phases.get(label)
        if ph is None:
            self.phases[label] = PhaseCost(np.asarray(e, dtype=float),
                                           np.asarray(cm, dtype=float),
                                           np.asarray(cp, dtype=float))
        else:
            ph.exposed = ph.exposed + e
            ph.comm = ph.comm + cm
            ph.comp = ph.comp + cp

    def _overlap(self, node: Overlap):
        ea, ca, pa = self.visit(node.comm)
        eb, cb, pb = self.visit(node.comp)
        if node.ramp is None:
            k = node.count.ev(self.env)
            return (np.maximum(ea, eb) * k, (ca + cb) * k, (pa + pb) * k)
        # Ramp form: iteration m=0..k-1 overlaps comm*m with comp*m^2.
        nb = np.asarray(node.ramp.ev(self.env), dtype=float)
        k = np.rint(nb)
        sum_m = k * nb - (k - 1.0) * k / 2.0 - k     # sum_decreasing(nb, 1)
        sum_m2 = (k - 1.0) * k * (2.0 * k - 1.0) / 6.0
        with np.errstate(divide="ignore", invalid="ignore"):
            mstar = np.where(eb > 0, ea / np.where(eb > 0, eb, 1.0), np.inf)
        m_hi = np.minimum(k - 1.0, np.floor(mstar))
        s1 = m_hi * (m_hi + 1.0) / 2.0
        s2 = sum_m2 - m_hi * (m_hi + 1.0) * (2.0 * m_hi + 1.0) / 6.0
        exposed = ea * s1 + eb * s2
        return (exposed,
                ca * sum_m + cb * sum_m2,
                pa * sum_m + pb * sum_m2)


def _build_env(n, p, c, r, machine) -> Dict[str, np.ndarray]:
    env = {"n": np.asarray(n, dtype=float),
           "p": np.asarray(p, dtype=float),
           "c": np.asarray(c, dtype=float),
           "r": np.asarray(r, dtype=float),
           "t": float(machine.threads_per_unit)}
    return env


def evaluate_program(program: Program, ctx, n, p, c=1, r=1,
                     options: Optional[EvalOptions] = None) -> EvalResult:
    """Evaluate ``program`` for scalar or array scenarios.

    ``n``/``p``/``c``/``r`` broadcast against each other; the result arrays
    have the broadcast shape (0-d for all-scalar input).
    """
    options = options or EvalOptions()
    env = _build_env(n, p, c, r, ctx.comp.machine)
    ev = _Evaluator(ctx, env, options)
    exposed, comm, comp = ev.run(program.root)
    shape = np.broadcast_shapes(*(np.shape(env[k]) for k in ("n", "p", "c", "r")))
    bc = lambda x: np.broadcast_to(np.asarray(x, dtype=float), shape)
    phases = {name: PhaseCost(bc(ph.exposed), bc(ph.comm), bc(ph.comp))
              for name, ph in ev.phases.items()}
    return EvalResult(bc(exposed), bc(comm), bc(comp), phases)


# ---------------------------------------------------------------------------
# Collective schedules (paper §V) — vectorized with per-step masking
# ---------------------------------------------------------------------------


def _steps_of(q):
    """``max(1, round(log2(max(2, q))))`` — per-scenario step count."""
    q = np.maximum(2.0, np.asarray(q, dtype=float))
    return np.maximum(1.0, np.rint(np.log2(q)))


def _collective_time(kind, p, q, w, d, t_ideal, c_avg, c_max):
    """Time of one collective schedule, elementwise over scenario arrays.

    Scenario step counts differ across a grid, so the recursive schedules
    are expanded to the grid's maximum step count with inactive steps
    masked to zero — per-step values match the scalar schedule exactly.
    """
    if kind == "reduce":
        return (_collective_time("redsca_sync", p, q, w, d, t_ideal, c_avg, c_max)
                + _collective_time("gather", p, q, w, d, t_ideal, c_avg, c_max))
    if kind == "bcast":
        return (_collective_time("scatter_sync", p, q, w, d, t_ideal, c_avg, c_max)
                + _collective_time("allgather", p, q, w, d, t_ideal, c_avg, c_max))
    if kind == "bcast_sync":
        return (_collective_time("scatter_sync", p, q, w, d, t_ideal, c_avg, c_max)
                + _collective_time("allgather_sync", p, q, w, d, t_ideal, c_avg, c_max))
    if kind == "inirepl":
        # c (the replication factor) arrives as q; distance (c-1)*p/c.
        c = np.asarray(q, dtype=float)
        with np.errstate(divide="ignore", invalid="ignore"):
            dist = (c - 1.0) * np.asarray(p, dtype=float) / c
        t = 2.0 * c_max(dist) * t_ideal(np.asarray(w, dtype=float))
        return np.where(c > 1, t, 0.0)

    q = np.asarray(q, dtype=float)
    w = np.asarray(w, dtype=float)
    d = np.asarray(d, dtype=float)
    active = q > 1.0
    s = _steps_of(q)
    smax = int(np.max(s)) if np.size(s) else 1
    total = np.zeros(np.broadcast_shapes(np.shape(q), np.shape(w), np.shape(d),
                                         np.shape(p)))
    if kind in ("redsca_sync", "scatter_sync"):
        for i in range(smax - 1):
            mask = active & (i < s - 1)
            step = c_avg((2 ** i) * d) * t_ideal(w / 2 ** (i + 1))
            total = total + np.where(mask, step, 0.0)
        last = c_max(2.0 ** (s - 1.0) * d) * t_ideal(w / 2.0 ** s)
        return total + np.where(active, last, 0.0)
    if kind == "allgather_sync":
        for i in range(smax - 1):
            mask = active & (i < s - 1)
            step = c_avg((2 ** i) * d) * t_ideal((w / q) * 2 ** i)
            total = total + np.where(mask, step, 0.0)
        last = c_max(2.0 ** (s - 1.0) * d) * t_ideal((w / q) * 2.0 ** (s - 1.0))
        return total + np.where(active, last, 0.0)
    if kind in ("gather", "allgather"):
        for i in range(smax):
            mask = active & (i < s)
            step = c_avg((2 ** i) * d) * t_ideal((w / q) * 2 ** i)
            total = total + np.where(mask, step, 0.0)
        return total
    raise ValueError(f"unknown collective kind {kind!r}")


@dataclasses.dataclass(frozen=True)
class CollectiveStep:
    """One step of an expanded collective schedule (scalar scenario)."""

    phase: str      # "reduce_scatter" | "scatter" | "gather" | "allgather" | "repl"
    words: float    # words each participating process sends in this step
    dist: float     # communication distance of the step's partner
    sync: bool      # True when the step closes a synchronization (C_max)


def collective_schedule(kind: str, q: float, w: float,
                        d: float = 1.0) -> Tuple[CollectiveStep, ...]:
    """Expand a collective's schedule for one scalar scenario — the
    step-level view used by the traffic-conservation property tests and
    the per-rank simulator.

    The per-step (words, dist, sync) match ``_collective_time`` exactly.
    Expansions are memoized on ``(kind, q, w, d)`` (hence the immutable
    tuple): the same collective step recurs across every iteration of a
    ``Loop`` body and across every shortlist candidate the tuner
    simulates.
    """
    return _collective_schedule(kind, float(q), float(w), float(d))


@functools.lru_cache(maxsize=4096)
def _collective_schedule(kind: str, q: float, w: float,
                         d: float) -> Tuple[CollectiveStep, ...]:
    if kind == "reduce":
        return (_collective_schedule("redsca_sync", q, w, d)
                + _collective_schedule("gather", q, w, d))
    if kind == "bcast":
        return (tuple(dataclasses.replace(st, phase="scatter")
                      for st in _collective_schedule("scatter_sync", q, w, d))
                + tuple(dataclasses.replace(st, phase="allgather")
                        for st in _collective_schedule("allgather", q, w, d)))
    if kind == "bcast_sync":
        return (tuple(dataclasses.replace(st, phase="scatter")
                      for st in _collective_schedule("scatter_sync", q, w, d))
                + _collective_schedule("allgather_sync", q, w, d))
    if q <= 1:
        return ()
    s = int(_steps_of(q))
    out: List[CollectiveStep] = []
    if kind in ("redsca_sync", "scatter_sync"):
        phase = "reduce_scatter" if kind == "redsca_sync" else "scatter"
        for i in range(s - 1):
            out.append(CollectiveStep(phase, w / 2 ** (i + 1), (2 ** i) * d,
                                      False))
        out.append(CollectiveStep(phase, w / 2 ** s, (2 ** (s - 1)) * d, True))
        return tuple(out)
    if kind in ("gather", "allgather", "allgather_sync"):
        phase = "gather" if kind == "gather" else "allgather"
        for i in range(s):
            sync = kind == "allgather_sync" and i == s - 1
            out.append(CollectiveStep(phase, (w / q) * 2 ** i, (2 ** i) * d,
                                      sync))
        return tuple(out)
    raise ValueError(f"unknown collective kind {kind!r}")
