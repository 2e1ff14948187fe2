"""Per-rank discrete-event execution of cost-IR programs.

``simulate_program`` replays a :class:`repro_torch.perf.Program` on an explicit
:class:`~repro_torch.sim.topology.Topology`: every rank runs the same SPMD
program, and each communication leaf becomes the paper's calibration
traffic pattern — all ``p`` ranks simultaneously transferring to the rank
at the node's communication distance — delivered by the link-contention
:class:`~repro_torch.sim.network.Network`.  Node semantics:

* ``Compute``      — the fitted efficiency curves, exactly the closed-form
                     ``T_rout`` (one busy interval per rank);
* ``P2P``/``SyncP2P`` — a shift-by-``dist`` pattern; a rank proceeds when
                     both its outgoing and incoming message are delivered
                     (synchronization is *emergent*, not a ``C_max``
                     factor);
* ``Collective``   — expanded step-by-step via
                     ``repro_torch.perf.collective_schedule``, each step its own
                     shift pattern;
* ``Loop``         — unrolled, with steady-state fast-forwarding: once an
                     iteration's per-rank clock delta repeats, the rest
                     advance analytically (exact in lockstep execution);
                     the fractional part of a collapsed closed-form count
                     runs once with leaf costs scaled, and pure-compute
                     bodies collapse analytically;
* ``Overlap``      — both branches race from the same per-rank start
                     clocks and join at the elementwise max; the ramp form
                     unrolls iteration ``m`` with comm scaled by ``m`` and
                     comp by ``m^2``.

Contention scope is *per pattern* (the paper's calibration benchmark
semantics): messages of one communication step contend with each other —
at per-rank staggered start times once ranks have drifted — but not with
messages of other steps.  On a contention-free topology every transfer
takes its ideal alpha-beta time and ranks stay in lockstep, so the
simulated makespan equals the closed-form ``est_NoCal`` estimate to float
round-off — the cross-validation gate in ``tests/test_sim.py``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np

from ..core.perfmodel import ROUTINE_FLOPS
from ..perf import collective_schedule
from ..perf.ir import (Collective, Compute, Loop, Node, Overlap, P2P, Program,
                       Seq, SyncP2P)
from .faults import FaultSpec
from .network import Network
from .result import RankPhase, SimResult
from .topology import Topology, topology_for

#: hard ceiling on unrolled iterations of a single Loop/Overlap node —
#: a guard rail against accidentally simulating a million-step program,
#: not a tuning knob (the paper-scale programs unroll a few hundred).
MAX_UNROLL = 200_000


class ProgramSimulator:
    """One simulation of ``program`` for a scalar scenario on a topology."""

    def __init__(self, program: Program, ctx, topology: Topology,
                 n: float, p: int, c: float = 1, r: float = 1,
                 *, fold: bool = True, engine: str = "vector",
                 faults: Optional[FaultSpec] = None):
        p = int(p)
        if p < 1:
            raise ValueError(f"need p >= 1, got {p}")
        if p > topology.n_nodes:
            raise ValueError(f"p={p} exceeds topology size "
                             f"{topology.n_nodes} ({topology!r})")
        self.program = program
        self.topology = topology
        self.p = p
        self.env = {"n": float(n), "p": float(p), "c": float(c),
                    "r": float(r),
                    "t": float(ctx.comp.machine.threads_per_unit)}
        self.comp_machine = ctx.comp.machine
        self.efficiency = ctx.comp.efficiency
        self.latency = ctx.comm.machine.latency
        self.beta = ctx.comm.machine.inv_bandwidth
        self.faults = faults if faults is not None and not faults.empty \
            else None
        self._max_onset = self.faults.max_onset_s if self.faults else 0.0
        self.net = Network(topology, self.latency, self.beta,
                           fold=fold, engine=engine, faults=self.faults)
        self.compute_events = 0
        self.phases: Dict[str, RankPhase] = {}

    # -- leaf costs ----------------------------------------------------------
    def _t_rout(self, node: Compute) -> float:
        """Identical math to the closed-form evaluator's ``_t_rout``."""
        block = float(node.block.ev(self.env))
        if block <= 0:
            return 0.0
        m = self.comp_machine
        t = (m.threads_per_unit if node.threads is None
             else float(node.threads.ev(self.env)))
        t = min(max(t, 1.0), float(m.threads_per_unit))
        flops = ROUTINE_FLOPS[node.routine](block)
        eff = float(self.efficiency[node.routine].ev(block))
        return flops / (m.peak_flops_per_thread * t * eff)

    def _shift(self, clocks: np.ndarray, words: float, dist: float,
               scale: float) -> Tuple[np.ndarray, np.ndarray]:
        """All p ranks transfer ``words`` to rank+round(dist) starting at
        their current clocks; a rank's clock advances to the max of its
        outgoing and incoming delivery.  Returns (clocks', exposed)."""
        p = self.p
        d = int(round(float(dist))) % p
        w = float(words) * scale
        lat = self.latency * scale
        if d == 0:
            # local copy (or p == 1): ideal time, never contended
            done = clocks + (lat + self.beta * w)
            self.net.events += 2 * p
            return done, done - clocks
        done = self.net.deliver_shift(clocks, w, d, lat)
        rolled = np.empty_like(done)  # roll(done, d)[r] = done[r - d]
        rolled[:d] = done[p - d:]
        rolled[d:] = done[:p - d]
        new = np.maximum(done, rolled)
        return new, new - clocks

    # -- walk ----------------------------------------------------------------
    def _zeros(self) -> np.ndarray:
        return np.zeros(self.p)

    def _compute_only_seconds(self, node: Node) -> Optional[float]:
        """Unscaled seconds of a communication-free subtree, or None.
        Pure-compute loops advance every rank identically, so they collapse
        to ``count * body`` without unrolling (exactly the closed form)."""
        if isinstance(node, Compute):
            return self._t_rout(node)
        if isinstance(node, Seq):
            total = 0.0
            for _label, ch in node.children:
                s = self._compute_only_seconds(ch)
                if s is None:
                    return None
                total += s
            return total
        if isinstance(node, Loop):
            s = self._compute_only_seconds(node.body)
            if s is None:
                return None
            return max(float(node.count.ev(self.env)), 0.0) * s
        return None

    def _walk(self, node: Node, clocks: np.ndarray, scale: float
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Advance per-rank ``clocks`` through ``node``; returns
        (clocks', comm_ledger_delta, comp_ledger_delta)."""
        if isinstance(node, Compute):
            dur = self._t_rout(node) * scale
            self.compute_events += self.p
            if self.faults is not None:
                rs = self.faults.compute_scales(clocks)
                if rs is not None:
                    dvec = dur * rs
                    return clocks + dvec, self._zeros(), dvec
            return clocks + dur, self._zeros(), np.full(self.p, dur)
        if isinstance(node, (P2P, SyncP2P)):
            new, exposed = self._shift(clocks, node.words.ev(self.env),
                                       node.dist.ev(self.env), scale)
            return new, exposed, self._zeros()
        if isinstance(node, Collective):
            return self._collective(node, clocks, scale)
        if isinstance(node, Seq):
            cm, cp = self._zeros(), self._zeros()
            for _label, ch in node.children:
                clocks, a, b = self._walk(ch, clocks, scale)
                cm, cp = cm + a, cp + b
            return clocks, cm, cp
        if isinstance(node, Loop):
            return self._loop(node, clocks, scale)
        if isinstance(node, Overlap):
            return self._overlap(node, clocks, scale)
        raise TypeError(f"unknown IR node {type(node).__name__}")

    def _collective(self, node: Collective, clocks: np.ndarray, scale: float
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        q = float(node.q.ev(self.env))
        w = float(node.words.ev(self.env))
        d = float(node.dist.ev(self.env))
        cm = self._zeros()
        if node.kind == "inirepl":
            # initial c-fold replication: two transfers at distance
            # (c-1)*p/c (q carries c), zero when unreplicated
            if q > 1:
                dist = (q - 1.0) * self.env["p"] / q
                for _ in range(2):
                    clocks, exposed = self._shift(clocks, w, dist, scale)
                    cm = cm + exposed
            return clocks, cm, self._zeros()
        for step in collective_schedule(node.kind, q, w, d):
            clocks, exposed = self._shift(clocks, step.words, step.dist, scale)
            cm = cm + exposed
        return clocks, cm, self._zeros()

    def _split_count(self, count: float) -> Tuple[int, float]:
        count = max(float(count), 0.0)
        whole = int(math.floor(count + 1e-9))
        frac = max(count - whole, 0.0)
        if whole > MAX_UNROLL:
            raise ValueError(f"loop count {count:g} exceeds MAX_UNROLL="
                             f"{MAX_UNROLL}; not simulatable")
        return whole, frac

    def _iterate(self, body_fn, clocks: np.ndarray, whole: int
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Run ``whole`` identical iterations of ``body_fn`` with
        steady-state fast-forwarding: once the per-rank clock delta of an
        iteration matches the previous one (to 1e-9 relative), the
        remaining repetitions advance analytically as ``k * delta``.

        In lockstep (contention-free) execution the delta is constant from
        the first iteration, so the fast-forward is exact — it reproduces
        the closed form's linear ``count * body`` charging.  Under
        contention the schedule settles into a periodic steady state after
        a few iterations and the extrapolation preserves it."""
        cm, cp = self._zeros(), self._zeros()
        prev_delta = None
        i = 0
        while i < whole:
            before = clocks
            snap = (self.net.stats.snapshot(), self.net.events,
                    self.compute_events)
            clocks, a, b = body_fn(clocks)
            cm, cp = cm + a, cp + b
            i += 1
            delta = clocks - before
            # fast-forwarding is unsafe while a fault onset is still ahead
            # of any rank: the iteration just simulated is not yet the
            # steady state the extrapolation would repeat
            ff_ok = self.faults is None \
                or float(before.min()) >= self._max_onset
            if ff_ok and prev_delta is not None and i < whole and np.allclose(
                    delta, prev_delta, rtol=1e-9,
                    atol=1e-12 * (float(np.abs(delta).max()) + 1e-300)):
                k = whole - i
                clocks = clocks + k * delta
                cm, cp = cm + k * a, cp + k * b
                # the skipped iterations carry the same traffic/events as
                # the one just simulated — keep the diagnostics honest
                self.net.stats.amplify_since(snap[0], k)
                self.net.events += k * (self.net.events - snap[1])
                self.compute_events += k * (self.compute_events - snap[2])
                break
            prev_delta = delta
        return clocks, cm, cp

    def _loop(self, node: Loop, clocks: np.ndarray, scale: float
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        count = max(float(node.count.ev(self.env)), 0.0)
        pure = self._compute_only_seconds(node.body)
        if pure is not None and self.faults is not None \
                and self.faults.slow_ranks:
            pure = None  # slow ranks break the all-ranks-identical collapse
        if pure is not None:
            dur = pure * scale * count
            self.compute_events += self.p
            return clocks + dur, self._zeros(), np.full(self.p, dur)
        whole, frac = self._split_count(count)
        clocks, cm, cp = self._iterate(
            lambda c: self._walk(node.body, c, scale), clocks, whole)
        if frac > 1e-12:
            clocks, a, b = self._walk(node.body, clocks, scale * frac)
            cm, cp = cm + a, cp + b
        return clocks, cm, cp

    def _overlap_once(self, node: Overlap, clocks: np.ndarray,
                      cscale: float, pscale: float
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        ca_clk, ca_cm, ca_cp = self._walk(node.comm, clocks, cscale)
        cb_clk, cb_cm, cb_cp = self._walk(node.comp, clocks, pscale)
        return (np.maximum(ca_clk, cb_clk), ca_cm + cb_cm, ca_cp + cb_cp)

    def _overlap(self, node: Overlap, clocks: np.ndarray, scale: float
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        cm, cp = self._zeros(), self._zeros()
        if node.ramp is not None:
            # right-looking ramp: trailing size m shrinks k-1 .. 1; comm is
            # linear in m, the update quadratic (see perf.ir.Overlap)
            k = int(np.rint(float(node.ramp.ev(self.env))))
            if k - 1 > MAX_UNROLL:
                raise ValueError(f"ramp of {k} iterations exceeds "
                                 f"MAX_UNROLL={MAX_UNROLL}")
            for m in range(k - 1, 0, -1):
                clocks, a, b = self._overlap_once(node, clocks,
                                                 scale * m, scale * m * m)
                cm, cp = cm + a, cp + b
            return clocks, cm, cp
        whole, frac = self._split_count(float(node.count.ev(self.env)))
        clocks, cm, cp = self._iterate(
            lambda c: self._overlap_once(node, c, scale, scale), clocks, whole)
        if frac > 1e-12:
            clocks, a, b = self._overlap_once(node, clocks,
                                              scale * frac, scale * frac)
            cm, cp = cm + a, cp + b
        return clocks, cm, cp

    # -- entry point ---------------------------------------------------------
    def _record(self, label: str, start, exposed, cm, cp) -> None:
        ph = self.phases.get(label)
        if ph is None:
            self.phases[label] = RankPhase(start, exposed, cm, cp)
        else:
            ph.exposed = ph.exposed + exposed
            ph.comm = ph.comm + cm
            ph.comp = ph.comp + cp

    def run(self) -> SimResult:
        """Simulate the program; top-level phases follow the evaluator's
        convention (only the root Seq's direct children are phases)."""
        clocks = self._zeros()
        tot_cm, tot_cp = self._zeros(), self._zeros()
        root = self.program.root
        children = (root.children if isinstance(root, Seq)
                    else ((None, root),))
        for i, (label, child) in enumerate(children):
            before = clocks
            clocks, cm, cp = self._walk(child, clocks, 1.0)
            tot_cm, tot_cp = tot_cm + cm, tot_cp + cp
            name = label if label is not None else (
                f"phase{i}" if isinstance(root, Seq) else "total")
            self._record(name, before, clocks - before, cm, cp)
        return SimResult(
            algo=self.program.algo, variant=self.program.variant,
            n=self.env["n"], p=self.p, c=self.env["c"], r=self.env["r"],
            topology=repr(self.topology),
            total=float(clocks.max()), per_rank=clocks,
            comm=tot_cm, comp=tot_cp, phases=self.phases,
            link_stats=self.net.stats,
            events=self.net.events + self.compute_events,
            engine=self.net.engine)


def simulate_program(program: Program, ctx, topology: Topology,
                     n: float, p: int, c: float = 1, r: float = 1,
                     *, fold: bool = True, engine: str = "vector",
                     faults: Optional[FaultSpec] = None) -> SimResult:
    """Simulate one scalar scenario of ``program`` on ``topology`` using
    the machine surfaces of ``ctx`` (the same ``AlgoContext`` the
    closed-form evaluator takes).  Ranks 0..p-1 map to topology nodes
    0..p-1.

    ``fold=False`` opts out of rank-symmetry folding (still the
    vectorized sparse engine) for traffic the class detector cannot lump;
    ``engine="reference"`` replays through the plain per-transfer event
    loop — the agreement oracle the CI gate compares against;
    ``faults`` injects per-component degradation
    (:class:`~repro_torch.sim.faults.FaultSpec`)."""
    return ProgramSimulator(program, ctx, topology, n, p, c, r,
                            fold=fold, engine=engine, faults=faults).run()


def simulate_programs(programs, ctx, scenarios, *, topology=None,
                      machine=None, fold: bool = True,
                      engine: str = "vector", strict: bool = True,
                      faults: Optional[FaultSpec] = None):
    """Batch simulation: replay ``programs`` over ``scenarios`` in one
    call, sharing every route/fold cache across runs.

    ``programs`` is one :class:`~repro_torch.perf.ir.Program` (broadcast over
    all scenarios) or a sequence zipped 1:1 with ``scenarios``; each
    scenario is a ``{"n": ..., "p": ..., "c": ..., "r": ...}`` mapping
    (``c``/``r`` default to 1).  ``topology`` pins one explicit topology
    for every run; otherwise each run gets ``topology_for(machine, p)``
    — memoized, so same-``p`` candidates share one instance and its
    caches.  ``strict=False`` turns per-run failures into ``None``
    entries instead of raising (the telemetry join uses this: one bad
    scenario must not sink the batch).

    This is the tuner's shortlist re-rank and telemetry's ``include_sim``
    entry point: the expensive artifacts — CSR link-incidence plans and
    symmetry folds — are keyed on the topology instance, so simulating k
    candidates costs one route construction, not k.
    """
    if topology is None and machine is None:
        raise ValueError("pass topology= or machine= (a machine profile "
                         "with torus_dims); otherwise every scenario would "
                         "silently simulate contention-free")
    scenarios = list(scenarios)
    if isinstance(programs, Program):
        programs = [programs] * len(scenarios)
    else:
        programs = list(programs)
        if len(programs) != len(scenarios):
            raise ValueError(f"{len(programs)} programs vs "
                             f"{len(scenarios)} scenarios")
    results = []
    for prog, scen in zip(programs, scenarios):
        try:
            p = int(scen["p"])
            topo = topology if topology is not None \
                else topology_for(machine, p)
            results.append(ProgramSimulator(
                prog, ctx, topo, float(scen["n"]), p,
                float(scen.get("c", 1)), float(scen.get("r", 1)),
                fold=fold, engine=engine, faults=faults).run())
        except Exception:
            if strict:
                raise
            results.append(None)
    return results
