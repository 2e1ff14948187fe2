"""The link-contention network engine: fluid max-rate transfers on a topology.

Each transfer occupies every directed link on its topology route.  At any
instant a transfer progresses at

    rate = 1 / (beta * max over its links of (instantaneous link load))

— the link-level max-rate model (Bienz et al.): the bottleneck link of the
path serializes the messages sharing it, and the rate *recovers* as
competing transfers drain.  The engine is a discrete-event loop over the
times at which the active set changes (a transfer starts or completes);
between events every rate is constant, so the fluid advance is exact.

Two implementations share that model:

* ``engine="vector"`` (default) — the sparse folded engine.  Routes come
  from CSR :class:`~repro_torch.sim.topology.ShiftPlan` link-incidence arrays
  (no per-transfer Python objects), transfers are lumped into symmetry
  classes by :mod:`repro_torch.sim.fold`, and the event loop advances whole
  classes with multiplicity-weighted link loads — ``O(classes)`` per
  event instead of ``O(ranks x links)``.
* ``engine="reference"`` — the plain per-transfer event loop, kept
  verbatim as the agreement oracle: CI gates the vector engine against it
  at 1e-6 relative on all paper programs.

When no link is ever shared (a crossbar, or a collision-free pattern on a
torus) every transfer completes at ``start + latency + beta * words`` —
exactly the ideal alpha-beta time the closed-form ``est_NoCal`` evaluator
charges, which anchors the cross-validation gate.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .fold import Fold, build_fold, trivial_fold
from .faults import FaultSpec, FaultyTopology
from .topology import ShiftPlan, Topology


@dataclasses.dataclass
class Transfer:
    """One message: ``words`` from node ``src`` to node ``dst``, injected at
    absolute time ``start``; ``latency`` is added once end-to-end."""

    src: int
    dst: int
    words: float
    start: float
    latency: float = 0.0


class LinkStats:
    """Per-link accounting accumulated across every delivery of a run.

    Internally dense numpy arrays indexed by physical link id (grown on
    demand); the ``words`` / ``busy`` / ``peak_load`` dict views preserve
    the sparse mapping older call sites and the trace emitter read."""

    def __init__(self):
        self._words = np.zeros(0)
        self._busy = np.zeros(0)
        self._peak = np.zeros(0, dtype=np.int64)

    def _ensure(self, n: int) -> None:
        if n > self._words.size:
            grow = max(n, 2 * self._words.size)
            for name in ("_words", "_busy", "_peak"):
                old = getattr(self, name)
                new = np.zeros(grow, dtype=old.dtype)
                new[:old.size] = old
                setattr(self, name, new)

    def add(self, links: np.ndarray, words, busy, peak) -> None:
        """Vectorized accumulation over *distinct* physical link ids
        (scalars broadcast)."""
        if links.size == 0:
            return
        self._ensure(int(links.max()) + 1)
        self._words[links] += words
        self._busy[links] += busy
        self._peak[links] = np.maximum(self._peak[links], peak)

    # -- sparse dict views (read-only; compat with the pre-fold layout) -----
    @property
    def words(self) -> Dict[int, float]:
        nz = np.flatnonzero(self._words)
        return dict(zip(nz.tolist(), self._words[nz].tolist()))

    @property
    def busy(self) -> Dict[int, float]:
        nz = np.flatnonzero(self._busy)
        return dict(zip(nz.tolist(), self._busy[nz].tolist()))

    @property
    def peak_load(self) -> Dict[int, int]:
        nz = np.flatnonzero(self._peak)
        return dict(zip(nz.tolist(), self._peak[nz].tolist()))

    def snapshot(self) -> Tuple[np.ndarray, np.ndarray]:
        """Checkpoint of the words/busy counters (peak loads are maxima and
        need no delta accounting)."""
        return self._words.copy(), self._busy.copy()

    def amplify_since(self, snap: Tuple[np.ndarray, np.ndarray],
                      k: float) -> None:
        """Repeat the traffic accumulated since ``snap`` another ``k``
        times — the stats-side counterpart of the executor's steady-state
        loop fast-forward (the skipped iterations carry the same per-link
        traffic as the last simulated one)."""
        words0, busy0 = snap
        self._words[:words0.size] += k * (self._words[:words0.size] - words0)
        self._words[words0.size:] *= 1.0 + k
        self._busy[:busy0.size] += k * (self._busy[:busy0.size] - busy0)
        self._busy[busy0.size:] *= 1.0 + k

    def utilization_histogram(self, total_time: float,
                              bins: int = 8) -> Dict[str, list]:
        """Histogram of per-link utilization (busy seconds / makespan)."""
        busy = self._busy[self._busy > 0]
        if busy.size == 0 or total_time <= 0:
            return {"edges": [0.0, 1.0], "counts": [0]}
        util = np.clip(busy / total_time, 0, 1)
        counts, edges = np.histogram(util, bins=bins, range=(0.0, 1.0))
        return {"edges": [float(e) for e in edges],
                "counts": [int(c) for c in counts]}


class Network:
    """Delivers batches of transfers on a topology, accumulating link stats
    and an event count across batches.

    ``fold=False`` opts out of symmetry folding (the engine still runs the
    vectorized sparse event loop over the trivial partition) — for
    asymmetric traffic where class detection cannot pay off.  ``events``
    counts logical transfer endpoints (one start + one completion per
    message, including messages simulated by a folded representative).

    ``faults`` injects per-component degradation (:mod:`repro_torch.sim.faults`):
    degraded links multiply the effective load the bottleneck max sees on
    that link, dead links reroute the pattern through a private
    :class:`~repro_torch.sim.faults.FaultyTopology` view (own plan/fold caches —
    the shared memoized topology is never poisoned), and fault onsets are
    evaluated per pattern (active iff the pattern's earliest start has
    reached the onset).  Both engines apply the same math, so the 1e-6
    agreement gate carries over to faulted runs.
    """

    def __init__(self, topology: Topology, latency: float, beta: float,
                 *, fold: bool = True, engine: str = "vector",
                 faults: Optional[FaultSpec] = None):
        if engine not in ("vector", "reference"):
            raise ValueError(f"engine must be 'vector' or 'reference', "
                             f"got {engine!r}")
        self.topology = topology
        self.latency = float(latency)
        self.beta = float(beta)
        self.fold = bool(fold)
        self.engine = engine
        self.faults = faults if faults is not None and not faults.empty \
            else None
        self.stats = LinkStats()
        self.events = 0
        # one FaultyTopology per active dead-link set ("epoch"): route/plan/
        # fold caches are per-epoch, keyed by which links are gone
        self._fault_topos: Dict[frozenset, FaultyTopology] = {}

    # -- fault plumbing ------------------------------------------------------
    def _topology_at(self, t: float) -> Topology:
        """The routing view active at pattern time ``t`` (the base topology
        until a dead-link onset passes)."""
        if self.faults is None or not self.faults.dead_links:
            return self.topology
        dead = self.faults.active_dead(t)
        if not dead:
            return self.topology
        topo = self._fault_topos.get(dead)
        if topo is None:
            topo = FaultyTopology(self.topology, dead)
            self._fault_topos[dead] = topo
        return topo

    def _link_scales(self, links: np.ndarray, t: float
                     ) -> Optional[np.ndarray]:
        if self.faults is None:
            return None
        return self.faults.link_scales(links, t)

    @staticmethod
    def _route_bneck(indptr: np.ndarray, link_idx: np.ndarray,
                     scales: np.ndarray, T: int) -> np.ndarray:
        """Per-transfer max link scale over its route (>= 1) — the ideal
        alpha-beta slowdown of a collision-free pattern under degraded
        links."""
        b = np.ones(T)
        routed = np.diff(indptr) > 0
        if routed.any():
            b[routed] = np.maximum.reduceat(scales[link_idx],
                                            indptr[:-1][routed])
        return np.maximum(b, 1.0)

    # -- the executor's fast path: one whole shift pattern -------------------
    def deliver_shift(self, starts: np.ndarray, words: float, d: int,
                      latency: float) -> np.ndarray:
        """Completion time per rank for the pattern ``rank -> rank + d``
        (all ``p`` ranks, ``words`` each, injected at ``starts``)."""
        p = starts.size
        self.events += 2 * p
        w = max(float(words), 0.0)
        t0 = float(starts.min()) if p else 0.0
        topo = self._topology_at(t0)
        plan = topo.shift_plan(p, d)
        scales = self._link_scales(plan.uniq_links, t0)
        if w <= 0.0:
            if plan.max_static_load <= 1:
                self.stats.add(plan.uniq_links, 0.0, 0.0, 1)
            return starts + latency
        if self.engine == "reference":
            self.events -= 2 * p  # the reference engine counts its own
            return self._reference_from_plan(
                starts, np.full(p, w), np.full(p, latency), plan, scales)
        if plan.max_static_load <= 1:
            # collision-free for any start times: ideal alpha-beta, times
            # the worst degraded-link scale on each route (if any)
            if scales is None:
                self.stats.add(plan.uniq_links, w, self.beta * w, 1)
                return starts + (latency + self.beta * w)
            bneck = self._route_bneck(plan.indptr, plan.link_idx, scales, p)
            self.stats.add(plan.uniq_links, w, self.beta * w * scales, 1)
            return starts + (latency + self.beta * w * bneck)
        fold = self._shift_fold(plan, starts, topo=topo, scales=scales)
        scale_m = self._fold_scales(fold, scales)
        done_k = self._solve(starts[fold.rep], np.full(fold.K, w), fold,
                             plan.uniq_links, scale_m)
        return done_k[fold.t_class] + latency

    @staticmethod
    def _fold_scales(fold: Fold, scales: Optional[np.ndarray]
                     ) -> Optional[np.ndarray]:
        """Per-link-class scale vector.  Valid because the fold was seeded
        by the scale classes (or is trivial), so a class never mixes
        scales — the scatter below assigns each class one value."""
        if scales is None:
            return None
        scale_m = np.ones(fold.M)
        scale_m[fold.l_class] = scales
        return scale_m

    def _shift_fold(self, plan: ShiftPlan, starts: np.ndarray,
                    topo: Optional[Topology] = None,
                    scales: Optional[np.ndarray] = None) -> Fold:
        """The cached symmetry fold of a shift pattern, seeded by the
        per-rank clock classes (equal-clock ranks may share a class;
        folding is keyed on the class *structure*, not the clock values,
        so a steady-state loop reuses one fold across iterations).  Link
        beta scales join both the seed and the cache key: the same
        (p, d, clocks) pattern folds differently before and after a fault
        onset."""
        if topo is None:
            topo = self.topology
        if starts.size and starts[0] == starts[-1] \
                and float(starts.min()) == float(starts.max()):
            labels = np.zeros(starts.size, dtype=np.int64)  # lockstep
        else:
            labels = np.unique(starts, return_inverse=True)[1]
            labels = labels.astype(np.int64).ravel()
        if not self.fold:
            return trivial_fold(plan.p, plan.indptr, plan.link_idx,
                                plan.owner, plan.uniq_links.size)
        link_seed = None
        sig = b""
        if scales is not None:
            link_seed = np.unique(scales, return_inverse=True)[1]
            link_seed = link_seed.astype(np.int64).ravel()
            sig = hashlib.blake2b(scales.tobytes(), digest_size=16).digest()
        key = (plan.p, plan.d,
               hashlib.blake2b(labels.tobytes(), digest_size=16).digest(),
               sig)
        fold = topo.fold_get(key)
        if fold is None:
            fold = build_fold(plan, labels, link_seed=link_seed)
            topo.fold_put(key, fold)
        return fold

    # -- generic transfer lists (tests, calibration, ad-hoc patterns) --------
    def deliver(self, transfers: Sequence[Transfer]) -> np.ndarray:
        """Completion time of every transfer (same order as input)."""
        T = len(transfers)
        if T == 0:
            return np.zeros(0)
        starts = np.array([tr.start for tr in transfers], dtype=float)
        words = np.array([max(tr.words, 0.0) for tr in transfers], dtype=float)
        lats = np.array([tr.latency for tr in transfers], dtype=float)
        t0 = float(starts.min())
        topo = self._topology_at(t0)
        paths = [topo.route(tr.src, tr.dst) for tr in transfers]
        lens = np.fromiter((len(pa) for pa in paths), dtype=np.int64, count=T)
        indptr = np.zeros(T + 1, dtype=np.int64)
        np.cumsum(lens, out=indptr[1:])
        flat = np.fromiter((l for pa in paths for l in pa),
                           dtype=np.int64, count=int(indptr[-1]))
        owner = np.repeat(np.arange(T, dtype=np.int64), lens)
        if self.engine == "reference":
            nl = int(flat.max()) + 1 if flat.size else 1
            dense = None
            if flat.size:
                uniq_l = np.unique(flat)
                s = self._link_scales(uniq_l, t0)
                if s is not None:
                    dense = np.ones(nl)
                    dense[uniq_l] = s
            return self._deliver_reference(starts, words, lats, owner, flat,
                                           nl, lens, link_scales=dense)
        self.events += 2 * T
        uniq, link_idx = np.unique(flat, return_inverse=True)
        link_idx = link_idx.astype(np.int64).ravel()
        scales = self._link_scales(uniq, t0) if uniq.size else None
        if flat.size == 0 or int(np.bincount(link_idx).max()) <= 1:
            # collision-free even with every transfer active: ideal times
            self.stats.add(flat, words[owner], self.beta * words[owner], 1)
            if scales is None:
                return starts + lats + self.beta * words
            bneck = self._route_bneck(indptr, link_idx, scales, T)
            return starts + lats + self.beta * words * bneck
        done = np.empty(T)
        live = words > 0.0
        done[~live] = starts[~live] + lats[~live]
        if not live.any():
            return done
        if live.all():
            sub_ptr, sub_idx, sub_owner, sub_uniq = \
                indptr, link_idx, owner, uniq
            idx_map = np.arange(T)
        else:
            idx_map = np.flatnonzero(live)
            keep = live[owner]
            sub_lens = lens[idx_map]
            sub_ptr = np.zeros(idx_map.size + 1, dtype=np.int64)
            np.cumsum(sub_lens, out=sub_ptr[1:])
            sub_uniq, sub_idx = np.unique(flat[keep], return_inverse=True)
            sub_idx = sub_idx.astype(np.int64).ravel()
            sub_owner = np.repeat(np.arange(idx_map.size, dtype=np.int64),
                                  sub_lens)
        static = np.bincount(sub_idx, minlength=sub_uniq.size)
        plan = ShiftPlan(
            p=idx_map.size, d=-1, indptr=sub_ptr,
            links=sub_uniq[sub_idx], uniq_links=sub_uniq, link_idx=sub_idx,
            owner=sub_owner, static_load=static,
            max_static_load=int(static.max()) if static.size else 0)
        seeds = np.unique(np.column_stack([starts[idx_map], words[idx_map]]),
                          axis=0, return_inverse=True)[1]
        sub_scales = scales if sub_uniq is uniq \
            else self._link_scales(sub_uniq, t0)
        link_seed = None
        if sub_scales is not None:
            link_seed = np.unique(sub_scales, return_inverse=True)[1]
            link_seed = link_seed.astype(np.int64).ravel()
        fold = build_fold(plan, seeds.astype(np.int64).ravel(),
                          link_seed=link_seed) if self.fold \
            else trivial_fold(plan.p, sub_ptr, sub_idx, sub_owner,
                              sub_uniq.size)
        scale_m = self._fold_scales(fold, sub_scales)
        done_k = self._solve(starts[idx_map][fold.rep],
                             words[idx_map][fold.rep], fold, sub_uniq,
                             scale_m)
        done[idx_map] = done_k[fold.t_class] + lats[idx_map]
        return done

    # -- the folded fluid event loop -----------------------------------------
    def _solve(self, starts: np.ndarray, words: np.ndarray,
               fold: Fold, uniq_links: np.ndarray,
               scale_m: Optional[np.ndarray] = None) -> np.ndarray:
        """Fluid completion times per class (latency excluded).  One event
        per change of the active class set; between events every class
        rate is constant, so the advance is exact.  ``scale_m`` multiplies
        the effective load per link *class* (degraded-link injection); raw
        loads still feed the peak/stats accounting."""
        K, M = fold.K, fold.M
        row_m, row_a, entry_k = fold.row_m, fold.row_a, fold.entry_k
        starts_ok = fold.nonempty  # classes with a route
        if K == 1:
            # one class in lockstep: a single fluid interval at the static
            # bottleneck — the event loop closed-form
            ra = row_a if scale_m is None else row_a * scale_m[row_m]
            bneck = max(float(ra.max()) if ra.size else 1.0, 1.0)
            w = float(words[0])
            dur = w * self.beta * bneck
            words_dep = np.zeros(M)
            busy_m = np.zeros(M)
            peak_m = np.zeros(M)
            words_dep[row_m] = row_a * w
            busy_m[row_m] = dur
            peak_m[row_m] = row_a
            self.stats.add(uniq_links, words_dep[fold.l_class],
                           busy_m[fold.l_class],
                           np.rint(peak_m[fold.l_class]).astype(np.int64))
            return starts + dur
        rem = words.astype(float).copy()
        done = np.full(K, np.inf)
        beta = self.beta
        t = float(starts.min())
        active = starts <= t
        pending = ~active
        words_dep = np.zeros(M)
        busy_m = np.zeros(M)
        peak_m = np.zeros(M)
        starts_view = starts
        while active.any() or pending.any():
            if not active.any():
                t = float(starts_view[pending].min())
                started = pending & (starts_view <= t)
                active |= started
                pending &= ~started
                continue
            act = active.astype(float)
            loads = np.bincount(row_m, weights=row_a * act[entry_k],
                                minlength=M)
            np.maximum(peak_m, loads, out=peak_m)
            eff = loads if scale_m is None else loads * scale_m
            bneck = np.ones(K)
            if starts_ok.any():
                seg_starts = fold.row_ptr[:-1][starts_ok]
                bneck[starts_ok] = np.maximum.reduceat(eff[row_m],
                                                       seg_starts)
            bneck = np.maximum(bneck, 1.0)
            fin = np.where(active, t + rem * (beta * bneck), np.inf)
            t_next = float(fin[active].min())
            if pending.any():
                t_next = min(t_next, float(starts_view[pending].min()))
            # Retire everything whose estimated finish coincides with this
            # event (clock-resolution epsilon): float cancellation in
            # (t + x) - t must not strand a class in endless sub-rounds.
            eps = 1e-12 * (abs(t_next) + 1.0)
            finished = active & (fin <= t_next + eps)
            dt = t_next - t
            if dt > 0:
                rate = 1.0 / (beta * bneck)
                moved = np.where(finished, rem, rate * dt) * act
                rem = np.where(active, np.maximum(rem - moved, 0.0), rem)
                words_dep += np.bincount(row_m,
                                         weights=row_a * moved[entry_k],
                                         minlength=M)
                busy_m[loads > 0] += dt
            t = t_next
            done[finished] = fin[finished]
            active &= ~finished
            started = pending & (starts_view <= t)
            active |= started
            pending &= ~started
        self.stats.add(uniq_links, words_dep[fold.l_class],
                       busy_m[fold.l_class],
                       np.rint(peak_m[fold.l_class]).astype(np.int64))
        return done

    # -- the plain per-transfer engine (agreement oracle) -------------------
    def _reference_from_plan(self, starts, words, lats, plan: ShiftPlan,
                             scales_u=None) -> np.ndarray:
        nl = int(plan.links.max()) + 1 if plan.links.size else 1
        if plan.links.size == 0 or plan.max_static_load <= 1:
            self.events += 2 * plan.p
            if scales_u is None:
                done = starts + lats + self.beta * words
            else:
                b = self._route_bneck(plan.indptr, plan.link_idx,
                                      scales_u, plan.p)
                done = starts + lats + self.beta * words * b
            self.stats.add(plan.links, words[plan.owner],
                           self.beta * words[plan.owner], 1)
            return done
        dense = None
        if scales_u is not None:
            dense = np.ones(nl)
            dense[plan.uniq_links] = scales_u
        return self._deliver_reference(starts, words, lats, plan.owner,
                                       plan.links, nl, np.diff(plan.indptr),
                                       link_scales=dense)

    def _deliver_reference(self, starts, words, lats, owner, flat, nl, plen,
                           link_scales=None):
        """The pre-fold engine, one event per active-set change over
        individual transfers — kept as the cross-validation oracle.
        ``link_scales`` is a dense per-physical-link effective-load
        multiplier (degraded-link injection)."""
        T = starts.size
        if flat.size == 0 or int(np.bincount(flat, minlength=nl).max()) <= 1:
            self.events += 2 * T
            if link_scales is None:
                done = starts + lats + self.beta * words
            else:
                b = np.ones(T)
                routed = plen > 0
                if routed.any():
                    offs = np.concatenate(
                        ([0], np.cumsum(plen[routed])))[:-1]
                    b[routed] = np.maximum.reduceat(link_scales[flat], offs)
                done = starts + lats + self.beta * words * np.maximum(b, 1.0)
            self.stats.add(flat, words[owner], self.beta * words[owner], 1)
            return done
        done = np.full(T, np.inf)
        rem = words.copy()
        zero = rem <= 0.0
        done[zero] = starts[zero] + lats[zero]
        live = ~zero
        if not live.any():
            return done
        # reduceat segments: flat is laid out path-by-path in transfer order
        routed = plen > 0
        offsets = np.concatenate(([0], np.cumsum(plen[routed])))[:-1]
        t = float(starts[live].min())
        active = live & (starts <= t)
        pending = live & ~active
        link_words = np.zeros(nl)
        link_busy = np.zeros(nl)
        link_peak = np.zeros(nl, dtype=np.intp)
        while active.any() or pending.any():
            if not active.any():
                t = float(starts[pending].min())
                started = pending & (starts <= t)
                active |= started
                pending &= ~started
                continue
            amask = active[owner]
            loads = np.bincount(flat[amask], minlength=nl)
            np.maximum(link_peak, loads, out=link_peak)
            eff = loads if link_scales is None else loads * link_scales
            bottleneck = np.ones(T)
            bottleneck[routed] = np.maximum.reduceat(eff[flat], offsets)
            bottleneck = np.maximum(bottleneck, 1.0)
            rate = np.where(active, 1.0 / (self.beta * bottleneck), 0.0)
            fin = np.where(active, t + rem * (self.beta * bottleneck), np.inf)
            t_next = float(fin[active].min())
            if pending.any():
                t_next = min(t_next, float(starts[pending].min()))
            eps = 1e-12 * (abs(t_next) + 1.0)
            finished = active & (fin <= t_next + eps)
            dt = t_next - t
            if dt > 0:
                moved = np.where(finished, rem, rate * dt)
                rem = np.where(active, np.maximum(rem - moved, 0.0), rem)
                link_words += np.bincount(flat[amask], minlength=nl,
                                          weights=moved[owner[amask]])
                link_busy[loads > 0] += dt
            t = t_next
            self.events += 1
            done[finished] = fin[finished] + lats[finished]
            active &= ~finished
            started = pending & (starts <= t)
            active |= started
            pending &= ~started
        touched = np.flatnonzero((link_words > 0) | (link_busy > 0)
                                 | (link_peak > 0))
        self.stats.add(touched, link_words[touched], link_busy[touched],
                       link_peak[touched])
        return done
