"""Fault & degradation injection for the per-rank simulator.

Real machines degrade: a sick node computes slowly, a congested or
flapping link delivers at a fraction of its bandwidth, a dead link drops
out of the routing fabric entirely.  The paper's C_max/C_avg gap *is* a
degradation signature — this module makes those signatures injectable so
the detect -> diagnose -> re-plan loop can be exercised end to end.

A :class:`FaultSpec` is declarative and immutable:

* :class:`SlowRank`     — per-rank compute-time multiplier (``scale > 1``
                          means slower), applied at every ``Compute`` leaf
                          the executor charges to that rank;
* :class:`DegradedLink` — per-link beta multiplier: traffic crossing the
                          link behaves as if the link's instantaneous
                          load were ``scale`` times higher, so a lone
                          transfer on a degraded link takes ``scale``
                          times its ideal alpha-beta time and contention
                          on it is amplified by the same factor;
* :class:`DeadLink`     — the link is removed from routing.  A torus
                          reroutes dimension-by-dimension along the other
                          ring direction (the only alternative a
                          deterministic DOR router has); when both
                          directions are dead — or the topology has no
                          alternative path, e.g. a crossbar channel —
                          :class:`UnreachableError` is raised rather than
                          silently mis-routing.

Every fault carries an optional ``onset_s``.  Onset semantics are
*pattern-granular*: a link fault is active for a delivery iff the
pattern's earliest start time has reached the onset, and a compute fault
is active for a leaf iff the rank's clock has.  This keeps the folded
vector engine and the per-transfer reference engine trivially in agreement (both
evaluate the same predicate on the same inputs), so the existing 1e-6
agreement gate extends to faulted runs unchanged.

Interaction with rank-symmetry folding (DESIGN.md §7): per-link beta
scales are folded into the *seed* of the color refinement, so faulted
links land in their own link classes and slowed transfers split off by
their clock classes — the coarsest equitable partition respects the
fault structure by construction.  Where refinement cannot converge the
engine falls back to the trivial partition (stand-down): folding under
faults degrades to the plain vectorized engine, never to a wrong answer.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Dict, FrozenSet, Iterable, List, Optional, Tuple

import numpy as np

from .topology import Topology, Torus


class UnreachableError(RuntimeError):
    """No route exists between two nodes once dead links are removed."""


@dataclasses.dataclass(frozen=True)
class SlowRank:
    """Rank ``rank`` computes ``scale`` times slower from ``onset_s``."""

    rank: int
    scale: float
    onset_s: float = 0.0

    def __post_init__(self):
        if self.rank < 0:
            raise ValueError(f"rank must be >= 0, got {self.rank}")
        if not self.scale > 0:
            raise ValueError(f"compute scale must be > 0, got {self.scale}")
        if self.onset_s < 0:
            raise ValueError(f"onset_s must be >= 0, got {self.onset_s}")


@dataclasses.dataclass(frozen=True)
class DegradedLink:
    """Link ``link`` behaves ``scale`` times slower from ``onset_s``.

    ``scale >= 1``: this models degradation (the fluid engine's rate
    floor assumes effective loads never drop below the true load)."""

    link: int
    scale: float
    onset_s: float = 0.0

    def __post_init__(self):
        if self.link < 0:
            raise ValueError(f"link must be >= 0, got {self.link}")
        if not self.scale >= 1.0:
            raise ValueError(f"link scale must be >= 1, got {self.scale}")
        if self.onset_s < 0:
            raise ValueError(f"onset_s must be >= 0, got {self.onset_s}")


@dataclasses.dataclass(frozen=True)
class DeadLink:
    """Link ``link`` is removed from the routing fabric at ``onset_s``."""

    link: int
    onset_s: float = 0.0

    def __post_init__(self):
        if self.link < 0:
            raise ValueError(f"link must be >= 0, got {self.link}")
        if self.onset_s < 0:
            raise ValueError(f"onset_s must be >= 0, got {self.onset_s}")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """A declarative bundle of injected degradations (see module doc)."""

    slow_ranks: Tuple[SlowRank, ...] = ()
    degraded_links: Tuple[DegradedLink, ...] = ()
    dead_links: Tuple[DeadLink, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "slow_ranks", tuple(self.slow_ranks))
        object.__setattr__(self, "degraded_links",
                           tuple(self.degraded_links))
        object.__setattr__(self, "dead_links", tuple(self.dead_links))

    # -- queries -------------------------------------------------------------
    @property
    def empty(self) -> bool:
        return not (self.slow_ranks or self.degraded_links or self.dead_links)

    @property
    def max_onset_s(self) -> float:
        """Latest onset across every fault (0 for an empty/immediate spec);
        once the simulation clock passes it the fault set is static and
        steady-state fast-forwarding is safe again."""
        onsets = [f.onset_s for f in
                  (*self.slow_ranks, *self.degraded_links, *self.dead_links)]
        return max(onsets) if onsets else 0.0

    def active_dead(self, t: float) -> FrozenSet[int]:
        """Physical link ids dead at pattern time ``t``."""
        return frozenset(f.link for f in self.dead_links if t >= f.onset_s)

    def link_scales(self, links: np.ndarray, t: float
                    ) -> Optional[np.ndarray]:
        """Per-entry beta multipliers for physical link ids ``links`` at
        pattern time ``t`` — or None when no active degraded fault touches
        any of them (the caller keeps its unscaled fast path)."""
        active = [f for f in self.degraded_links if t >= f.onset_s]
        if not active:
            return None
        scales = np.ones(links.size)
        touched = False
        for f in active:
            m = links == f.link
            if m.any():
                scales[m] *= f.scale
                touched = True
        return scales if touched else None

    def compute_scales(self, clocks: np.ndarray) -> Optional[np.ndarray]:
        """Per-rank compute-time multipliers given per-rank clocks (a slow
        rank counts once its own clock has reached the onset), or None
        when no slow rank is active."""
        if not self.slow_ranks:
            return None
        v: Optional[np.ndarray] = None
        p = clocks.size
        for f in self.slow_ranks:
            if f.rank < p and clocks[f.rank] >= f.onset_s:
                if v is None:
                    v = np.ones(p)
                v[f.rank] *= f.scale
        return v

    # -- identity ------------------------------------------------------------
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def fingerprint(self) -> str:
        blob = json.dumps(self.to_dict(), sort_keys=True)
        return hashlib.sha256(blob.encode()).hexdigest()[:12]


def torus_link(topo: Torus, node: int, dim: int, step: int) -> int:
    """The physical id of ``node``'s outgoing link along ``dim`` in
    direction ``step`` (+1 forward / -1 backward) — the handle fault
    specs and tests name links by."""
    if not isinstance(topo, Torus):
        raise TypeError(f"torus_link needs a Torus, got {topo!r}")
    return topo._link_id(topo.coords(node), dim, 1 if step > 0 else -1)


class FaultyTopology(Topology):
    """Routing view of ``base`` with a set of dead links removed.

    A fresh instance per active dead set: route/plan/fold caches are
    private (never the memoized shared instance's), so fault scenarios
    cannot poison healthy simulations.  Torus bases reroute per DOR
    dimension by flipping to the other ring direction; any other base —
    or a torus with both directions dead — raises
    :class:`UnreachableError`.
    """

    def __init__(self, base: Topology, dead: Iterable[int]):
        self.base = base
        self.dead = frozenset(int(l) for l in dead)
        self.n_nodes = base.n_nodes
        self._routes: Dict[Tuple[int, int], Tuple[int, ...]] = {}

    def link_name(self, link: int) -> str:
        return self.base.link_name(link)

    def route(self, src: int, dst: int) -> Tuple[int, ...]:
        key = (src, dst)
        hit = self._routes.get(key)
        if hit is not None:
            return hit
        if isinstance(self.base, Torus):
            path = self._torus_route(src, dst)
        else:
            path = self.base.route(src, dst)
            bad = [l for l in path if l in self.dead]
            if bad:
                raise UnreachableError(
                    f"{src} -> {dst} crosses dead link(s) "
                    f"{bad} on {self.base!r} (no alternate route)")
        self._routes[key] = path
        return path

    def _torus_route(self, src: int, dst: int) -> Tuple[int, ...]:
        t = self.base
        cs, cd = list(t.coords(src)), list(t.coords(dst))
        links: List[int] = []
        for dim, k in enumerate(t.shape):
            fwd = (cd[dim] - cs[dim]) % k
            if fwd == 0:
                continue
            pref = 1 if 2 * fwd <= k else -1  # tie -> forward (DOR legacy)
            for step in (pref, -pref):
                hops = self._ring_hops(cs, dim, step,
                                       fwd if step > 0 else k - fwd)
                if hops is not None:
                    links.extend(hops)
                    cs[dim] = cd[dim]
                    break
            else:
                raise UnreachableError(
                    f"{src} -> {dst}: both ring directions of dim {dim} "
                    f"cross dead links on {t!r}")
        return tuple(links)

    def _ring_hops(self, cs: List[int], dim: int, step: int,
                   nhops: int) -> Optional[List[int]]:
        t = self.base
        k = t.shape[dim]
        cur = list(cs)
        out: List[int] = []
        for _ in range(nhops):
            lid = t._link_id(cur, dim, step)
            if lid in self.dead:
                return None
            out.append(lid)
            cur[dim] = (cur[dim] + step) % k
        return out

    def __repr__(self):
        return f"Faulty({self.base!r}, dead={sorted(self.dead)})"
