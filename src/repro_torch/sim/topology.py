"""Explicit network topologies for the per-rank simulator.

A :class:`Topology` maps an ordered pair of node indices to the sequence of
*directed links* a message traverses.  Two concrete topologies:

* :class:`Torus` — a k-ary n-cube with dimension-ordered routing (DOR),
  the shape of the paper's Gemini 3D torus and of TPU ICI meshes.  Routing
  takes the shortest wraparound direction per dimension, ties broken
  forward, so calibration tables derived through this layer are the
  paper's static link-load counts.
* :class:`Crossbar` — a flat, fully-connected baseline where every ordered
  pair owns a dedicated channel.  No two distinct messages ever share a
  link, so simulation on a crossbar is *contention-free by construction*
  — the cross-validation anchor against the closed-form ``est_NoCal``
  evaluator.

Because the executor's only traffic shape is the paper's calibration
pattern — all ``p`` ranks shifting to ``rank + d`` — topologies also serve
precomputed :class:`ShiftPlan` objects: CSR-style link-incidence arrays
for the whole pattern at once (``Torus`` builds them with closed-form
numpy, no per-pair Python walk), plus the pattern's static link loads.
Plans and the symmetry :class:`~repro_torch.sim.fold.Fold` structures derived
from them are cached per ``(p, d)`` on the topology instance, so repeated
collective steps, loop iterations, shortlist candidates and batched
scenarios all share one route construction.

Link ids are small integers local to a topology instance; ``link_name``
renders them for traces and utilization reports.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

#: entries kept in each per-topology plan/fold cache (LRU) — a paper-scale
#: program touches a few dozen distinct (p, d) patterns; the cap only
#: guards against unbounded growth across many unrelated simulations.
CACHE_CAP = 128

#: one lock for every plan/fold/instance cache: topology instances are
#: shared (memoized) and the Tuner plans from multiple threads — held
#: only around dict operations, never while building a plan or fold.
_CACHE_LOCK = threading.Lock()


@dataclasses.dataclass
class ShiftPlan:
    """CSR link-incidence of one shift pattern: rank ``i`` sends to
    ``(i + d) % p`` along ``links[indptr[i]:indptr[i+1]]`` (DOR order).

    ``uniq_links``/``link_idx`` compress the touched physical link ids to
    a dense ``0..L-1`` space (``links == uniq_links[link_idx]``); the
    static load is the per-unique-link crossing count with every transfer
    active — ``max_static_load <= 1`` certifies the pattern collision-free
    for *any* start times.
    """

    p: int
    d: int
    indptr: np.ndarray          # (p+1,) int64
    links: np.ndarray           # (nnz,) physical link ids
    uniq_links: np.ndarray      # (L,) distinct physical link ids
    link_idx: np.ndarray        # (nnz,) indices into uniq_links
    owner: np.ndarray           # (nnz,) transfer index per incidence
    static_load: np.ndarray     # (L,) crossings per unique link
    max_static_load: int


class Topology:
    """Interface: node count plus directed-link routing."""

    n_nodes: int

    def route(self, src: int, dst: int) -> Tuple[int, ...]:
        """Directed link ids traversed by a ``src -> dst`` message (empty
        for ``src == dst``)."""
        raise NotImplementedError

    def hops(self, src: int, dst: int) -> int:
        return len(self.route(src, dst))

    def link_name(self, link: int) -> str:
        raise NotImplementedError

    # -- shift-pattern plans -------------------------------------------------
    def _build_shift_routes(self, p: int, d: int
                            ) -> Tuple[np.ndarray, np.ndarray]:
        """(indptr, links) CSR of the ``rank -> rank + d (mod p)`` pattern.
        Generic fallback walks ``route`` per pair; ``Torus`` overrides with
        a closed-form vectorized construction."""
        paths = [self.route(rk, (rk + d) % p) for rk in range(p)]
        lens = np.fromiter((len(pa) for pa in paths), dtype=np.int64, count=p)
        indptr = np.zeros(p + 1, dtype=np.int64)
        np.cumsum(lens, out=indptr[1:])
        links = np.fromiter((l for pa in paths for l in pa),
                            dtype=np.int64, count=int(indptr[-1]))
        return indptr, links

    def shift_plan(self, p: int, d: int) -> ShiftPlan:
        """The cached :class:`ShiftPlan` for a ``(p, d)`` shift pattern."""
        key = (int(p), int(d))
        with _CACHE_LOCK:
            cache: OrderedDict = self.__dict__.setdefault(
                "_shift_plans", OrderedDict())
            plan = cache.get(key)
            if plan is not None:
                cache.move_to_end(key)
                return plan
        # built outside the lock; a concurrent duplicate build is benign
        indptr, links = self._build_shift_routes(int(p), int(d))
        uniq, link_idx = np.unique(links, return_inverse=True)
        link_idx = link_idx.astype(np.int64).ravel()
        owner = np.repeat(np.arange(p, dtype=np.int64), np.diff(indptr))
        static = np.bincount(link_idx, minlength=uniq.size)
        plan = ShiftPlan(
            p=int(p), d=int(d), indptr=indptr, links=links,
            uniq_links=uniq, link_idx=link_idx, owner=owner,
            static_load=static,
            max_static_load=int(static.max()) if static.size else 0)
        with _CACHE_LOCK:
            cache[key] = plan
            if len(cache) > CACHE_CAP:
                cache.popitem(last=False)
        return plan

    def fold_get(self, key):
        """Cached :class:`~repro_torch.sim.fold.Fold` for ``key`` (pattern +
        clock-class signature, assigned by the network layer), or None."""
        with _CACHE_LOCK:
            cache: OrderedDict = self.__dict__.setdefault(
                "_fold_cache", OrderedDict())
            fold = cache.get(key)
            if fold is not None:
                cache.move_to_end(key)
            return fold

    def fold_put(self, key, fold) -> None:
        with _CACHE_LOCK:
            cache: OrderedDict = self.__dict__.setdefault(
                "_fold_cache", OrderedDict())
            cache[key] = fold
            if len(cache) > CACHE_CAP:
                cache.popitem(last=False)


class Torus(Topology):
    """k-ary n-cube with dimension-ordered routing.

    Nodes are numbered in mixed radix over ``shape`` (dimension 0 fastest,
    matching the legacy contention simulator).  Each node owns ``2 * ndim``
    outgoing links (one per dimension per direction).
    """

    def __init__(self, shape: Sequence[int]):
        self.shape = tuple(int(k) for k in shape)
        if not self.shape or any(k < 1 for k in self.shape):
            raise ValueError(f"invalid torus shape {shape!r}")
        self.ndim = len(self.shape)
        n = 1
        for k in self.shape:
            n *= k
        self.n_nodes = n
        self._cache: Dict[Tuple[int, int], Tuple[int, ...]] = {}

    def coords(self, node: int) -> Tuple[int, ...]:
        c = []
        for k in self.shape:
            c.append(node % k)
            node //= k
        return tuple(c)

    def node(self, coords: Sequence[int]) -> int:
        idx, stride = 0, 1
        for x, k in zip(coords, self.shape):
            idx += (int(x) % k) * stride
            stride *= k
        return idx

    def _link_id(self, coords: Sequence[int], dim: int, step: int) -> int:
        return (self.node(coords) * self.ndim + dim) * 2 + (0 if step > 0 else 1)

    def route(self, src: int, dst: int) -> Tuple[int, ...]:
        key = (src, dst)
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        cs, cd = list(self.coords(src)), list(self.coords(dst))
        links: List[int] = []
        for dim, k in enumerate(self.shape):
            while cs[dim] != cd[dim]:
                fwd = (cd[dim] - cs[dim]) % k
                step = 1 if fwd <= k - fwd else -1  # tie -> forward (legacy)
                links.append(self._link_id(cs, dim, step))
                cs[dim] = (cs[dim] + step) % k
        path = tuple(links)
        self._cache[key] = path
        return path

    def _build_shift_routes(self, p: int, d: int
                            ) -> Tuple[np.ndarray, np.ndarray]:
        """Closed-form CSR construction of the whole shift pattern.

        DOR fixes the step direction per dimension up front (the shortest
        wraparound side never flips while walking), so every rank's route
        is three vectorizable pieces per dimension: a base node (lower
        dims already at the destination digit, higher dims still at the
        source digit), a stride walk of ``min(fwd, k - fwd)`` hops, and a
        direction bit.  Bit-identical to ``route`` per pair (tested)."""
        ndim = len(self.shape)
        shape = np.array(self.shape, dtype=np.int64)
        strides = np.ones(ndim, dtype=np.int64)
        for m in range(1, ndim):
            strides[m] = strides[m - 1] * shape[m - 1]
        src = np.arange(p, dtype=np.int64)
        dst = (src + d) % p

        def _coords(v: np.ndarray) -> np.ndarray:
            out = np.empty((v.size, ndim), dtype=np.int64)
            x = v.copy()
            for m in range(ndim):
                out[:, m] = x % shape[m]
                x //= shape[m]
            return out

        cs, cd = _coords(src), _coords(dst)
        fwd = (cd - cs) % shape[None, :]
        step = np.where(fwd * 2 <= shape[None, :], 1, -1)  # tie -> forward
        nst = np.where(step > 0, fwd, shape[None, :] - fwd)
        nst = np.where(fwd == 0, 0, nst)
        base = np.zeros((p, ndim), dtype=np.int64)
        for m in range(ndim):
            for i in range(ndim):
                if i < m:
                    base[:, m] += cd[:, i] * strides[i]
                elif i > m:
                    base[:, m] += cs[:, i] * strides[i]
        counts = nst.ravel()  # rank-major, dimension-minor == DOR order
        tot = int(counts.sum())
        indptr = np.zeros(p + 1, dtype=np.int64)
        np.cumsum(nst.sum(axis=1), out=indptr[1:])
        grp = np.repeat(np.arange(p * ndim, dtype=np.int64), counts)
        offs = np.repeat(np.cumsum(counts) - counts, counts)
        j = np.arange(tot, dtype=np.int64) - offs
        rk, dm = grp // ndim, grp % ndim
        x = (cs[rk, dm] + step[rk, dm] * j) % shape[dm]
        links = ((base[rk, dm] + x * strides[dm]) * ndim + dm) * 2 \
            + (step[rk, dm] < 0)
        return indptr, links

    def link_name(self, link: int) -> str:
        node, rest = divmod(link, self.ndim * 2)
        dim, sign = divmod(rest, 2)
        return f"{self.coords(node)}.d{dim}{'+' if sign == 0 else '-'}"

    def __repr__(self):
        return f"Torus{self.shape}"


class Crossbar(Topology):
    """Fully-connected baseline: a dedicated channel per ordered pair.

    Channel ids are assigned lazily on first route so a large crossbar does
    not materialize ``n^2`` links up front.
    """

    def __init__(self, n_nodes: int):
        if n_nodes < 1:
            raise ValueError(f"need >= 1 node, got {n_nodes}")
        self.n_nodes = int(n_nodes)
        self._ids: Dict[Tuple[int, int], int] = {}
        self._names: List[Tuple[int, int]] = []

    def route(self, src: int, dst: int) -> Tuple[int, ...]:
        if src == dst:
            return ()
        key = (src, dst)
        link = self._ids.get(key)
        if link is None:
            link = len(self._names)
            self._ids[key] = link
            self._names.append(key)
        return (link,)

    def link_name(self, link: int) -> str:
        src, dst = self._names[link]
        return f"{src}->{dst}"

    def __repr__(self):
        return f"Crossbar({self.n_nodes})"


def _balanced_factorization(p: int, dims: int) -> Optional[Tuple[int, ...]]:
    """The most balanced ordered factorization of ``p`` into ``dims``
    factors, or None when every factorization is badly skewed (max/min
    ratio > 4) — a shift pattern on a degenerate ``(p, 1, 1)`` torus has
    nothing in common with the machine it stands for."""
    divisors = [f for f in range(1, int(p ** 0.5) + 1) if p % f == 0]
    divisors = sorted(set(divisors + [p // f for f in divisors]))

    best: Optional[Tuple[int, ...]] = None

    def rec(rem: int, left: int, picked: Tuple[int, ...]) -> None:
        nonlocal best
        if left == 1:
            cand = tuple(sorted(picked + (rem,)))
            if best is None or max(cand) / min(cand) < \
                    max(best) / min(best):
                best = cand
            return
        for f in divisors:
            if rem % f == 0:
                rec(rem // f, left - 1, picked + (f,))

    rec(p, dims, ())
    if best is None or max(best) / max(min(best), 1) > 4:
        return None
    return best


#: memoized topology instances (each pins its own LRU-capped plan/fold
#: caches, so the instance cache is itself a small LRU).
_TOPOLOGY_CACHE: "OrderedDict[tuple, Topology]" = OrderedDict()
_TOPOLOGY_CACHE_CAP = 16


def topology_for(machine, p: int) -> Topology:
    """The torus of ``machine.torus_dims`` dimensions for ``p`` ranks —
    an exact balanced factorization of ``p`` when one exists (so every
    rank owns a node and shift patterns keep their full translation
    symmetry for folding), else the smallest balanced ``k^dims`` holding
    ``p``.  Machines without a torus get a crossbar.  Instances are
    memoized so batched simulations share one route/fold cache."""
    dims = int(getattr(machine, "torus_dims", 0) or 0)
    p = max(1, int(p))
    if dims < 1:
        key = ("crossbar", p)
    else:
        shape = _balanced_factorization(p, dims)
        if shape is None:
            k = 1
            while k ** dims < p:
                k += 1
            shape = (k,) * dims
        key = ("torus", shape)
    with _CACHE_LOCK:
        topo = _TOPOLOGY_CACHE.get(key)
        if topo is None:
            topo = Crossbar(p) if key[0] == "crossbar" else Torus(key[1])
            _TOPOLOGY_CACHE[key] = topo
            if len(_TOPOLOGY_CACHE) > _TOPOLOGY_CACHE_CAP:
                _TOPOLOGY_CACHE.popitem(last=False)
        else:
            _TOPOLOGY_CACHE.move_to_end(key)
        return topo
