"""Rank-symmetry folding: lump transfers with provably identical dynamics.

The paper's traffic patterns — every rank shifting to ``rank + d`` — are
(near-)vertex-transitive on a torus, so most of the ``p`` transfers in a
pattern are indistinguishable: their routes see the same link loads at
every instant and they complete at exactly the same time.  Folding finds
those groups *structurally* and simulates one representative per group.

The grouping is the **coarsest equitable partition** of the bipartite
transfer/link incidence graph (seeded by the per-rank clock classes),
computed by classic color refinement (1-WL): alternately relabel links by
the multiset of their incident transfer classes and transfers by the
multiset of their route's link classes, until neither side splits.
Multisets are compared with random-linear-sum fingerprints (four
independent 32-bit draws per class, summed exactly in float64), the
standard collision-safe trick for vectorizing refinement.

Equitability is exactly the lumpability condition of the fluid max-rate
dynamics: every link of class ``m`` is crossed by the same number
``a[k, m]`` of class-``k`` transfers, and every class-``k`` transfer
crosses the same multiset of link classes — so if all members of a class
share a start time and message size (guaranteed by the clock-class seed),
their remaining words, rates and completion times stay identical for all
time, and the folded system

    load(m) = sum_k active(k) * a[k, m]
    rate(k) = 1 / (beta * max over route link classes m of load(m))

reproduces the unfolded solution exactly.  Two integrality checks
(``a[k, m]`` and the per-transfer route counts must be whole numbers)
reject the astronomically unlikely fingerprint collision — and any such
rejection falls back to the trivial partition, which is always equitable:
folding degrades to the plain vectorized sparse engine, never to a wrong
answer.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from .topology import ShiftPlan

#: refinement rounds before giving up on folding (each non-final round
#: must split at least one class, so symmetric patterns converge in a
#: handful; hitting the cap means the pattern is effectively asymmetric
#: and the trivial partition is used instead).
MAX_REFINE_ROUNDS = 48

#: independent 32-bit fingerprint draws per class per round.  Four give
#: 128 bits: a multiset collision that survives a round is ~2^-128, and
#: the integrality checks below catch stragglers.
_FINGERPRINT_WORDS = 4


@dataclasses.dataclass
class Fold:
    """A lumped view of one transfer pattern.

    ``t_class`` maps each of the ``T`` transfers to one of ``K`` classes;
    ``rep`` picks a representative transfer per class and ``mult`` counts
    members.  ``row_*`` is a CSR matrix over (class, link-class) pairs
    whose values ``a[k, m]`` are *per-physical-link* crossing counts;
    its row sparsity doubles as the representative's route in link-class
    space (the bottleneck max runs over it).  ``l_class`` classifies the
    pattern's ``L`` distinct physical links so per-class stats expand
    back to real links.
    """

    t_class: np.ndarray         # (T,) transfer -> class
    K: int
    M: int
    mult: np.ndarray            # (K,) members per class
    rep: np.ndarray             # (K,) representative transfer index
    row_ptr: np.ndarray         # (K+1,) CSR over classes
    row_m: np.ndarray           # (nnz_f,) link-class column ids
    row_a: np.ndarray           # (nnz_f,) a[k, m] per-link crossing counts
    entry_k: np.ndarray         # (nnz_f,) row id per CSR entry
    l_class: np.ndarray         # (L,) unique physical link -> link class
    nonempty: np.ndarray        # (K,) rows with at least one link

    @property
    def folded(self) -> bool:
        return self.K < self.t_class.size


def _fingerprints(n_labels: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(0xF01D ^ seed)
    # float64 so bincount-weight sums stay exact: values < 2^32 and
    # nnz < 2^21 keep every sum below 2^53.
    return rng.integers(0, 1 << 32, size=(n_labels, _FINGERPRINT_WORDS)
                        ).astype(np.float64)


_FNV = np.uint64(0x100000001B3)
_SALT = np.uint64(0x9E3779B97F4A7C15)


def _canon(parts) -> Tuple[np.ndarray, int]:
    """Dense 0..K-1 relabeling of row-tuples.  ``parts`` is a sequence of
    equal-length integer-valued arrays (one column each); rows are mixed
    into a single uint64 key (FNV-style, vectorized) so the relabeling is
    one cheap 1-D ``np.unique`` instead of a structured-dtype sort.  A
    key collision can only *merge* classes — which the equitability
    integrality check in :func:`build_fold` then rejects."""
    h = np.full(parts[0].shape[0], _SALT, dtype=np.uint64)
    with np.errstate(over="ignore"):
        for arr in parts:
            h = (h ^ (arr.astype(np.uint64) + _SALT)) * _FNV
    _, inv = np.unique(h, return_inverse=True)
    inv = inv.astype(np.int64).ravel()
    return inv, (int(inv.max()) + 1 if inv.size else 0)


def refine_partition(owner: np.ndarray, lid: np.ndarray, T: int, L: int,
                     init_labels: np.ndarray,
                     indptr: Optional[np.ndarray] = None,
                     static_load: Optional[np.ndarray] = None,
                     link_seed: Optional[np.ndarray] = None
                     ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Color-refine the transfer/link incidence to its coarsest equitable
    partition.  Returns ``(t_class, l_class)`` or None when the round cap
    is hit (caller falls back to the trivial partition).

    ``indptr``/``static_load``, when given, enrich the seeds with what the
    first rounds would otherwise spend bincounts discovering: links start
    split by static load, transfers by (seed, hop count, static
    bottleneck) — refinement only ever *splits*, so a finer valid seed
    changes nothing but the round count.

    ``link_seed`` is an optional per-unique-link integer label folded into
    the initial link partition — fault injection seeds degraded links into
    their own classes here, so the equitability the fluid engine relies on
    also covers the per-link beta scales (a class never mixes scales)."""
    if indptr is not None and static_load is not None:
        l_parts = [static_load] if link_seed is None \
            else [static_load, link_seed]
        l_lab, M = _canon(l_parts)
        hops = np.diff(indptr)
        bneck = np.zeros(T, dtype=np.int64)
        routed = hops > 0
        if routed.any():
            bneck[routed] = np.maximum.reduceat(
                static_load[lid], indptr[:-1][routed])
        t_lab, K = _canon([init_labels, hops, bneck])
    else:
        t_lab, K = _canon([init_labels])
        if link_seed is not None and L:
            l_lab, M = _canon([link_seed])
        else:
            l_lab = np.zeros(L, dtype=np.int64)
            M = 1 if L else 0
    sums = np.empty((L, _FINGERPRINT_WORDS))
    tsum = np.empty((T, _FINGERPRINT_WORDS))
    for rnd in range(MAX_REFINE_ROUNDS):
        # links <- multiset of incident transfer classes
        tv = _fingerprints(K, 2 * rnd)
        tw = tv[t_lab[owner]]
        for w in range(_FINGERPRINT_WORDS):
            sums[:, w] = np.bincount(lid, weights=tw[:, w], minlength=L)
        l_lab, M_new = _canon([l_lab] + [sums[:, w]
                                         for w in range(_FINGERPRINT_WORDS)])
        # transfers <- multiset of route link classes
        lv = _fingerprints(M_new, 2 * rnd + 1)
        lw = lv[l_lab[lid]]
        for w in range(_FINGERPRINT_WORDS):
            tsum[:, w] = np.bincount(owner, weights=lw[:, w], minlength=T)
        t_lab, K_new = _canon([t_lab] + [tsum[:, w]
                                         for w in range(_FINGERPRINT_WORDS)])
        if K_new == K and M_new == M:
            return t_lab, l_lab
        K, M = K_new, M_new
    return None


def trivial_fold(plan_T: int, indptr: np.ndarray, link_idx: np.ndarray,
                 owner: np.ndarray, L: int) -> Fold:
    """The finest partition — every transfer its own class.  Always
    equitable; this is the plain vectorized sparse engine."""
    T = plan_T
    return Fold(
        t_class=np.arange(T, dtype=np.int64), K=T, M=L,
        mult=np.ones(T, dtype=np.int64),
        rep=np.arange(T, dtype=np.int64),
        row_ptr=indptr.copy(), row_m=link_idx, row_a=np.ones(link_idx.size),
        entry_k=owner, l_class=np.arange(L, dtype=np.int64),
        nonempty=np.diff(indptr) > 0)


def build_fold(plan: ShiftPlan, init_labels: np.ndarray,
               link_seed: Optional[np.ndarray] = None) -> Fold:
    """Fold a shift pattern given per-transfer seed labels (clock classes;
    callers must also fold message size into the seed when it varies).
    ``link_seed`` pre-splits the link partition (per-unique-link labels,
    e.g. fault-injection beta-scale classes); see
    :func:`refine_partition`."""
    T, L = plan.p, plan.uniq_links.size
    owner, lid = plan.owner, plan.link_idx
    fallback = lambda: trivial_fold(T, plan.indptr, lid, owner, L)  # noqa: E731
    refined = refine_partition(owner, lid, T, L, init_labels,
                               indptr=plan.indptr,
                               static_load=plan.static_load,
                               link_seed=link_seed)
    if refined is None:
        return fallback()
    t_lab, l_lab = refined
    K = int(t_lab.max()) + 1 if T else 0
    M = int(l_lab.max()) + 1 if L else 0
    if K >= T:
        return fallback()  # nothing folded; skip the bookkeeping
    # a[k, m]: class-k transfers crossing ONE physical link of class m
    pairs = t_lab[owner] * np.int64(M) + l_lab[lid]
    uniq_pairs, cnt = np.unique(pairs, return_counts=True)
    k_arr, m_arr = uniq_pairs // M, uniq_pairs % M
    links_per_class = np.bincount(l_lab, minlength=M)
    a = cnt / links_per_class[m_arr]
    mult = np.bincount(t_lab, minlength=K)
    b = cnt / mult[k_arr]  # class-m links on one class-k route
    # integrality is the equitability witness; a fingerprint collision
    # that merged distinguishable classes breaks it -> refuse to fold.
    # Absolute tolerance only: a relative one would wave through the
    # small fractional deviations (~1/mult) a bad merge produces.
    if not (np.allclose(a, np.rint(a), rtol=0.0, atol=1e-9)
            and np.allclose(b, np.rint(b), rtol=0.0, atol=1e-9)):
        return fallback()
    rep = np.full(K, T, dtype=np.int64)
    np.minimum.at(rep, t_lab, np.arange(T, dtype=np.int64))
    row_ptr = np.zeros(K + 1, dtype=np.int64)
    np.cumsum(np.bincount(k_arr, minlength=K), out=row_ptr[1:])
    return Fold(
        t_class=t_lab, K=K, M=M, mult=mult, rep=rep,
        row_ptr=row_ptr, row_m=m_arr, row_a=np.rint(a), entry_k=k_arr,
        l_class=l_lab, nonempty=np.diff(row_ptr) > 0)
