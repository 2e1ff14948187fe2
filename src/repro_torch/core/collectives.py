"""Analytic models of collective operations (paper §V).

The paper models MPI collectives by their published internal algorithms
(Thakur/Rabenseifner/Gropp [23], Rabenseifner [24]):

* ``reduce``  = recursive-halving reduce-scatter + binomial gather, with a
  synchronization between the two phases (Rabenseifner's algorithm);
* ``bcast``   = scatter + recursive-doubling all-gather (+ sync variants);

Every step ``i`` of a recursive schedule doubles the partner distance
(``2^i * d``), so each step gets its own calibration factor.  A step that
closes a synchronization uses ``C_max``; all others use ``C_avg``.

Transcription note: the printed equations in §V carry OCR-damaged word
counts (e.g. ``beta*w*q/2^i`` in ``T_redSca_sync`` against ``beta*(w/q)*2^i``
in the very next ``T_gather`` equation, and a stray ``t`` in the last term).
We use the standard volumes of the cited algorithms, which are consistent
with ``T_gather`` as printed and conserve total traffic:

* recursive halving on a ``w``-word vector: step ``i`` exchanges ``w/2^(i+1)``;
* binomial gather / recursive-doubling all-gather: step ``i`` moves
  ``(w/q) * 2^i``.

``q`` is the number of processes in the collective, ``p`` the total number
of processes in the job (C_max depends on ``p``), ``w`` the vector length in
words, ``d`` the base communication distance between group neighbours.

We also provide ring-schedule models for TPU ICI (what GSPMD emits on a
torus axis), with the same calibration hooks — used by the LM-step models
and the roofline cross-checks.

These closed forms are the scalar reference implementation.  The cost-IR
(``repro_torch.perf``) ports the same schedules to ``Collective`` nodes with
vectorized step-masked evaluation; ``tests/test_collectives_properties.py``
pins the two implementations to each other step-for-step and checks the
traffic-conservation/monotonicity invariants of both.
"""

from __future__ import annotations

import math

from .perfmodel import CommModel


def _steps(q: float) -> int:
    q = max(2.0, float(q))
    return max(1, int(round(math.log2(q))))


# ---------------------------------------------------------------------------
# Paper collectives (recursive schedules on the rank space)
# ---------------------------------------------------------------------------


def t_redsca_sync(cm: CommModel, p: float, q: float, w: float, d: float) -> float:
    """Recursive-halving reduce-scatter; last step closes a sync (C_max)."""
    if q <= 1:
        return 0.0
    s = _steps(q)
    total = 0.0
    for i in range(s - 1):
        total += cm.t_comm(w / 2 ** (i + 1), (2 ** i) * d)
    total += cm.t_comm_sync(p, w / 2 ** s, (2 ** (s - 1)) * d)
    return total


def t_scatter_sync(cm: CommModel, p: float, q: float, w: float, d: float) -> float:
    """Binomial scatter (same volumes as recursive halving); sync at end."""
    return t_redsca_sync(cm, p, q, w, d)


def t_gather(cm: CommModel, q: float, w: float, d: float) -> float:
    """Binomial-tree gather; no closing sync => C_avg everywhere."""
    if q <= 1:
        return 0.0
    s = _steps(q)
    total = 0.0
    for i in range(s):
        total += cm.t_comm((w / q) * 2 ** i, (2 ** i) * d)
    return total


def t_allgather(cm: CommModel, q: float, w: float, d: float) -> float:
    """Recursive-doubling all-gather (same per-step volumes as gather)."""
    return t_gather(cm, q, w, d)


def t_allgather_sync(cm: CommModel, p: float, q: float, w: float, d: float) -> float:
    """All-gather whose last step closes a synchronization (C_max)."""
    if q <= 1:
        return 0.0
    s = _steps(q)
    total = 0.0
    for i in range(s - 1):
        total += cm.t_comm((w / q) * 2 ** i, (2 ** i) * d)
    total += cm.t_comm_sync(p, (w / q) * 2 ** (s - 1), (2 ** (s - 1)) * d)
    return total


def t_reduce(cm: CommModel, p: float, q: float, w: float, d: float) -> float:
    """Rabenseifner reduce = reduce-scatter (sync) + binomial gather."""
    return t_redsca_sync(cm, p, q, w, d) + t_gather(cm, q, w, d)


def t_bcast(cm: CommModel, p: float, q: float, w: float, d: float) -> float:
    """MPI bcast = scatter + all-gather (sync between phases)."""
    return t_scatter_sync(cm, p, q, w, d) + t_allgather(cm, q, w, d)


def t_bcast_sync(cm: CommModel, p: float, q: float, w: float, d: float) -> float:
    """bcast that itself closes a synchronization: C_max on the last
    all-gather step (paper §V-B)."""
    return t_scatter_sync(cm, p, q, w, d) + t_allgather_sync(cm, p, q, w, d)


def t_inirepl(cm: CommModel, p: float, w: float, c: float) -> float:
    """2.5D initial replication of A and B from layer 0 to c-1 layers
    (paper §V-A): worst-case distance (c-1)*p/c, synchronized, two matrices.
    """
    if c <= 1:
        return 0.0
    return 2.0 * cm.t_comm_sync(p, w, (c - 1.0) * p / c)


# ---------------------------------------------------------------------------
# TPU ICI ring schedules (GSPMD on a torus mesh axis).
# k shards on the axis; w words per shard of the *global* result.
# Bidirectional ring: effective per-step volume halves.
# ---------------------------------------------------------------------------


def t_ring_allgather(cm: CommModel, k: float, w_global: float, *, d: float = 1.0,
                     bidir: bool = True) -> float:
    """All-gather of a w_global-word array sharded k ways, ring schedule:
    (k-1) steps of w_global/k words each (halved if bidirectional)."""
    if k <= 1:
        return 0.0
    per_step = (w_global / k) / (2.0 if bidir else 1.0)
    total = 0.0
    for _ in range(int(k) - 1):
        total += cm.t_comm(per_step, d)
    return total


def t_ring_reducescatter(cm: CommModel, k: float, w_global: float, *, d: float = 1.0,
                         bidir: bool = True) -> float:
    return t_ring_allgather(cm, k, w_global, d=d, bidir=bidir)


def t_ring_allreduce(cm: CommModel, k: float, w_global: float, *, d: float = 1.0,
                     bidir: bool = True) -> float:
    """reduce-scatter + all-gather."""
    return 2.0 * t_ring_allgather(cm, k, w_global, d=d, bidir=bidir)


def t_all_to_all(cm: CommModel, k: float, w_global: float, *, d: float = 1.0) -> float:
    """All-to-all of w_global words total: each shard keeps 1/k, sends
    (k-1)/k of its w_global/k share; on a ring the bisection limits it to
    ~w_global/4 crossing each direction — model as (k-1) steps of
    w_global/k^2 with growing distance."""
    if k <= 1:
        return 0.0
    total = 0.0
    for i in range(1, int(k)):
        total += cm.t_comm(w_global / (k * k), min(i, int(k) - i) * d)
    return total


PAPER_COLLECTIVES = {
    "redsca_sync": t_redsca_sync,
    "scatter_sync": t_scatter_sync,
    "gather": t_gather,
    "allgather": t_allgather,
    "reduce": t_reduce,
    "bcast": t_bcast,
    "bcast_sync": t_bcast_sync,
}
