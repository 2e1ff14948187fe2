"""The cost IR: composable nodes for the paper's modeling methodology.

Every algorithm model in the paper (§V) is a composition of three leaf
costs — local routines (``T_rout``), calibrated point-to-point transfers
(``T_comm`` / ``T_comm_sync``) and analytic collective schedules — combined
by sequencing, loops, and max-overlap.  The IR makes those combinators
first-class:

=============  ============================================================
``Compute``    ``T_rout(routine, block, threads)`` local computation
``P2P``        ``C_avg(d) * (L + beta*w)`` point-to-point transfer
``SyncP2P``    ``C_max(p, d) * (L + beta*w)`` transfer closing a sync
``Collective`` a named recursive collective schedule (``bcast``,
               ``reduce``, ...) expanded step-by-step by the evaluator
``Seq``        sequential composition; children may carry phase labels
``Loop``       ``count`` repetitions of an iteration-independent body
               (``count`` may be any closed-form Expr, e.g. the collapsed
               triangular sums of TRSM/Cholesky)
``Overlap``    max-composition of a comm branch and a comp branch
               (paper §IV); the ``ramp`` form charges
               ``sum_m max(comm*m, comp*m^2)`` analytically for the
               right-looking factorization loops
=============  ============================================================

Nodes hold :class:`repro_torch.perf.expr.Expr` parameters, so one program
evaluates either for a scalar scenario or vectorized over numpy grids of
``(n, p, c, r)`` — see ``repro_torch.perf.evaluate``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

from .expr import Expr, ExprLike, as_expr

#: collective schedule kinds the evaluator knows how to expand
COLLECTIVE_KINDS = ("redsca_sync", "scatter_sync", "gather", "allgather",
                    "allgather_sync", "reduce", "bcast", "bcast_sync",
                    "inirepl")


class Node:
    """Base class of all IR nodes."""


@dataclasses.dataclass
class Compute(Node):
    """Local routine time ``T_rout(routine, block, threads)``.

    ``threads=None`` uses the machine's full thread count; the overlapped
    variants pass ``T - 1`` (one thread dedicated to communication).
    """

    routine: str
    block: Expr
    threads: Optional[Expr] = None

    def __post_init__(self):
        self.block = as_expr(self.block)
        if self.threads is not None:
            self.threads = as_expr(self.threads)


@dataclasses.dataclass
class P2P(Node):
    """Point-to-point transfer of ``words`` at distance ``dist``: charged
    ``C_avg(dist) * (L + beta * words)``."""

    words: Expr
    dist: Expr

    def __post_init__(self):
        self.words = as_expr(self.words)
        self.dist = as_expr(self.dist)


@dataclasses.dataclass
class SyncP2P(Node):
    """Transfer that closes a synchronization: ``C_max(p, dist)`` applies
    (every process waits for the slowest; paper §IV)."""

    words: Expr
    dist: Expr

    def __post_init__(self):
        self.words = as_expr(self.words)
        self.dist = as_expr(self.dist)


@dataclasses.dataclass
class Collective(Node):
    """A named analytic collective schedule over ``q`` processes moving a
    ``words``-word vector between neighbours at base distance ``dist``.

    The evaluator expands the schedule (recursive halving / doubling steps,
    each with its own calibration factor; the closing step of a
    synchronized schedule uses ``C_max``) — see
    ``repro_torch.perf.evaluate.collective_schedule`` for the step-level view.
    """

    kind: str
    words: Expr
    q: Expr
    dist: Expr = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.kind not in COLLECTIVE_KINDS:
            raise ValueError(f"unknown collective kind {self.kind!r}; "
                             f"have {COLLECTIVE_KINDS}")
        self.words = as_expr(self.words)
        self.q = as_expr(self.q)
        self.dist = as_expr(1.0 if self.dist is None else self.dist)


Child = Union[Node, Tuple[str, Node]]


@dataclasses.dataclass
class Seq(Node):
    """Sequential composition.  Children may be ``(label, node)`` pairs;
    labeled children become named phases in the evaluation breakdown."""

    children: Sequence[Child]

    def __init__(self, *children: Child):
        norm = []
        for ch in children:
            if isinstance(ch, tuple):
                label, node = ch
                norm.append((str(label), node))
            else:
                norm.append((None, ch))
        self.children = tuple(norm)


@dataclasses.dataclass
class Loop(Node):
    """``count`` repetitions of an iteration-independent ``body``.

    ``count`` is any Expr — including fractional closed-form sums such as
    ``sum_decreasing(nb)/g``, exactly as the paper's collapsed loop bounds.
    """

    body: Node
    count: Expr

    def __post_init__(self):
        self.count = as_expr(self.count)


@dataclasses.dataclass
class Overlap(Node):
    """Max-composition of a communication and a computation branch
    (paper §IV: charged ``max(comm, comp)``; both serialized ledgers still
    accumulate their branch in full).

    Plain form — ``count`` iterations, each ``max(T_comm, T_comp)``.

    Ramp form (``ramp=nb``) — the right-looking factorization loops, where
    iteration ``i`` overlaps a panel broadcast linear in the trailing size
    ``m`` with an update quadratic in ``m`` (``m = k-1-i``, ``k =
    rint(nb)``).  The exposed time ``sum_m max(comm*m, comp*m^2)`` is
    charged via the analytic crossover ``m* = comm/comp`` so evaluation
    stays O(1) per scenario.
    """

    comm: Node
    comp: Node
    count: Expr = None  # type: ignore[assignment]
    ramp: Optional[Expr] = None

    def __post_init__(self):
        self.count = as_expr(1.0 if self.count is None else self.count)
        if self.ramp is not None:
            self.ramp = as_expr(self.ramp)


@dataclasses.dataclass
class Program:
    """A complete cost model: an IR tree plus its registry identity.

    ``uses_c`` / ``uses_r`` mark which tuning knobs the model actually
    reads (2D variants ignore ``c``; the matmuls ignore ``r``) so result
    metadata can echo only meaningful parameters, matching the pre-IR
    closed forms.
    """

    algo: str
    variant: str
    root: Node
    uses_c: bool = False
    uses_r: bool = False
    default_c: int = 1
    default_r: int = 1
    doc: str = ""

    @property
    def key(self) -> Tuple[str, str]:
        return (self.algo, self.variant)
