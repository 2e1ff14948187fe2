"""The paper's 16 algorithm-variant models (§V) — and LU — as IR programs.

Each program is a declarative transcription of the closed-form model it
replaces (``core.algorithms`` pre-IR; golden-pinned by
``tests/golden/model_values.json``): the same terms in the same order, with
the transcription deviations documented in DESIGN.md §1 carried over
verbatim.  Loop bounds are the paper's collapsed closed-form sums
(``sum_decreasing`` etc.), so evaluation stays O(1) per scenario and
vectorizes over ``(n, p, c, r)`` grids.

Authoring a new model is a ~20-40 line function returning a
:class:`~repro_torch.perf.ir.Program` — see ``lu_2d`` / ``lu_25d`` at the bottom,
which extend the methodology to LU factorization (right-looking, block
cyclic; 2.5D layout per Solomonik & Demmel, arXiv:1306.4161 applies the
same recipe hierarchically).
"""

from __future__ import annotations

from typing import Dict, Tuple

from .expr import (C, N, P, R, T, fmax, rint, sqrt, sum_decreasing,
                   sum_squares)
from .ir import Collective, Compute, Loop, Overlap, P2P, Program, Seq, SyncP2P

#: useful flops of each algorithm at global size n (the paper's %-of-peak
#: numerator); numpy-compatible like ROUTINE_FLOPS.
USEFUL_FLOPS = {
    "cannon": lambda n: 2.0 * n ** 3,
    "summa": lambda n: 2.0 * n ** 3,
    "trsm": lambda n: 1.0 * n ** 3,
    "cholesky": lambda n: n ** 3 / 3.0,
    "lu": lambda n: 2.0 * n ** 3 / 3.0,
}

# Shared sub-expressions: the 2D grid edge, the 2.5D grid edge, and the
# 2.5D shift count s = sqrt(p/c)/c (DESIGN.md §1.1).
_SP = sqrt(P)
_G = sqrt(P / C)
_S25 = fmax(1.0, sqrt(P / C) / C)


# ---------------------------------------------------------------------------
# Cannon (paper §V-A) and SUMMA (same structure, broadcasts for shifts)
# ---------------------------------------------------------------------------


def _matmul_2d(algo: str, *, overlap: bool, summa: bool) -> Program:
    bs = N / _SP
    w = bs * bs
    if summa:
        move = Seq(("bcast_A", Collective("bcast_sync", w, q=_SP, dist=1)),
                   ("bcast_B", Collective("bcast_sync", w, q=_SP, dist=_SP)))
        first = "first_bcasts"
    else:
        move = Seq(("shift_row", SyncP2P(w, 1)), ("shift_col", SyncP2P(w, _SP)))
        first = "first_shift"
    mult = Compute("dgemm", bs, T)
    if not overlap:
        root = Seq(*[(lbl, Loop(node, _SP)) for lbl, node in move.children],
                   ("dgemm", Loop(mult, _SP)))
        return Program(algo, "2d", root)
    root = Seq((first, move),
               ("final_dgemm", mult),
               ("loop", Overlap(move, mult, count=_SP - 1)))
    return Program(algo, "2d_ovlp", root)


def _matmul_25d(algo: str, *, overlap: bool, summa: bool) -> Program:
    bs = N / _G
    w = bs * bs
    ini = Collective("inirepl", w, q=C)
    red = Collective("reduce", w, q=C, dist=P / C)
    if summa:
        move = Seq(("bcast_A", Collective("bcast", w, q=_G, dist=1)),
                   ("bcast_B", Collective("bcast", w, q=_G, dist=_G)))
    else:
        move = Seq(("shift_row", P2P(w, 1)), ("shift_col", P2P(w, _G)))
    mult = Compute("dgemm", bs, T)
    if not overlap:
        # SUMMA broadcasts all s panels; Cannon shifts s-1 times (the first
        # block is already in place) — exactly as the closed forms.
        reps = _S25 if summa else _S25 - 1
        root = Seq(("ini_repl", ini),
                   *[(lbl, Loop(node, reps)) for lbl, node in move.children],
                   ("dgemm", Loop(mult, _S25)),
                   ("reduce", red))
        return Program(algo, "2.5d", root, uses_c=True, default_c=4)
    pre = (("first_bcasts", move),) if summa else ()
    root = Seq(("ini_repl", ini), *pre,
               ("loop", Overlap(move, mult, count=_S25 - 1)),
               ("final_dgemm", mult),
               ("reduce", red))
    return Program(algo, "2.5d_ovlp", root, uses_c=True, default_c=4)


# ---------------------------------------------------------------------------
# TRSM (paper §V-B): block-cyclic, r row/column blocks per process per dim
# ---------------------------------------------------------------------------


def _trsm_2d(*, overlap: bool) -> Program:
    nb = R * _SP
    bs = N / nb
    w = bs * bs
    k = rint(nb)
    tt = T - 1 if overlap else T
    bcast_u = Collective("bcast_sync", w, q=_SP, dist=_SP)
    solve = Loop(Compute("dtrsm", bs, tt), R)
    bcast_x = Loop(Collective("bcast", w, q=_SP, dist=1), R)
    update = Loop(Compute("dgemm", bs, tt), R)
    if not overlap:
        root = Seq(
            ("bcast_U", Loop(bcast_u, sum_decreasing(nb) / _SP)),
            ("dtrsm", Loop(solve, k)),
            ("bcast_X", Loop(bcast_x, k)),
            ("update", Loop(update, sum_decreasing(nb, 1.0) / _SP)),
            ("last_bcast_U", bcast_u),
            ("last_solve", solve),
        )
        return Program("trsm", "2d", root, uses_r=True)
    root = Seq(
        ("first_bcast_U", Loop(bcast_u, R)),
        ("dtrsm", Loop(solve, k)),
        ("bcast_X", Loop(bcast_x, k)),
        ("bcastU_vs_update",
         Overlap(bcast_u, update, count=sum_decreasing(nb, 1.0) / _SP)),
        ("last_solve", solve),
    )
    return Program("trsm", "2d_ovlp", root, uses_r=True)


def _trsm_25d(*, overlap: bool) -> Program:
    nb = R * _G
    bs = N / nb
    w = bs * bs
    k = rint(nb)
    tt = T - 1 if overlap else T
    repl_u = Loop(Collective("bcast", w, q=C, dist=P / C), R * R * 0.75)
    scatter = Loop(Collective("scatter_sync", w / C, q=C, dist=P / C), R * R)
    gather = Loop(Collective("gather", w, q=C, dist=P / C), R * R)
    bcast_u = Collective("bcast_sync", w, q=_G, dist=_G)
    solve = Loop(Compute("dtrsm", bs, tt), R / C)
    bcast_x = Loop(Collective("bcast", w, q=_G, dist=1), R / C)
    update = Loop(Compute("dgemm", bs, tt), R / C)
    if not overlap:
        root = Seq(
            ("repl_U", repl_u), ("scatter_X", scatter),
            ("bcast_U", Loop(bcast_u, sum_decreasing(nb) / _G)),
            ("dtrsm", Loop(solve, k)),
            ("bcast_X", Loop(bcast_x, k)),
            ("update", Loop(update, sum_decreasing(nb, 1.0) / _G)),
            ("last_bcast_U", bcast_u),
            ("last_solve", solve),
            ("gather_X", gather),
        )
        return Program("trsm", "2.5d", root, uses_c=True, uses_r=True,
                       default_c=4, default_r=2)
    root = Seq(
        ("repl_U", repl_u), ("scatter_X", scatter),
        ("first_bcast_U", Loop(bcast_u, R)),
        ("dtrsm", Loop(solve, k)),
        ("bcast_X", Loop(bcast_x, k)),
        ("bcastU_vs_update",
         Overlap(bcast_u, update, count=sum_decreasing(nb, 1.0) / _G)),
        ("last_solve", solve),
        ("gather_X", gather),
    )
    return Program("trsm", "2.5d_ovlp", root, uses_c=True, uses_r=True,
                   default_c=4, default_r=2)


# ---------------------------------------------------------------------------
# Right-looking factorizations: Cholesky (paper methodology) and LU (new)
# ---------------------------------------------------------------------------


def _factorization_loop(diag_routine: str, g, nb, bs, *, overlap: bool,
                        panel_count, update_scale):
    """The shared right-looking loop: per block-column — factor the
    diagonal block, broadcast it, solve `panel_count` panels, broadcast the
    panels, rank-update the trailing matrix (``update_scale`` dgemm per
    unit m^2).  Returns the labeled Seq children."""
    w = bs * bs
    k = rint(nb)
    tt = T - 1 if overlap else T
    sum_m = sum_decreasing(nb, 1.0)
    panel_unit = Loop(Seq(Collective("bcast", w, q=g, dist=1),
                          Collective("bcast", w, q=g, dist=g)), 1.0 / g)
    upd_unit = Loop(Compute("dgemm", bs, tt), update_scale)
    children = [
        (diag_routine, Loop(Compute(diag_routine, bs, tt), k)),
        ("bcast_diag", Loop(Collective("bcast_sync", w, q=g, dist=g), k)),
        ("panel_dtrsm", Loop(Compute("dtrsm", bs, tt),
                             panel_count * sum_m / g)),
    ]
    if overlap:
        children.append(("panelbcast_vs_update",
                         Overlap(panel_unit, upd_unit, ramp=nb)))
    else:
        children.append(("panel_bcast", Loop(panel_unit, sum_m)))
        children.append(("update", Loop(upd_unit, sum_squares(nb))))
    # Periodic combination of partial trailing updates across layers
    # (zero at c=1: a q=1 reduce schedule is empty).
    children.append(("layer_reduce",
                     Loop(Collective("reduce", w, q=C, dist=P / C),
                          sum_m / (g * C))))
    return children


def _cholesky(variant: str) -> Program:
    overlap = variant.endswith("_ovlp")
    two_five = variant.startswith("2.5d")
    g = _G if two_five else _SP
    nb = R * g
    bs = N / nb
    w = bs * bs
    loop = _factorization_loop("dpotrf", g, nb, bs, overlap=overlap,
                               panel_count=1.0, update_scale=1.0 / (2.0 * P))
    if not two_five:
        # 2D: drop the (identically zero) layer_reduce term to match the
        # pre-IR closed form's term set exactly.
        root = Seq(*loop[:-1])
        return Program("cholesky", variant, root, uses_r=True, default_r=2)
    root = Seq(("repl_A", Loop(Collective("bcast", w, q=C, dist=P / C),
                               0.5 * R * R)),
               *loop,
               ("gather_L", Loop(Collective("gather", w, q=C, dist=P / C),
                                 0.5 * R * R)))
    return Program("cholesky", variant, root, uses_c=True, uses_r=True,
                   default_c=4, default_r=2)


def lu_2d() -> Program:
    """LU, 2D block-cyclic right-looking (paper methodology, new algo):
    per block-column — dgetrf the diagonal block, broadcast it down the
    column (synchronized), dtrsm both the row and the column panel,
    broadcast the panels along both grid dimensions, dgemm-update the full
    trailing matrix (2x the symmetric Cholesky volume)."""
    nb = R * _SP
    bs = N / nb
    loop = _factorization_loop("dgetrf", _SP, nb, bs, overlap=False,
                               panel_count=2.0, update_scale=1.0 / P)
    return Program("lu", "2d", Seq(*loop[:-1]), uses_r=True, default_r=2,
                   doc="right-looking LU, block-cyclic 2D grid")


def lu_25d() -> Program:
    """LU, 2.5D: replicate A across c layers, run the 2D loop on each
    layer's share (r/c of the panels), periodically reduce partial trailing
    updates across layers, gather L/U at the end (Solomonik & Demmel's
    2.5D schedule applied with the paper's collective models)."""
    nb = R * _G
    bs = N / nb
    w = bs * bs
    loop = _factorization_loop("dgetrf", _G, nb, bs, overlap=False,
                               panel_count=2.0, update_scale=1.0 / P)
    root = Seq(("repl_A", Loop(Collective("bcast", w, q=C, dist=P / C),
                               R * R)),
               *loop,
               ("gather_LU", Loop(Collective("gather", w, q=C, dist=P / C),
                                  R * R)))
    return Program("lu", "2.5d", root, uses_c=True, uses_r=True,
                   default_c=4, default_r=2,
                   doc="right-looking LU on a replicated 2.5D layout")


# ---------------------------------------------------------------------------
# Registry of all programs
# ---------------------------------------------------------------------------


def build_programs() -> Dict[Tuple[str, str], Program]:
    progs = [
        _matmul_2d("cannon", overlap=False, summa=False),
        _matmul_2d("cannon", overlap=True, summa=False),
        _matmul_25d("cannon", overlap=False, summa=False),
        _matmul_25d("cannon", overlap=True, summa=False),
        _matmul_2d("summa", overlap=False, summa=True),
        _matmul_2d("summa", overlap=True, summa=True),
        _matmul_25d("summa", overlap=False, summa=True),
        _matmul_25d("summa", overlap=True, summa=True),
        _trsm_2d(overlap=False),
        _trsm_2d(overlap=True),
        _trsm_25d(overlap=False),
        _trsm_25d(overlap=True),
        _cholesky("2d"),
        _cholesky("2d_ovlp"),
        _cholesky("2.5d"),
        _cholesky("2.5d_ovlp"),
        lu_2d(),
        lu_25d(),
    ]
    return {p.key: p for p in progs}


PROGRAMS: Dict[Tuple[str, str], Program] = build_programs()
