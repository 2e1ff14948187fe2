"""Variant selection and prediction tables (paper §VI).

The paper's headline application: given a machine, an algorithm, a problem
size and a core count, evaluate the models for every variant (2D / 2.5D,
with/without overlapping, over the legal replication factors ``c`` and
block-cyclic factors ``r``) and pick the fastest — including the memory
constraint that 2.5D replication must fit ("our models ... can take into
account runtime constraints (e.g., available memory)").

The model surface itself lives in ``repro_torch.tuner.registry``
(``PerfModelRegistry``): this module no longer hard-codes the
ALGOS/VARIANTS tuples but enumerates whatever the registry holds, so
registering a new algorithm model makes it selectable here (and by the
end-to-end autotuner in ``repro_torch.tuner``) with no further changes.

Selection is *batched*: every public entry point collects its whole
candidate set — (scenario, variant, c, r) tuples across all table cells —
and makes one vectorized cost-IR evaluation per variant
(``PerfModelRegistry.evaluate_grid``) instead of one scalar model call per
candidate.  ``prediction_table`` reproduces the structure of paper
Tables II-V (percentage-of-peak for each variant over a grid of core
counts and sizes).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..perf import EvalOptions
from .algorithms import (USEFUL_FLOPS, AlgoContext, ModelResult, pct_of_peak,
                         result_from_eval)

#: matrices resident per algorithm (A,B,C for matmul; X/B + U for trsm;
#: A for chol; A in-place for LU)
_MATRICES = {"cannon": 3.0, "summa": 3.0, "trsm": 2.0, "cholesky": 1.0,
             "lu": 1.0}

#: algorithms whose layouts are block-cyclic (the r factor matters)
_NEEDS_R = ("trsm", "cholesky", "lu")


def _registry():
    """The unified model registry (lazy import: core must stay importable
    without the tuner package, and tuner imports core)."""
    from ..tuner.registry import DEFAULT_REGISTRY
    return DEFAULT_REGISTRY


def fits_memory(ctx: AlgoContext, algo: str, n: int, p: int, c: int) -> bool:
    """Does c-way replication of the algorithm's resident matrices fit the
    per-process memory?  The single feasibility predicate shared by the
    predictor and the end-to-end tuner."""
    words = _MATRICES.get(algo, 3.0) * float(n) * n * c / p
    return words * ctx.comm.machine.word_bytes <= ctx.comp.machine.mem_per_unit


def legal_c_values(p: int, *, max_c: Optional[int] = None) -> list[int]:
    """Replication factors: powers of two with c <= p^(1/3) (Solomonik's
    bound: beyond that, the reduction cost dominates) and p/c a perfect
    square (grid constraint).  Returns ``[]`` when no legal factor exists —
    callers decide their own fallback (an illegal c silently returned here
    used to poison downstream grid construction)."""
    out = []
    cap = max_c or int(round(p ** (1.0 / 3.0)))
    c = 2
    while c <= cap:
        g = math.sqrt(p / c)
        if abs(g - round(g)) < 1e-9:
            out.append(c)
        c *= 2
    return out


@dataclasses.dataclass
class VariantChoice:
    result: ModelResult
    pct_peak: float


def _cell_candidates(ctx: AlgoContext, algo: str, variant: str, n: int,
                     p: int, r_values: Sequence[int], max_c: Optional[int],
                     c_values: Optional[Sequence[int]],
                     needs_r: bool) -> Optional[List[Tuple[int, int]]]:
    """(c, r) candidates for one (cell, variant), with the memory filter
    and fallback policy of the scalar-era ``best_variant``; ``None`` means
    the variant is infeasible under pinned ``c_values`` and must be
    dropped (an over-memory config must *lose*, not be re-scored)."""
    if variant.startswith("2d"):
        cs = [1]
    elif c_values is not None:
        cs = list(c_values)
    else:
        cs = legal_c_values(p, max_c=max_c)
        if not cs:
            # No legal replication factor: fall back to the smallest power
            # of two (the model tolerates non-square grids).
            cs = [2]
    rs = tuple(r_values) if needs_r else (1,)
    cands = [(c, r) for c in cs
             if not (variant.startswith("2.5d")
                     and not fits_memory(ctx, algo, n, p, c))
             for r in rs]
    if not cands:
        if c_values is not None:
            return None
        # auto-enumeration: fall back to the smallest c so the table still
        # has an entry (the paper notes these cells as OOM-limited)
        cands = [(cs[0], rs[0])]
    return cands


def best_variant_batch(ctx: AlgoContext, algo: str,
                       cells: Sequence[Tuple[int, int]], *,
                       variants: Optional[Sequence[str]] = None,
                       r_values: Sequence[int] = (1, 2, 4),
                       max_c: Optional[int] = None,
                       c_values: Optional[Sequence[int]] = None,
                       registry=None,
                       options: Optional[EvalOptions] = None,
                       ) -> List[Dict[str, VariantChoice]]:
    """Tune every ``(n, p)`` cell at once: one vectorized model evaluation
    per variant over the union of all cells' (c, r) candidates.

    Returns one ``{variant: best choice}`` dict per cell, in cell order;
    a variant infeasible for a cell (memory, under pinned ``c_values``) is
    absent from that cell's dict.
    """
    reg = registry or _registry()
    needs_r = algo in _NEEDS_R
    variant_list = (tuple(variants) if variants is not None
                    else reg.variants(algo))
    out: List[Dict[str, VariantChoice]] = [dict() for _ in cells]
    for variant in variant_list:
        idx: List[int] = []
        cand: List[Tuple[int, int, int, int]] = []   # (n, p, c, r)
        for ci, (n, p) in enumerate(cells):
            cs = _cell_candidates(ctx, algo, variant, n, p, r_values, max_c,
                                  c_values, needs_r)
            if cs is None:
                continue
            for c, r in cs:
                idx.append(ci)
                cand.append((n, p, c, r))
        if not idx:
            continue
        program = reg.program(algo, variant) \
            if reg.has_program(algo, variant) else None
        scalars: List[ModelResult] = []
        if program is not None:
            arr = np.array(cand, dtype=float)
            res = reg.evaluate_grid(ctx, algo, variant, arr[:, 0], arr[:, 1],
                                    arr[:, 2], arr[:, 3], options=options)
            totals = res.total
        else:
            # legacy ModelFn registered without a program: scalar fallback
            # (options are forwarded so estimator flavors stay consistent
            # across variants; a legacy fn that cannot accept them fails
            # loudly rather than silently mixing est_Cal with est_NoCal)
            scalars = [reg.evaluate(ctx, algo, variant, n, p, c=c, r=r,
                                    options=options)
                       for (n, p, c, r) in cand]
            totals = np.array([m.total for m in scalars])
        best_j: Dict[int, int] = {}
        for j, ci in enumerate(idx):
            b = best_j.get(ci)
            if b is None or totals[j] < totals[b]:
                best_j[ci] = j
        for ci, j in best_j.items():
            n, p, c, r = cand[j]
            mr = (scalars[j] if program is None
                  else result_from_eval(program, res, n, p, c, r, idx=j))
            out[ci][variant] = VariantChoice(mr, pct_of_peak(ctx, mr))
    return out


def best_variant(ctx: AlgoContext, algo: str, n: int, p: int,
                 variants: Optional[Sequence[str]] = None,
                 r_values: Sequence[int] = (1, 2, 4),
                 max_c: Optional[int] = None,
                 c_values: Optional[Sequence[int]] = None,
                 registry=None) -> Dict[str, VariantChoice]:
    """Evaluate every variant, tuning (c, r); returns {variant: best choice}.

    ``c_values`` overrides the legal-c enumeration for 2.5D variants (the
    end-to-end tuner passes the replication factors its device pool can
    actually realize); ``registry`` overrides the default model registry.
    """
    return best_variant_batch(ctx, algo, [(n, p)], variants=variants,
                              r_values=r_values, max_c=max_c,
                              c_values=c_values, registry=registry)[0]


def select(ctx: AlgoContext, algo: str, n: int, p: int, **kw) -> VariantChoice:
    """The tuner entry point: the single fastest variant for the scenario.

    Raises ValueError when every requested variant is memory-infeasible
    (only possible with pinned ``c_values``)."""
    choices = best_variant(ctx, algo, n, p, **kw)
    if not choices:
        raise ValueError(f"no feasible variant for {algo} n={n} p={p} "
                         f"under the given constraints")
    return max(choices.values(), key=lambda ch: ch.pct_peak)


def prediction_table(ctx: AlgoContext, algo: str,
                     sizes: Iterable[int], core_counts: Iterable[int],
                     threads_per_process: Optional[int] = None,
                     **kw) -> Dict[int, Dict[int, Dict[str, float]]]:
    """Paper Tables II-V: {n: {cores: {variant: pct_of_peak}}}.

    ``core_counts`` are physical cores; processes p = cores / threads_per_unit
    (Hopper runs one process per NUMA domain).  All cells are tuned in one
    batched model evaluation per variant.
    """
    tpp = threads_per_process or ctx.comp.machine.threads_per_unit
    sizes = list(sizes)
    core_counts = list(core_counts)
    flops_of = USEFUL_FLOPS[algo]
    cells = [(n, max(1, cores // tpp)) for n in sizes for cores in core_counts]
    tuned = best_variant_batch(ctx, algo, cells, **kw)
    table: Dict[int, Dict[int, Dict[str, float]]] = {}
    i = 0
    for n in sizes:
        table[n] = {}
        flops = flops_of(n)
        for cores in core_counts:
            choices = tuned[i]
            i += 1
            # %-peak is vs *total cores* peak, as the paper reports.
            peak = cores * ctx.comp.machine.peak_flops_per_thread
            table[n][cores] = {
                variant: 100.0 * flops / (ch.result.total * peak)
                for variant, ch in choices.items()}
    return table


def format_table(table, algo: str, registry=None) -> str:
    variants = (registry or _registry()).variants(algo)
    lines = [f"# predicted %-of-peak — {algo}"]
    for n, by_cores in table.items():
        lines.append(f"  size n={n}")
        lines.append("    cores     " + "  ".join(f"{v:>11}" for v in variants))
        for cores, row in by_cores.items():
            best = max(row.values()) if row else 0.0
            cells = []
            for v in variants:
                val = row.get(v)
                if val is None:     # dropped as infeasible for this cell
                    cells.append(f"{'—':>10} ")
                    continue
                mark = "*" if abs(val - best) < 1e-12 else " "
                cells.append(f"{val:>10.2f}{mark}")
            lines.append(f"    {cores:>8}  " + "  ".join(cells))
    return "\n".join(lines)


def crossover_core_count(ctx: AlgoContext, algo: str, n: int,
                         core_counts: Sequence[int],
                         threads_per_process: Optional[int] = None,
                         registry=None) -> Optional[int]:
    """Smallest core count where 2.5D+overlap beats 2D+overlap — the paper's
    'sweet spot' (§VI-B).  None if no crossover in the range, or when the
    algorithm lacks either overlapped variant (e.g. a freshly registered
    model with only 2d/2.5d); cells where a variant is memory-infeasible
    are skipped rather than KeyError'd.  One batched model evaluation per
    variant covers the whole core-count range.
    """
    reg = registry or _registry()
    wanted = ("2d_ovlp", "2.5d_ovlp")
    have = reg.variants(algo)
    if any(v not in have for v in wanted):
        return None
    tpp = threads_per_process or ctx.comp.machine.threads_per_unit
    cores_sorted = sorted(core_counts)
    cells = [(n, max(1, cores // tpp)) for cores in cores_sorted]
    tuned = best_variant_batch(ctx, algo, cells, variants=wanted,
                               registry=reg)
    for cores, ch in zip(cores_sorted, tuned):
        flat, ovlp = ch.get("2d_ovlp"), ch.get("2.5d_ovlp")
        if flat is None or ovlp is None:
            continue
        if ovlp.result.total < flat.result.total:
            return cores
    return None
