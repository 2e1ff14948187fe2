"""Joining measured runs against model predictions — the paper's
est_Cal-vs-measured comparison (Tables II-V, Figs. 5-8) as a living table.

Each measured :class:`~repro_torch.telemetry.store.RunRecord` is looked up in
the :class:`~repro_torch.tuner.registry.PerfModelRegistry` and evaluated through
``perf.evaluate`` for the same (n, p, c) scenario; matching phase names
join measured seconds to the prediction's per-phase ``EvalResult.phases``
(the whole-run ``execute`` / ``total`` phases join against the predicted
total).  ``include_sim=True`` additionally replays each scenario through
the per-rank discrete-event simulator (``repro_torch.sim``) so the
residuals carry both estimator flavors.

The output rows — measured/predicted ratio per phase — feed ``refit``
(online recalibration) and ``drift`` (invalidation), and summarize into
the paper-style accuracy numbers in ``report``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from .store import RunRecord

#: measured phase names that stand for the whole run rather than one model
#: phase — they join against the predicted *total*.
TOTAL_PHASES = ("execute", "total", "step")


@dataclasses.dataclass
class Residual:
    """One (measured phase) x (predicted phase) joined observation."""

    op: str
    variant: str
    n: int
    p: int
    c: int
    phase: str
    measured: float         # wall seconds
    predicted: float        # model (or sim) seconds for the same scenario
    source: str = "model"   # "model" | "sim"
    machine: str = ""       # machine-model name the prediction used
    pred_comm: float = 0.0  # serialized comm seconds inside ``predicted``
    pred_comp: float = 0.0  # serialized comp seconds inside ``predicted``
    timestamp: float = 0.0

    @property
    def ratio(self) -> float:
        return self.measured / self.predicted

    @property
    def log_ratio(self) -> float:
        return math.log(self.ratio)

    @property
    def rel_err(self) -> float:
        """|predicted - measured| / measured — the paper's accuracy metric
        with the measurement as ground truth."""
        return abs(self.predicted - self.measured) / self.measured


def _default_registry():
    from ..tuner.registry import DEFAULT_REGISTRY
    return DEFAULT_REGISTRY


def join(runs: Sequence[RunRecord], registry=None, *,
         options=None, include_sim: bool = False) -> List[Residual]:
    """Residual rows for every joinable (run, phase) pair, oldest first.

    Runs whose (op, variant) has no registered cost-IR program, whose
    machine is unknown to the registry, or whose phases are all overhead
    (no model analog) contribute nothing — serving records join only
    if an LM program is registered under their op.  The exception is
    scheduler ``serve_step`` records: they carry the serving cost
    model's own per-phase prediction inline (made at scheduling time,
    under the scales then installed), so they self-join without any
    registry lookup and come back tagged ``source="serve"`` —
    ``cost.refit_serving`` consumes them, and ``accuracy_report`` (which
    aggregates only ``source="model"`` rows) stays unaffected.

    ``include_sim=True`` replays every distinct joinable scenario through
    the per-rank simulator in one ``simulate_programs`` batch per machine
    (shared route/fold caches), before the row assembly below.
    """
    registry = registry or _default_registry()
    rows: List[Residual] = []
    eval_cache: Dict[tuple, object] = {}
    if include_sim:
        _batch_sim_totals(runs, registry, eval_cache)
    for run in runs:
        if not run.phases:
            continue
        if run.kind == "serve_step" and run.predicted:
            rows.extend(_self_join(run))
            continue
        if not registry.has_program(run.op, run.variant):
            continue
        try:
            surface = registry.machine(run.machine)
        except KeyError:
            continue
        key = (run.machine, run.op, run.variant, run.n, run.p, run.c)
        res = eval_cache.get(key)
        if res is None:
            ctx = surface.context()
            res = registry.evaluate_grid(ctx, run.op, run.variant,
                                         float(run.n), float(run.p),
                                         float(run.c), 1.0, options=options)
            eval_cache[key] = res
        for phase, measured in run.phases.items():
            if phase in TOTAL_PHASES:
                predicted = float(res.total)
                pcm, pcp = float(res.comm), float(res.comp)
            elif phase in res.phases:
                ph = res.phases[phase]
                predicted = float(ph.exposed)
                pcm, pcp = float(ph.comm), float(ph.comp)
            else:
                continue  # overhead phase (plan/distribute/...): no analog
            if measured <= 0.0 or predicted <= 0.0:
                continue
            rows.append(Residual(run.op, run.variant, run.n, run.p, run.c,
                                 phase, float(measured), predicted,
                                 source="model", machine=run.machine,
                                 pred_comm=pcm, pred_comp=pcp,
                                 timestamp=run.timestamp))
        if include_sim:
            sim_t = _sim_total(registry, surface, run, eval_cache)
            if sim_t is not None and run.total > 0.0 and sim_t > 0.0:
                rows.append(Residual(run.op, run.variant, run.n, run.p,
                                     run.c, "total", run.total, sim_t,
                                     source="sim", machine=run.machine,
                                     timestamp=run.timestamp))
    rows.sort(key=lambda r: r.timestamp)
    return rows


def _self_join(run: RunRecord) -> List[Residual]:
    """Residual rows for a record that carries its own prediction
    (scheduler serve_steps): measured phase vs the same-named entry of
    ``run.predicted``, no registry round-trip."""
    rows = []
    for phase, measured in run.phases.items():
        predicted = run.predicted.get(phase)
        if not predicted or measured <= 0.0 or predicted <= 0.0:
            continue
        rows.append(Residual(run.op, run.variant, run.n, run.p, run.c,
                             phase, float(measured), float(predicted),
                             source="serve", machine=run.machine,
                             timestamp=run.timestamp))
    return rows


def _sim_key(run: RunRecord) -> tuple:
    return ("sim", run.machine, run.op, run.variant, run.n, run.p, run.c)


def _batch_sim_totals(runs: Sequence[RunRecord], registry,
                      cache: Dict[tuple, object]) -> None:
    """Pre-fill ``cache`` with simulated totals for every distinct
    joinable (machine, op, variant, n, p, c) among ``runs`` — one
    ``simulate_programs`` call per machine, failures cached as None."""
    from ..sim import simulate_programs
    by_machine: Dict[str, List[tuple]] = {}
    for run in runs:
        key = _sim_key(run)
        if key in cache or not run.phases:
            continue
        if not registry.has_program(run.op, run.variant):
            continue
        try:
            registry.machine(run.machine)
        except KeyError:
            continue
        cache[key] = None  # dedup marker; overwritten on success
        by_machine.setdefault(run.machine, []).append(key)
    for machine, keys in by_machine.items():
        surface = registry.machine(machine)
        programs = [registry.program(k[2], k[3]) for k in keys]
        scens = [{"n": float(k[4]), "p": int(k[5]), "c": int(k[6]), "r": 1}
                 for k in keys]
        sims = simulate_programs(programs, surface.context(), scens,
                                 machine=surface.machine, strict=False)
        for key, sim in zip(keys, sims):
            cache[key] = float(sim.total) if sim is not None else None


def _sim_total(registry, surface, run: RunRecord,
               cache: Dict[tuple, object]) -> Optional[float]:
    key = _sim_key(run)
    if key in cache:
        return cache[key]
    from ..sim import simulate_programs
    sims = simulate_programs(
        [registry.program(run.op, run.variant)], surface.context(),
        [{"n": float(run.n), "p": int(run.p), "c": int(run.c), "r": 1}],
        machine=surface.machine, strict=False)
    total = float(sims[0].total) if sims[0] is not None else None
    cache[key] = total
    return total


def mean_abs_log_ratio(rows: Sequence[Residual]) -> float:
    """The refit objective: 0 when the model nails every phase, symmetric
    in over- and under-prediction."""
    if not rows:
        return float("nan")
    return float(np.mean([abs(r.log_ratio) for r in rows]))


def split_comm_comp(rows: Sequence[Residual]):
    """(comm-dominated, comp-dominated) partition of the rows, by the
    model's own predicted comm fraction carried on each row.  Refit uses
    it to attribute residual error to the right model surface."""
    comm_rows: List[Residual] = []
    comp_rows: List[Residual] = []
    for r in rows:
        tot = r.pred_comm + r.pred_comp
        frac = r.pred_comm / tot if tot > 0 else 0.0
        (comm_rows if frac > 0.5 else comp_rows).append(r)
    return comm_rows, comp_rows
