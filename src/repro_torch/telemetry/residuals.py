"""Joining measured runs against model predictions — the paper's
est_Cal-vs-measured comparison (Tables II-V, Figs. 5-8) as a living table.

Each measured :class:`~repro_torch.telemetry.store.RunRecord` is looked up in
the :class:`~repro_torch.tuner.registry.PerfModelRegistry` and evaluated through
``perf.evaluate`` for the same (n, p, c) scenario; matching phase names
join measured seconds to the prediction's per-phase ``EvalResult.phases``
(the whole-run ``execute`` / ``total`` phases join against the predicted
total).  ``include_sim=True``, which additionally replays each scenario
through the per-rank discrete-event simulator, comes with the simulator
slice of the port and raises until then.

The output rows — measured/predicted ratio per phase — feed ``refit``
(online recalibration) and ``drift`` (invalidation), and summarize into
the paper-style accuracy numbers in ``report``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence

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

    ``include_sim=True`` needs the per-rank simulator, which the
    simulator slice of the port brings: it raises ``NotImplementedError``.
    """
    if include_sim:
        raise NotImplementedError(
            "include_sim=True replays runs in the per-rank simulator, which "
            "the simulator slice of the port brings")
    registry = registry or _default_registry()
    rows: List[Residual] = []
    eval_cache: Dict[tuple, object] = {}
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
