"""Unified Chrome/Perfetto trace exporter — measured *and* predicted.

Every trace this repo produces (tracer spans from a live dispatch,
scheduler step reports from a serving replay, per-rank simulator
results) goes through one :class:`TraceBuilder`, so they share one
format: trace-event JSON loadable in ``chrome://tracing`` / Perfetto
with

* pid 0 = the **measured** timeline (what the machine did),
* pid 1 = the **predicted** timeline (what the model promised),

and, for every measured region whose emitter knew the model's
prediction, a *paired* predicted slice starting at the same timestamp
with the predicted duration, a flow arrow linking the pair, and the
signed residual (``measured - predicted`` seconds, plus relative
error) annotated on both sides — open the trace and the places where
model and machine disagree are literally the places the arrows
stretch.

Pairing rule: a span pairs iff ``predicted_s`` is set and positive and
the span closed with a positive duration; the predicted twin copies
the measured span's name/category/track so the two timelines line up
row-for-row.  Instant events (drift alerts) ride on the measured
timeline unpaired.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
from typing import Dict, Iterable, List, Optional, Sequence

from .. import paths
from .spans import Span

log = logging.getLogger("repro_torch.obs")

MEASURED_PID = 0
PREDICTED_PID = 1

_SCALE = 1e6  # seconds -> trace-event microseconds


def traces_dir() -> str:
    return paths.traces_dir()


class TraceBuilder:
    """Incremental trace-event assembly (one flat ``traceEvents`` list)."""

    def __init__(self):
        self.events: List[dict] = []
        self._flow_ids = itertools.count(1)

    # -- metadata -------------------------------------------------------------
    def process(self, pid: int, name: str,
                sort_index: Optional[int] = None) -> None:
        self.events.append({"name": "process_name", "ph": "M", "pid": pid,
                            "args": {"name": name}})
        if sort_index is not None:
            self.events.append({"name": "process_sort_index", "ph": "M",
                                "pid": pid,
                                "args": {"sort_index": sort_index}})

    def thread(self, pid: int, tid: int, name: str) -> None:
        self.events.append({"name": "thread_name", "ph": "M", "pid": pid,
                            "tid": tid, "args": {"name": name}})

    # -- events ---------------------------------------------------------------
    def complete(self, name: str, ts_s: float, dur_s: float, *,
                 pid: int = MEASURED_PID, tid: int = 0, cat: str = "",
                 args: Optional[dict] = None) -> dict:
        ev = {"name": name, "ph": "X", "pid": pid, "tid": tid,
              "ts": ts_s * _SCALE, "dur": max(dur_s, 0.0) * _SCALE,
              "cat": cat or "phase"}
        if args:
            ev["args"] = args
        self.events.append(ev)
        return ev

    def instant(self, name: str, ts_s: float, *, pid: int = MEASURED_PID,
                tid: int = 0, cat: str = "", args: Optional[dict] = None
                ) -> dict:
        ev = {"name": name, "ph": "i", "s": "p", "pid": pid, "tid": tid,
              "ts": ts_s * _SCALE, "cat": cat or "alert"}
        if args:
            ev["args"] = args
        self.events.append(ev)
        return ev

    def counter(self, name: str, ts_s: float, values: Dict[str, float], *,
                pid: int = MEASURED_PID) -> dict:
        ev = {"name": name, "ph": "C", "pid": pid, "tid": 0,
              "ts": ts_s * _SCALE, "args": dict(values)}
        self.events.append(ev)
        return ev

    def flow(self, name: str, *, from_ts_s: float, from_pid: int,
             from_tid: int, to_ts_s: float, to_pid: int, to_tid: int,
             cat: str = "pair") -> int:
        """A flow arrow (trace-event ``s``/``f`` pair); returns its id."""
        fid = next(self._flow_ids)
        self.events.append({"name": name, "ph": "s", "id": fid, "cat": cat,
                            "pid": from_pid, "tid": from_tid,
                            "ts": from_ts_s * _SCALE})
        self.events.append({"name": name, "ph": "f", "bp": "e", "id": fid,
                            "cat": cat, "pid": to_pid, "tid": to_tid,
                            "ts": to_ts_s * _SCALE})
        return fid

    # -- pairing --------------------------------------------------------------
    def paired(self, name: str, ts_s: float, measured_s: float,
               predicted_s: Optional[float], *, tid: int = 0, cat: str = "",
               args: Optional[dict] = None) -> dict:
        """One measured slice, plus — when a prediction exists — its
        predicted twin, the flow link, and residual annotations."""
        margs = dict(args or {})
        if predicted_s is not None and predicted_s > 0 and measured_s > 0:
            resid = measured_s - predicted_s
            annot = {"predicted_s": predicted_s, "measured_s": measured_s,
                     "residual_s": resid, "rel_err": abs(resid) / measured_s}
            margs.update(annot)
            ev = self.complete(name, ts_s, measured_s, pid=MEASURED_PID,
                               tid=tid, cat=cat, args=margs)
            pargs = dict(annot)
            if "span_id" in margs:
                pargs["pair_of"] = margs["span_id"]
            self.complete(name, ts_s, predicted_s, pid=PREDICTED_PID,
                          tid=tid, cat=cat, args=pargs)
            self.flow(f"pair:{name}", from_ts_s=ts_s, from_pid=PREDICTED_PID,
                      from_tid=tid, to_ts_s=ts_s, to_pid=MEASURED_PID,
                      to_tid=tid)
            return ev
        return self.complete(name, ts_s, measured_s, pid=MEASURED_PID,
                             tid=tid, cat=cat, args=margs or None)

    # -- output ---------------------------------------------------------------
    def to_dict(self, other_data: Optional[dict] = None) -> dict:
        return {"traceEvents": self.events, "displayTimeUnit": "ms",
                "otherData": dict(other_data or {})}

    def save(self, path: str, other_data: Optional[dict] = None) -> str:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_dict(other_data), f)
        return path


# ---------------------------------------------------------------------------
# tracer spans -> paired trace
# ---------------------------------------------------------------------------

def export_spans(spans: Sequence[Span],
                 other_data: Optional[dict] = None) -> dict:
    """The live-session exporter: every tracer span on the measured
    timeline (one track per OS thread), predicted twins + flows +
    residuals wherever the emitting layer attached ``predicted_s``."""
    tb = TraceBuilder()
    tb.process(MEASURED_PID, "measured", sort_index=0)
    tb.process(PREDICTED_PID, "predicted", sort_index=1)
    t0 = min((sp.start_s for sp in spans), default=0.0)
    tids: Dict[int, int] = {}
    for sp in spans:
        tid = tids.setdefault(sp.thread, len(tids))
    for thread, tid in tids.items():
        tb.thread(MEASURED_PID, tid, f"thread-{tid}")
        tb.thread(PREDICTED_PID, tid, f"thread-{tid}")
    n_paired = 0
    for sp in sorted(spans, key=lambda s: s.start_s):
        tid = tids[sp.thread]
        ts = sp.start_s - t0
        args = dict(sp.args)
        args["span_id"] = sp.span_id
        if sp.parent_id is not None:
            args["parent_id"] = sp.parent_id
        if sp.error:
            args["error"] = True
        if sp.kind == "instant":
            tb.instant(sp.name, ts, tid=tid, cat=sp.cat, args=args)
            continue
        if sp.predicted_s is not None and sp.predicted_s > 0 \
                and sp.dur_s > 0:
            n_paired += 1
        tb.paired(sp.name, ts, sp.dur_s, sp.predicted_s, tid=tid,
                  cat=sp.cat, args=args)
    info = {"n_spans": len(spans), "n_paired": n_paired}
    info.update(other_data or {})
    return tb.to_dict(info)


def save_trace(doc: dict, path: Optional[str] = None,
               name: str = "obs_trace.json") -> str:
    """Write an exporter document under ``artifacts/traces_torch/`` (or
    ``path``) and return the file path."""
    if path is None:
        path = os.path.join(traces_dir(), name)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


# ---------------------------------------------------------------------------
# simulator results -> (optionally paired) trace
# ---------------------------------------------------------------------------

def sim_trace(sim, max_ranks: int = 64, eval_result=None) -> dict:
    """The per-rank simulator timeline through the unified builder (one
    measured track per rank, same layout `SimResult.chrome_trace` always
    had).  When the cap truncates, the dropped count is *annotated* in
    ``otherData`` and logged — never silent.  With ``eval_result`` (a
    ``perf.evaluate`` ``EvalResult`` for the same scenario) the model's
    per-phase predictions appear on the paired predicted track, flow-
    linked to the critical rank's measured phases with residuals."""
    import numpy as np

    tb = TraceBuilder()
    tb.process(MEASURED_PID,
               f"{sim.algo}/{sim.variant} on {sim.topology}"
               f" (n={sim.n:g}, p={sim.p})", sort_index=0)
    shown = min(sim.p, int(max_ranks))
    dropped = sim.p - shown
    if dropped > 0:
        log.warning("sim trace for %s/%s truncated to %d of %d ranks "
                    "(pass max_ranks to widen)", sim.algo, sim.variant,
                    shown, sim.p)
    cr = sim.critical_rank
    for rk in range(shown):
        tb.thread(MEASURED_PID, rk,
                  f"rank {rk}" + (" [critical]" if rk == cr else ""))
    for name, ph in sim.phases.items():
        for rk in range(shown):
            dur = float(ph.exposed[rk])
            if dur <= 0:
                continue
            tb.complete(name, float(ph.start[rk]), dur, tid=rk, cat="phase")

    other = sim.summary()
    other["ranks_shown"] = shown
    other["ranks_dropped"] = dropped
    if eval_result is not None:
        tb.process(PREDICTED_PID, "predicted (cost model)", sort_index=1)
        tb.thread(PREDICTED_PID, 0, "model phases")
        t = 0.0
        residuals = {}
        for name, ph in eval_result.phases.items():
            pred = float(np.asarray(ph.exposed).reshape(-1)[0])
            if pred <= 0:
                t += max(pred, 0.0)
                continue
            sim_ph = sim.phases.get(name)
            args = {"predicted_s": pred}
            if sim_ph is not None:
                meas = float(sim_ph.exposed[cr])
                if meas > 0:
                    args.update(measured_s=meas, residual_s=meas - pred,
                                rel_err=abs(meas - pred) / meas)
                    residuals[name] = meas - pred
                    if cr < shown:
                        tb.flow(f"pair:{name}", from_ts_s=t,
                                from_pid=PREDICTED_PID, from_tid=0,
                                to_ts_s=float(sim_ph.start[cr]),
                                to_pid=MEASURED_PID, to_tid=cr)
            tb.complete(name, t, pred, pid=PREDICTED_PID, tid=0,
                        cat="phase", args=args)
            t += pred
        other["predicted_total_s"] = t
        other["phase_residual_s"] = residuals
    return tb.to_dict(other)


# ---------------------------------------------------------------------------
# scheduler step reports -> paired serving trace
# ---------------------------------------------------------------------------

def serving_trace(reports: Iterable,
                  other_data: Optional[dict] = None) -> dict:
    """Paired serving timeline from scheduler :class:`StepReport`s (a
    live run or a ``trace.replay``): per-step measured slices (clock
    deltas) against the cost model's predicted step composition, with
    per-phase prefill/decode sub-tracks, flow links, residual
    annotations, and counter tracks for queue depth, KV-block occupancy
    and batch composition."""
    tb = TraceBuilder()
    tb.process(MEASURED_PID, "measured (scheduler)", sort_index=0)
    tb.process(PREDICTED_PID, "predicted (ServeCostModel)", sort_index=1)
    for pid in (MEASURED_PID, PREDICTED_PID):
        tb.thread(pid, 0, "step")
        tb.thread(pid, 1, "prefill")
        tb.thread(pid, 2, "decode")

    n_steps = 0
    total_resid = 0.0
    for rep in reports:
        n_steps += 1
        pred = rep.predicted
        meas_pf = float(rep.measured_prefill_s)
        meas_dc = float(rep.measured_decode_s)
        measured = meas_pf + meas_dc
        if measured <= 0:                  # simulated clock: the schedule
            meas_pf, meas_dc = pred.prefill_s, pred.decode_s
            measured = pred.total_s
        ts = float(rep.clock) - measured
        args = {"step": rep.step, "admitted": list(rep.admitted),
                "finished": list(rep.finished),
                "prefill_tokens": sum(n for _, n in rep.plan.prefill),
                "decode_batch": len(rep.plan.decode)}
        tb.paired(f"step {rep.step}", ts, measured, pred.total_s,
                  tid=0, cat="serve_step", args=args)
        if meas_pf > 0 or pred.prefill_s > 0:
            tb.paired("prefill", ts, meas_pf, pred.prefill_s, tid=1,
                      cat="serve_step")
        if meas_dc > 0 or pred.decode_s > 0:
            tb.paired("decode", ts + meas_pf, meas_dc, pred.decode_s,
                      tid=2, cat="serve_step")
        total_resid += measured - pred.total_s
        tb.counter("queue", ts, {"waiting": rep.queue_depth,
                                 "active": rep.active})
        tb.counter("kv_blocks", ts, {"used": rep.kv_blocks_used,
                                     "total": rep.kv_blocks_total})
        tb.counter("batch", ts,
                   {"prefill_tokens": args["prefill_tokens"],
                    "decode_batch": args["decode_batch"]})
    info = {"n_steps": n_steps, "total_residual_s": total_resid}
    info.update(other_data or {})
    return tb.to_dict(info)
