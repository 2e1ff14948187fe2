"""Bench-history store + statistical regression sentinel.

Every benchmark run emits ``artifacts/bench_torch/BENCH_*.json`` — a snapshot
with no memory: a change that halves simulator throughput sails through as
long as the absolute gates still pass.  This module gives the bench
trajectory a history:

* :class:`BenchHistory` — an append-only JSONL file under
  ``artifacts/bench_torch/history/`` (``$REPRO_TORCH_BENCH_HISTORY_DIR``;
  ``repro_torch.paths``; same discipline as the telemetry
  :class:`~repro_torch.telemetry.store.RunStore`: schema-versioned lines,
  skip-don't-crash reads).  Each line is one benchmark's flattened
  numeric metrics stamped with the run metadata the emitters now carry
  (commit SHA, timestamp, machine fingerprint, repeat count) — so runs
  are joinable across commits *and* noise bands are computed per
  machine, never mixing a laptop's numbers with CI's.
* :func:`check_regressions` — for each (bench, metric) with enough
  same-machine history: baseline = median of past runs, noise band =
  ``band_sigmas`` robust standard deviations (MAD-scaled) of past runs
  floored at ``rel_floor`` of the baseline.  A current value outside the
  band *in the bad direction* is a regression; the good direction is
  reported as an improvement.  Direction comes from metric-name
  conventions (throughputs up, errors/latencies down) with an explicit
  override table for the exceptions.

``python -m benchmarks.run --check-regressions`` runs the sentinel over
the freshly-written ``BENCH_*.json`` files and appends them to history;
CI treats "insufficient history" as warn-only (the first runs build the
baseline) and a verdicted regression as a failure.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import statistics
from typing import Dict, List, Optional, Sequence

from ... import paths

#: bump when the history line format changes incompatibly.
HISTORY_SCHEMA = 1

#: minimum same-machine history runs before the sentinel may fail a metric.
MIN_HISTORY = 3


def history_dir() -> str:
    """The default history's directory, resolved at each call."""
    return paths.bench_history_dir()


@dataclasses.dataclass
class BenchRun:
    """One benchmark's numbers from one run, joinable by commit+machine."""

    bench: str                       # "BENCH_obs", "fig5to8", ...
    commit: str
    fingerprint: str                 # machine fingerprint
    timestamp: float
    metrics: Dict[str, float]        # flattened numeric leaves
    meta: Dict[str, object] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["schema"] = HISTORY_SCHEMA
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "BenchRun":
        d = dict(d)
        if d.pop("schema", None) != HISTORY_SCHEMA:
            raise ValueError("bench history schema mismatch")
        return cls(**d)


def flatten_metrics(obj, prefix: str = "",
                    out: Optional[Dict[str, float]] = None,
                    max_depth: int = 6) -> Dict[str, float]:
    """Numeric leaves of a bench JSON as dotted paths.  Booleans become
    0/1 (they are go/no-go claims worth tracking); strings, nulls and
    list-of-dict internals are skipped; lists of numbers get indexed
    entries (small ones only — bench payloads keep these short)."""
    if out is None:
        out = {}
    if max_depth < 0:
        return out
    if isinstance(obj, dict):
        for k, v in obj.items():
            if str(k).startswith("_"):
                continue                      # _meta and friends
            flatten_metrics(v, prefix + str(k) + ".", out, max_depth - 1)
    elif isinstance(obj, bool):
        out[prefix[:-1]] = 1.0 if obj else 0.0
    elif isinstance(obj, (int, float)):
        v = float(obj)
        if math.isfinite(v):
            out[prefix[:-1]] = v
    elif isinstance(obj, (list, tuple)) and len(obj) <= 16:
        for i, v in enumerate(obj):
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                flatten_metrics(v, f"{prefix}{i}.", out, max_depth - 1)
    return out


class BenchHistory:
    """Append-only JSONL history of :class:`BenchRun` lines."""

    def __init__(self, directory: Optional[str] = None):
        self.directory = directory or history_dir()
        self.skipped_lines = 0

    @property
    def path(self) -> str:
        return os.path.join(self.directory, "history.jsonl")

    def append(self, run: BenchRun) -> None:
        os.makedirs(self.directory, exist_ok=True)
        with open(self.path, "a") as f:
            f.write(json.dumps(run.to_dict(), sort_keys=True) + "\n")

    def load(self, bench: Optional[str] = None,
             fingerprint: Optional[str] = None) -> List[BenchRun]:
        try:
            with open(self.path) as f:
                lines = f.readlines()
        except OSError:
            return []
        out: List[BenchRun] = []
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                run = BenchRun.from_dict(json.loads(line))
            except (ValueError, TypeError):
                self.skipped_lines += 1
                continue
            if bench is not None and run.bench != bench:
                continue
            if fingerprint is not None and run.fingerprint != fingerprint:
                continue
            out.append(run)
        out.sort(key=lambda r: r.timestamp)
        return out

    def ingest_dir(self, bench_dir: str,
                   meta: Optional[dict] = None) -> List[BenchRun]:
        """Append one :class:`BenchRun` per readable ``BENCH_*.json`` in
        ``bench_dir``.  Run metadata comes from each file's stamped
        ``_meta`` block (benchmarks/common.run_meta), overridable by the
        ``meta`` argument; unstamped files get empty commit/fingerprint
        (still stored, never joined into a noise band)."""
        runs: List[BenchRun] = []
        try:
            names = sorted(os.listdir(bench_dir))
        except OSError:
            return runs
        for name in names:
            m = re.fullmatch(r"(BENCH_[A-Za-z0-9_]+)\.json", name)
            if not m:
                continue
            try:
                with open(os.path.join(bench_dir, name)) as f:
                    payload = json.load(f)
            except (OSError, ValueError):
                continue
            stamped = dict(payload.get("_meta") or {})
            if meta:
                stamped.update(meta)
            run = BenchRun(
                bench=m.group(1),
                commit=str(stamped.get("commit", "")),
                fingerprint=str(stamped.get("fingerprint", "")),
                timestamp=float(stamped.get("timestamp", 0.0)),
                metrics=flatten_metrics(payload),
                meta=stamped)
            self.append(run)
            runs.append(run)
        return runs


# -- regression verdicts ------------------------------------------------------

#: explicit direction overrides: +1 higher-is-better, -1 lower-is-better,
#: 0 two-sided.  Everything else goes through the name heuristics below.
DIRECTION_OVERRIDES: Dict[str, int] = {
    "revision": 0,
    "n": 0,
}

_HIGHER = ("per_sec", "per_s", "speedup", "goodput", "throughput",
           "events", "spans", "rps", "_ok", "agreement", "eff", "ratio",
           "flow_events", "n_requests", "n_rows", "peak")
_LOWER = ("err", "_us", "_ms", "_s", "seconds", "overhead", "wall",
          "dropped", "p95", "p99", "latency", "rel", "bytes")


def metric_direction(name: str) -> int:
    """+1 regression-if-lower, -1 regression-if-higher, 0 two-sided."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in DIRECTION_OVERRIDES:
        return DIRECTION_OVERRIDES[leaf]
    low = name.lower()
    # higher-is-better tokens win (a "goodput_ratio" is a ratio to grow;
    # "events_per_sec" contains "_s" only via "per_sec")
    if any(t in low for t in _HIGHER):
        return 1
    if any(t in low for t in _LOWER):
        return -1
    return 0


@dataclasses.dataclass
class Finding:
    bench: str
    metric: str
    verdict: str          # "regression" | "improvement" | "ok" | "no_history"
    current: float
    baseline: Optional[float] = None
    band: Optional[float] = None
    n_history: int = 0
    direction: int = 0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def check_regressions(current: Dict[str, Dict[str, float]],
                      history: Sequence[BenchRun], *,
                      fingerprint: Optional[str] = None,
                      min_history: int = MIN_HISTORY,
                      band_sigmas: float = 4.0,
                      rel_floor: float = 0.10) -> dict:
    """Verdict every metric of ``current`` against same-machine history.

    ``current`` maps bench name -> flattened metrics (what
    :meth:`BenchHistory.ingest_dir` stores).  The noise band per metric is
    ``max(band_sigmas * 1.4826 * MAD(past), rel_floor * |median|)`` — the
    MAD term tracks each metric's own run-to-run jitter, the relative
    floor keeps near-deterministic metrics from flagging on roundoff.
    """
    by_bench: Dict[str, List[BenchRun]] = {}
    for run in history:
        if fingerprint is not None and run.fingerprint != fingerprint:
            continue
        by_bench.setdefault(run.bench, []).append(run)

    findings: List[Finding] = []
    for bench, metrics in sorted(current.items()):
        past_runs = by_bench.get(bench, [])
        for metric, value in sorted(metrics.items()):
            past = [r.metrics[metric] for r in past_runs
                    if metric in r.metrics]
            if len(past) < min_history:
                findings.append(Finding(bench, metric, "no_history",
                                        value, n_history=len(past)))
                continue
            med = statistics.median(past)
            mad = statistics.median(abs(x - med) for x in past)
            band = max(band_sigmas * 1.4826 * mad, rel_floor * abs(med))
            direction = metric_direction(metric)
            delta = value - med
            if direction > 0 and delta < -band:
                verdict = "regression"
            elif direction < 0 and delta > band:
                verdict = "regression"
            elif direction == 0 and abs(delta) > band:
                verdict = "regression"
            elif abs(delta) > band:
                verdict = "improvement"
            else:
                verdict = "ok"
            findings.append(Finding(bench, metric, verdict, value,
                                    baseline=med, band=band,
                                    n_history=len(past),
                                    direction=direction))

    n = {"regression": 0, "improvement": 0, "ok": 0, "no_history": 0}
    for f in findings:
        n[f.verdict] += 1
    gated = n["ok"] + n["regression"] + n["improvement"]
    return {
        "counts": n,
        "gated_metrics": gated,
        "sufficient_history": gated > 0,
        "regressions": [f.to_dict() for f in findings
                        if f.verdict == "regression"],
        "improvements": [f.to_dict() for f in findings
                         if f.verdict == "improvement"],
        "findings": [f.to_dict() for f in findings],
    }


def format_report(report: dict, max_rows: int = 20) -> str:
    """Human-readable sentinel verdict (CI log output)."""
    c = report["counts"]
    lines = [f"bench-history sentinel: {report['gated_metrics']} gated "
             f"metrics ({c['ok']} ok, {c['improvement']} improved, "
             f"{c['regression']} regressed; {c['no_history']} without "
             f"history yet)"]
    for f in report["regressions"][:max_rows]:
        arrow = "^" if f["direction"] < 0 else "v"
        lines.append(
            f"  REGRESSION {arrow} {f['bench']}:{f['metric']} = "
            f"{f['current']:.6g} vs baseline {f['baseline']:.6g} "
            f"(band +/-{f['band']:.3g}, n={f['n_history']})")
    for f in report["improvements"][:max_rows]:
        lines.append(
            f"  improvement  {f['bench']}:{f['metric']} = "
            f"{f['current']:.6g} vs baseline {f['baseline']:.6g}")
    return "\n".join(lines)
