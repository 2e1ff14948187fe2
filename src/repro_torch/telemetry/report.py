"""Paper-style accuracy reporting over the residual table.

The paper validates its models with per-algorithm tables of predicted vs
measured %-of-peak (Tables II-V) and relative-error plots (Figs. 5-8);
``accuracy_report`` produces the same summary — per-algorithm mean / max
relative error plus the log-ratio the refit optimizes — continuously,
from whatever the telemetry store has recorded.  ``save_report`` drops it
as JSON next to the run files so CI can gate on it.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence

import numpy as np

from .residuals import Residual, mean_abs_log_ratio
from .store import telemetry_dir


def accuracy_report(rows: Sequence[Residual]) -> dict:
    """Per-op and overall accuracy of the current model vs measurement."""
    by_op: Dict[str, list] = {}
    for r in rows:
        if r.source == "model":
            by_op.setdefault(r.op, []).append(r)
    ops = {}
    for op, op_rows in sorted(by_op.items()):
        rel = [r.rel_err for r in op_rows]
        ops[op] = {
            "n_rows": len(op_rows),
            "mean_rel_err": float(np.mean(rel)),
            "max_rel_err": float(np.max(rel)),
            "mean_abs_log_ratio": mean_abs_log_ratio(op_rows),
            "phases": sorted({r.phase for r in op_rows}),
        }
    all_rows = [r for rs in by_op.values() for r in rs]
    overall = {
        "n_rows": len(all_rows),
        "mean_rel_err": (float(np.mean([r.rel_err for r in all_rows]))
                         if all_rows else float("nan")),
        "max_rel_err": (float(np.max([r.rel_err for r in all_rows]))
                        if all_rows else float("nan")),
        "mean_abs_log_ratio": mean_abs_log_ratio(all_rows),
    }
    return {"ops": ops, "overall": overall}


def format_report(report: dict) -> str:
    """Fixed-width text table (the Tables II-V look, rel-err flavored)."""
    lines = [f"{'op':<12} {'rows':>5} {'mean rel err':>13} "
             f"{'max rel err':>12} {'mean |log r|':>13}"]
    for op, row in report["ops"].items():
        lines.append(f"{op:<12} {row['n_rows']:>5} "
                     f"{row['mean_rel_err']:>12.1%} "
                     f"{row['max_rel_err']:>11.1%} "
                     f"{row['mean_abs_log_ratio']:>13.3f}")
    ov = report["overall"]
    lines.append(f"{'overall':<12} {ov['n_rows']:>5} "
                 f"{ov['mean_rel_err']:>12.1%} "
                 f"{ov['max_rel_err']:>11.1%} "
                 f"{ov['mean_abs_log_ratio']:>13.3f}")
    return "\n".join(lines)


def save_report(report: dict, path: Optional[str] = None) -> str:
    """Write the report JSON under ``artifacts/telemetry_torch/`` (the
    reference's CI gates its own report's
    ``overall.mean_rel_err``); returns the path."""
    if path is None:
        path = os.path.join(telemetry_dir(), "report.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(report, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    return path
