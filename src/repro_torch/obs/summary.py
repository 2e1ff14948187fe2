"""CI-consumable roll-up of the observability stream.

:func:`summary` folds the tracer's buffered spans into per-tier
residual statistics — kernel launches, cost-IR op dispatches, serving
steps — using the same relative-error bucket bounds the metrics layer
uses, plus an alert roll-up and the registry snapshot.  The output is
plain JSON: a CI step can gate on ``tiers["op"]["mean_rel_err"]``
without parsing a trace viewer file.
"""

from __future__ import annotations

import json
import os
from bisect import bisect_left
from typing import Dict, Iterable, List, Optional

from .. import paths
from .metrics import REL_ERR_BUCKETS
from .spans import Span

#: span category -> residual tier.
_TIERS = {"kernel": "kernel", "dispatch": "op", "manual": "op",
          "serve": "serve", "serve_step": "serve"}


def tier_of(cat: str) -> Optional[str]:
    return _TIERS.get(cat)


def _tier_stats(spans: List[Span]) -> dict:
    paired = [sp for sp in spans if sp.rel_err is not None]
    errs = [sp.rel_err for sp in paired]
    resid = [sp.residual_s for sp in paired]
    counts = [0] * (len(REL_ERR_BUCKETS) + 1)
    for e in errs:
        counts[bisect_left(REL_ERR_BUCKETS, e)] += 1
    return {
        "n_spans": len(spans),
        "n_errors": sum(1 for sp in spans if sp.error),
        "n_paired": len(paired),
        "mean_rel_err": sum(errs) / len(errs) if errs else None,
        "max_rel_err": max(errs) if errs else None,
        "mean_residual_s": sum(resid) / len(resid) if resid else None,
        "rel_err_hist": {"bounds": list(REL_ERR_BUCKETS) + ["+Inf"],
                         "counts": counts},
    }


def summary(tracer=None, registry=None,
            spans: Optional[Iterable[Span]] = None) -> dict:
    """Per-tier residual roll-up + alerts + metrics snapshot."""
    from . import default_registry, tracer as _tracer

    if spans is None:
        tr = tracer if tracer is not None else _tracer()
        spans = tr.spans()
        dropped = tr.dropped
    else:
        spans = list(spans)
        dropped = 0
    reg = registry if registry is not None else default_registry()

    by_tier: Dict[str, List[Span]] = {}
    alerts: Dict[str, int] = {}
    for sp in spans:
        if sp.kind == "instant":
            if sp.cat == "alert":
                alerts[sp.name] = alerts.get(sp.name, 0) + 1
            continue
        t = tier_of(sp.cat)
        if t is not None:
            by_tier.setdefault(t, []).append(sp)

    return {
        "n_spans": len(spans),
        "n_dropped": dropped,
        "tiers": {t: _tier_stats(sps) for t, sps in sorted(by_tier.items())},
        "alerts": alerts,
        **reg.snapshot(),
    }


def save_summary(path: Optional[str] = None, **kwargs) -> str:
    """Write :func:`summary` JSON under ``artifacts/obs_torch/`` (or
    ``path``)."""
    if path is None:
        path = os.path.join(paths.obs_dir(), "summary.json")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(summary(**kwargs), f, indent=2, sort_keys=True)
    return path
