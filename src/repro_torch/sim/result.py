"""Structured simulation output and the Chrome-trace emitter.

A :class:`SimResult` is the simulator's analog of ``repro_torch.perf.EvalResult``
with the scenario axis replaced by the *rank* axis: per-rank per-phase
times, the critical rank/path, per-link utilization, and the achieved
overlap efficiency.  ``dump_chrome_trace`` writes a ``chrome://tracing`` /
Perfetto-loadable JSON timeline (one track per rank) under
``artifacts/traces_torch/`` (``repro_torch.paths``).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import paths
from .network import LinkStats


def traces_dir() -> str:
    return paths.traces_dir()


@dataclasses.dataclass
class RankPhase:
    """One top-level phase: per-rank start / exposed seconds plus the
    serialized comm/comp ledgers (arrays of shape ``(p,)``)."""

    start: np.ndarray
    exposed: np.ndarray
    comm: np.ndarray
    comp: np.ndarray


@dataclasses.dataclass
class SimResult:
    """Per-rank discrete-event execution of one cost-IR program."""

    algo: str
    variant: str
    n: float
    p: int
    c: float
    r: float
    topology: str
    total: float                    # makespan: max over ranks
    per_rank: np.ndarray            # final clock per rank, shape (p,)
    comm: np.ndarray                # serialized comm seconds per rank
    comp: np.ndarray                # serialized comp seconds per rank
    phases: Dict[str, RankPhase]    # insertion-ordered top-level phases
    link_stats: LinkStats
    events: int
    engine: str = "vector"          # "vector" (folded sparse) | "reference"

    @property
    def critical_rank(self) -> int:
        return int(np.argmax(self.per_rank))

    @property
    def critical_path(self) -> List[Tuple[str, float]]:
        """(phase, exposed seconds) on the critical rank, in program order."""
        cr = self.critical_rank
        return [(name, float(ph.exposed[cr])) for name, ph in self.phases.items()]

    @property
    def overlap_efficiency(self) -> float:
        """Achieved / ideal hidden time, averaged over ranks: 1.0 when every
        overlappable second was hidden, 0.0 when nothing overlapped (and by
        convention 1.0 for programs with no overlap headroom)."""
        hidden = self.comm + self.comp - self.per_rank
        ideal = np.minimum(self.comm, self.comp)
        ok = ideal > 0
        if not ok.any():
            return 1.0
        return float(np.mean(np.clip(hidden[ok] / ideal[ok], 0.0, 1.0)))

    def utilization_histogram(self, bins: int = 8) -> Dict[str, list]:
        return self.link_stats.utilization_histogram(self.total, bins=bins)

    def summary(self) -> dict:
        return {
            "algo": self.algo, "variant": self.variant,
            "n": float(self.n), "p": int(self.p),
            "c": float(self.c), "r": float(self.r),
            "topology": self.topology,
            "total_s": float(self.total),
            "critical_rank": self.critical_rank,
            "overlap_efficiency": self.overlap_efficiency,
            "events": int(self.events),
            "engine": self.engine,
            "link_utilization": self.utilization_histogram(),
        }

    # -- Chrome trace --------------------------------------------------------
    def chrome_trace(self, max_ranks: int = 64, eval_result=None) -> dict:
        """Trace-event JSON through the unified obs exporter: one ``tid``
        per rank (phases as complete events), plus process metadata.
        Capping at ``max_ranks`` tracks is *announced*: a warning is
        logged and ``otherData`` carries ``ranks_shown``/``ranks_dropped``.
        With ``eval_result`` (the model's :class:`~repro_torch.perf.evaluate`
        ``EvalResult`` for the same scenario) predicted per-phase spans
        appear on a paired track, flow-linked to the critical rank with
        signed residual annotations."""
        from ..obs import sim_trace
        return sim_trace(self, max_ranks=max_ranks, eval_result=eval_result)

    def dump_chrome_trace(self, path: Optional[str] = None,
                          max_ranks: int = 64, eval_result=None) -> str:
        """Write the trace under ``artifacts/traces_torch/`` (or ``path``) and
        return the file path."""
        if path is None:
            safe_v = self.variant.replace(".", "")
            path = os.path.join(
                traces_dir(),
                f"{self.algo}_{safe_v}_n{int(self.n)}_p{self.p}.json")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.chrome_trace(max_ranks=max_ranks,
                                        eval_result=eval_result), f)
        return path
