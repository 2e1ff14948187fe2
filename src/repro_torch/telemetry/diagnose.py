"""Fault diagnosis: localize a degraded component and re-key the models.

Drift detection (``telemetry.drift``) answers *that* the
machine moved — predictions are off by a sustained factor.  This module
answers *where*: which physical link or rank is sick, how sick, and what
the planner should assume about it.  The closed loop is

  residual firing -> :class:`DiagnosisResponder` -> probe the measured
  channel with shift patterns -> :func:`localize_link` /
  :func:`localize_rank` score components -> :func:`emit_degraded_profile`
  re-registers the machine at ``revision + 1`` with a
  :class:`~repro_torch.sim.faults.FaultSpec` attached to its surface -> every
  plan-cache key and telemetry store file keyed by the old fingerprint is
  retired -> ``Tuner.plan`` re-plans (sim-refined, fault injected) and
  provably routes around the sick component.

Link localization is probe-based, mirroring the paper's calibration
methodology: the shift pattern ``rank -> rank + d`` at a few distances is
replayed through the *measured* channel (real hardware, or a faulted
``sim.Network`` standing in for it) and through the healthy model.  Ranks
whose measured/modeled duration ratio is high are "late"; every link on a
late rank's route is charged ``ratio - 1`` and the highest-scoring link
is the suspect — at ``d`` small most routes are single-hop, so the probe
pins the link nearly directly.  Severity is the median lateness of the
ranks crossing it, which is exactly the per-link beta multiplier a
:class:`~repro_torch.sim.faults.DegradedLink` injects.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import obs
from ..sim.faults import DegradedLink, FaultSpec, SlowRank


@dataclasses.dataclass
class Diagnosis:
    """One localized fault hypothesis (or the healthy verdict)."""

    kind: str                    # "degraded_link" | "slow_rank" | "healthy"
    component: int = -1          # physical link id / rank (kind-dependent)
    severity: float = 1.0        # beta / compute multiplier estimate
    windows: int = 0             # observation windows until localization
    component_name: str = ""     # human-readable (topology.link_name)
    evidence: Dict[str, object] = dataclasses.field(default_factory=dict)

    @property
    def healthy(self) -> bool:
        return self.kind == "healthy"

    def to_fault_spec(self) -> FaultSpec:
        """The injectable counterpart of this hypothesis — what a degraded
        machine surface carries into every candidate simulation."""
        if self.kind == "degraded_link":
            return FaultSpec(degraded_links=(
                DegradedLink(int(self.component),
                             max(float(self.severity), 1.0)),))
        if self.kind == "slow_rank":
            return FaultSpec(slow_ranks=(
                SlowRank(int(self.component),
                         max(float(self.severity), 1.0)),))
        return FaultSpec()

    def to_dict(self) -> dict:
        return {"kind": self.kind, "component": int(self.component),
                "severity": float(self.severity), "windows": int(self.windows),
                "component_name": self.component_name}


def default_probe_distances(topology, p: int) -> Tuple[int, ...]:
    """Probe distances that exercise every routing dimension: on a torus,
    ``rank -> rank + d`` moves in the dimension whose stride divides ``d``
    (node numbering is dimension-0 fastest), so one probe per dimension
    stride — plus a two-hop confirmation where the ring allows — covers
    all links.  Non-torus topologies get small distances (every channel
    pair is distinct anyway on a crossbar)."""
    shape = getattr(topology, "shape", None)
    if not shape:
        return (1, 2, 3)
    out: List[int] = []
    stride = 1
    for k in shape:
        if 0 < stride < p:
            out.append(stride)
            if k > 2 and 0 < 2 * stride < p:
                out.append(2 * stride)
        stride *= k
    return tuple(out) or (1,)


def probe_shift_durations(network, p: int, d: int, *,
                          words: float = 4096.0,
                          start: float = 0.0) -> np.ndarray:
    """Per-rank duration of one ``rank -> rank + d`` probe pattern through
    ``network`` (all ranks inject ``words`` at ``start``)."""
    starts = np.full(int(p), float(start))
    done = network.deliver_shift(starts, float(words), int(d),
                                 network.latency)
    return done - starts


def localize_link(topology, p: int, *,
                  measure: Callable[[int], np.ndarray],
                  baseline: Callable[[int], np.ndarray],
                  distances: Sequence[int] = (1, 2, 3),
                  late_ratio: float = 1.25) -> Diagnosis:
    """Score every link by the lateness of the probe ranks routed over it.

    ``measure(d)`` / ``baseline(d)`` return per-rank durations of the
    shift-``d`` probe through the measured channel and the healthy model.
    Ranks with ``measure/baseline >= late_ratio`` are late; each link on a
    late rank's route accumulates ``ratio - 1`` and the argmax is the
    suspect.  Severity is the median ratio of the late ranks that cross
    it (the per-link beta multiplier estimate)."""
    score: Dict[int, float] = {}
    rounds: List[Tuple[int, np.ndarray, np.ndarray]] = []
    for d in distances:
        meas = np.asarray(measure(d), dtype=float)
        base = np.maximum(np.asarray(baseline(d), dtype=float), 1e-30)
        ratio = meas / base
        late = ratio >= late_ratio
        if not late.any():
            continue
        plan = topology.shift_plan(int(p), int(d))
        for r in np.flatnonzero(late):
            for l in plan.links[plan.indptr[r]:plan.indptr[r + 1]]:
                score[int(l)] = score.get(int(l), 0.0) + float(ratio[r] - 1.0)
        rounds.append((int(d), ratio, late))
    if not score:
        return Diagnosis(kind="healthy",
                         evidence={"distances": list(distances)})
    best = max(score, key=lambda l: score[l])
    sev: List[float] = []
    for d, ratio, late in rounds:
        plan = topology.shift_plan(int(p), d)
        for r in np.flatnonzero(late):
            if best in plan.links[plan.indptr[r]:plan.indptr[r + 1]]:
                sev.append(float(ratio[r]))
    severity = max(float(np.median(sev)), 1.0) if sev else 1.0
    return Diagnosis(
        kind="degraded_link", component=int(best), severity=severity,
        component_name=topology.link_name(int(best)),
        evidence={"score": {int(k): float(v) for k, v in score.items()},
                  "distances": [d for d, _, _ in rounds]})


def localize_rank(per_rank_seconds: np.ndarray, *,
                  ratio_threshold: float = 2.0) -> Diagnosis:
    """Slow-rank localization from per-rank busy seconds (e.g. the
    compute ledger of a simulated or measured run): the worst rank's
    time over the median, when it clears the threshold."""
    arr = np.asarray(per_rank_seconds, dtype=float)
    med = max(float(np.median(arr)), 1e-30)
    worst = int(np.argmax(arr))
    ratio = float(arr[worst]) / med
    if ratio < ratio_threshold:
        return Diagnosis(kind="healthy", evidence={"cmax_over_med": ratio})
    return Diagnosis(kind="slow_rank", component=worst, severity=ratio,
                     component_name=f"rank{worst}",
                     evidence={"cmax_over_med": ratio})


def probe_links(measured_network, *, p: Optional[int] = None,
                distances: Optional[Sequence[int]] = None,
                words: float = 4096.0,
                late_ratio: float = 1.25) -> Diagnosis:
    """Link localization with the healthy baseline built internally: probe
    ``measured_network`` (real hardware behind a shim, or a faulted
    ``sim.Network`` standing in for it) and compare against a pristine
    ``Network`` on the same topology/latency/beta.  Default distances
    cover every routing dimension (:func:`default_probe_distances`)."""
    from ..sim.network import Network
    topo = measured_network.topology
    p = int(p) if p is not None else topo.n_nodes
    if distances is None:
        distances = default_probe_distances(topo, p)
    healthy = Network(topo, measured_network.latency, measured_network.beta)
    return localize_link(
        topo, p,
        measure=lambda d: probe_shift_durations(measured_network, p, d,
                                                words=words),
        baseline=lambda d: probe_shift_durations(healthy, p, d, words=words),
        distances=distances, late_ratio=late_ratio)


def emit_degraded_profile(registry, machine_name: str, faults: FaultSpec,
                          *, diagnosis: Optional[Diagnosis] = None):
    """Re-register ``machine_name`` at ``revision + 1`` with ``faults``
    attached to its surface.

    The bumped revision changes ``Machine.fingerprint()`` — retiring
    every tuner plan-cache entry and telemetry store file keyed by the
    healthy profile — and the surface-carried ``FaultSpec`` makes the
    next ``Tuner.plan`` call sim-refine with the fault injected.  The
    spec deliberately lives on the surface, not inside ``Machine``, so
    emission always moves the fingerprint exactly one revision.

    Returns the new :class:`~repro_torch.core.machine.Machine`."""
    surface = registry.machine(machine_name)
    machine = dataclasses.replace(surface.machine,
                                  revision=surface.machine.revision + 1)
    registry.register_machine(machine, surface.efficiency,
                              surface.calibration, overwrite=True,
                              faults=faults)
    obs.alert("degraded_profile", machine=machine_name,
              revision=machine.revision, faults=faults.to_dict(),
              **({"diagnosis": diagnosis.to_dict()} if diagnosis else {}))
    return machine


class DiagnosisResponder:
    """An on-fire hook of a drift watch that closes detection into
    diagnosis.

    Where a revision responder only bumps the revision, this responder runs ``diagnose_fn(firing)`` — typically
    a probe sweep ending in :func:`probe_links` — and, when a real fault
    comes back, emits the degraded profile (revision bump + surface
    ``FaultSpec``) via :func:`emit_degraded_profile`.  Latched one
    response per revision, mirroring the drift latch: a burst of firings
    from one degradation episode diagnoses once."""

    def __init__(self, registry, machine_name: str,
                 diagnose_fn: Callable[[object], Optional[Diagnosis]],
                 series_filter: Optional[Callable[[object], bool]] = None):
        self.registry = registry
        self.machine_name = machine_name
        self.diagnose_fn = diagnose_fn
        self.series_filter = series_filter
        self.responses: List[dict] = []
        self._fired_at_revision: Optional[int] = None

    def __call__(self, firing):
        if self.series_filter is not None and not self.series_filter(firing):
            return None
        current = self.registry.machine(self.machine_name).machine.revision
        if self._fired_at_revision is not None \
                and current == self._fired_at_revision:
            return None                      # already responded; latched
        diagnosis = self.diagnose_fn(firing)
        if diagnosis is None or diagnosis.healthy:
            return None
        machine = emit_degraded_profile(self.registry, self.machine_name,
                                        diagnosis.to_fault_spec(),
                                        diagnosis=diagnosis)
        self._fired_at_revision = machine.revision
        self.responses.append({"series": getattr(firing, "series", None),
                               "diagnosis": diagnosis.to_dict(),
                               "revision": machine.revision})
        return diagnosis
