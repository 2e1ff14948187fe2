"""Drift detection: when measurements stop matching the model, retire it.

A refit profile is only valid while the hardware keeps behaving the way
the residuals said it did — thermal throttling, a noisy neighbor, a BLAS
or XLA upgrade all shift the ground truth under a frozen model.  The
detector keeps a rolling mean of the per-op relative error (newest
``window`` residual rows per op); when it crosses ``threshold`` the
machine profile's ``revision`` is bumped and re-registered, which changes
``Machine.fingerprint()`` and therefore every tuner plan-cache key — the
stale plans are not deleted, they simply can never be recalled again.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.machine import Machine
from .. import obs
from .residuals import Residual

#: default rolling window (rows per op) and mean-relative-error threshold.
DEFAULT_WINDOW = 10
DEFAULT_THRESHOLD = 0.75
#: fewer rows than this in an op's window is not evidence, just noise.
MIN_ROWS = 3


class DriftLatch:
    """Fired-at-revision / fired-on-evidence latch for the drift path.

    Without it the detector double-fires: every ``check`` over a
    still-drifted window re-emits the same ``obs.alert("drift")``, and
    every ``detect_and_invalidate`` re-bumps the machine revision —
    which silently re-keys the plan cache and telemetry stores once per
    call instead of once per drift episode.  The latch records

    * per ``(machine, op)``: the newest residual timestamp that has
      already alerted — the same window re-checked is silent, a window
      containing *new* evidence fires again;
    * per machine: the revision our own bump produced — while the
      registry still holds that revision, further bumps are swallowed.
      A healthy check (nothing drifted) re-arms the machine, as does any
      outside revision change (e.g. the streaming watch responder).

    ``DriftStatus.drifted`` itself stays truthful either way — the latch
    gates side effects (alerts, bumps), never the diagnosis.
    """

    def __init__(self):
        self._alerted: Dict[tuple, float] = {}
        self._bumped: Dict[str, int] = {}

    def arm_alert(self, machine: str, op: str, newest_ts: float) -> bool:
        key = (machine, op)
        last = self._alerted.get(key)
        if last is not None and newest_ts <= last:
            return False
        self._alerted[key] = newest_ts
        return True

    def should_bump(self, machine_name: str, current_revision: int) -> bool:
        return self._bumped.get(machine_name) != current_revision

    def record_bump(self, machine_name: str, new_revision: int) -> None:
        self._bumped[machine_name] = new_revision

    def clear_bump(self, machine_name: str) -> None:
        self._bumped.pop(machine_name, None)

    def clear(self) -> None:
        self._alerted.clear()
        self._bumped.clear()


#: process-global latch (``telemetry.reset()`` clears it); pass your own
#: :class:`DriftLatch` for isolated pipelines.
_LATCH = DriftLatch()


def reset_latch() -> None:
    _LATCH.clear()


@dataclasses.dataclass
class DriftStatus:
    """Rolling accuracy of one op against the current profile."""

    op: str
    rolling_mean_rel_err: float
    n_rows: int
    window: int
    threshold: float

    @property
    def drifted(self) -> bool:
        return (self.n_rows >= MIN_ROWS
                and self.rolling_mean_rel_err > self.threshold)


def check(rows: Sequence[Residual], *, threshold: float = DEFAULT_THRESHOLD,
          window: int = DEFAULT_WINDOW,
          sources: Sequence[str] = ("model",),
          latch: Optional[DriftLatch] = None) -> Dict[str, DriftStatus]:
    """Per-op rolling mean relative error over the newest ``window`` rows
    (model-source rows by default; the sim flavor has its own error
    profile).  Pass ``sources=("model", "serve")`` to let scheduler
    serve-step residuals trigger invalidation too — a revision bump
    re-keys the serving cost tables exactly like the tuner plan cache,
    since both are keyed by ``Machine.fingerprint()``."""
    if latch is None:
        latch = _LATCH
    by_op: Dict[str, List[Residual]] = {}
    for r in rows:
        if r.source not in sources:
            continue
        by_op.setdefault(r.op, []).append(r)
    out: Dict[str, DriftStatus] = {}
    for op, op_rows in by_op.items():
        op_rows.sort(key=lambda r: r.timestamp)
        tail = op_rows[-window:]
        err = float(np.mean([r.rel_err for r in tail]))
        st = DriftStatus(op=op, rolling_mean_rel_err=err,
                         n_rows=len(tail), window=window,
                         threshold=threshold)
        out[op] = st
        if st.drifted and latch.arm_alert(tail[-1].machine, op,
                                          tail[-1].timestamp):
            # structured alert into the obs stream (instant event +
            # obs_alerts_total counter); no-op when tracing is off.
            # The latch keeps a re-check of the same window silent —
            # one alert per piece of evidence, not per call.
            obs.alert("drift", op=op, rolling_mean_rel_err=err,
                      threshold=threshold, window=window,
                      n_rows=st.n_rows)
    return out


def bump_revision(registry, machine_name: str) -> Machine:
    """Re-register ``machine_name`` with ``revision + 1`` (surfaces kept).

    The new fingerprint retires every plan-cache entry and telemetry file
    keyed by the old one; returns the new :class:`Machine`."""
    surface = registry.machine(machine_name)
    machine = dataclasses.replace(surface.machine,
                                  revision=surface.machine.revision + 1)
    registry.register_machine(machine, surface.efficiency,
                              surface.calibration, overwrite=True,
                              faults=getattr(surface, "faults", None))
    return machine


def detect_and_invalidate(rows: Sequence[Residual], registry,
                          machine_name: str, *,
                          threshold: float = DEFAULT_THRESHOLD,
                          window: int = DEFAULT_WINDOW,
                          sources: Sequence[str] = ("model",),
                          latch: Optional[DriftLatch] = None
                          ) -> Optional[Machine]:
    """The full drift step: check the rolling error; on any drifted op,
    bump the machine revision.  Returns the new Machine (None when the
    profile is still healthy, or when the latch shows this drift episode
    already bumped the revision the registry still holds)."""
    if latch is None:
        latch = _LATCH
    statuses = check(rows, threshold=threshold, window=window,
                     sources=sources, latch=latch)
    if not any(s.drifted for s in statuses.values()):
        latch.clear_bump(machine_name)      # healthy -> re-arm
        return None
    current = registry.machine(machine_name).machine.revision
    if not latch.should_bump(machine_name, current):
        return None                         # this episode already bumped
    machine = bump_revision(registry, machine_name)
    latch.record_bump(machine_name, machine.revision)
    return machine
