"""repro_torch.telemetry — the measured-run feedback loop.

Every layer below this one *predicts*: the cost IR estimates, the
simulator replays, the tuner plans.  This package closes the paper's
methodology loop by feeding what the hardware actually did back into
those predictions:

  record.py     PhaseTimer instrumentation (context manager + decorator)
                wired into linalg dispatch;
                recording is off unless REPRO_TELEMETRY=1 / enable()
  store.py      append-only JSONL run store under
                artifacts/telemetry_torch/,
                keyed by machine fingerprint, schema-versioned, compactable
  residuals.py  join measured runs against perf.evaluate per-phase
                predictions (and optionally repro_torch.sim) -> ratio rows
  refit.py      online recalibration: Nelder-Mead efficiency-curve fit +
                ridge-scaled calibration tables, emitted as a new
                Machine-profile *revision* (never mutated in place)
  drift.py      rolling per-op relative error; crossing the threshold
                bumps Machine.revision, changing the fingerprint and so
                retiring every stale tuner plan-cache entry
  diagnose.py   fault localization: shift-pattern probes score links by
                the lateness of ranks routed over them; the winning
                hypothesis is emitted as a *degraded* machine revision
                whose surface carries an injectable FaultSpec
  report.py     the paper's accuracy tables (mean/max relative error per
                algorithm) as a living report, JSON-saved for CI gates

Closed loop: dispatch records -> residuals join -> refit shrinks the
error -> drift detection retires the profile when reality moves again.
"""

from .store import RunRecord, RunStore, TELEMETRY_SCHEMA, telemetry_dir
from .record import (PhaseTimer, default_store, disable, enable, enabled,
                     kernel_timer, observe_plan, phase_scope, reset,
                     timer_for_plan)
from .residuals import (Residual, TOTAL_PHASES, join, mean_abs_log_ratio,
                        split_comm_comp)
from .refit import KernelRefitResult, RefitResult, refit, refit_kernels
from .drift import (DEFAULT_THRESHOLD, DEFAULT_WINDOW, DriftLatch,
                    DriftStatus, bump_revision, check,
                    detect_and_invalidate, reset_latch)
from .diagnose import (Diagnosis, DiagnosisResponder,
                       default_probe_distances, emit_degraded_profile,
                       localize_link, localize_rank, probe_links,
                       probe_shift_durations)
from .report import accuracy_report, format_report, save_report

__all__ = [
    "RunRecord", "RunStore", "TELEMETRY_SCHEMA", "telemetry_dir",
    "PhaseTimer", "default_store", "disable", "enable", "enabled",
    "kernel_timer", "observe_plan", "phase_scope", "reset", "timer_for_plan",
    "Residual", "TOTAL_PHASES", "join", "mean_abs_log_ratio",
    "split_comm_comp",
    "KernelRefitResult", "RefitResult", "refit", "refit_kernels",
    "DEFAULT_THRESHOLD", "DEFAULT_WINDOW", "DriftLatch", "DriftStatus",
    "bump_revision", "check", "detect_and_invalidate", "reset_latch",
    "Diagnosis", "DiagnosisResponder", "default_probe_distances",
    "emit_degraded_profile",
    "localize_link", "localize_rank", "probe_links",
    "probe_shift_durations",
    "accuracy_report", "format_report", "save_report",
]
