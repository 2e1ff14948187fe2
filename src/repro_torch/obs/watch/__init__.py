"""repro_torch.obs.watch — streaming anomaly detection, SLO burn-rate
alerting, bench-history regression sentinel, and the observatory
dashboard.

Four pieces, one loop:

* :mod:`~repro_torch.obs.watch.detect` — incremental EWMA / CUSUM /
  rolling-quantile detectors over any observation stream (span residuals,
  telemetry rows, registry gauges), with per-tier configs and a
  :class:`RevisionResponder` that closes firings into the tuner's
  revision-bump/re-key path.
* :mod:`~repro_torch.obs.watch.slo` — multi-window burn-rate rules over the
  serving TTFT/TPOT/goodput outcome streams, emitting structured
  ``obs.alert("slo_burn", ...)`` instants.
* :mod:`~repro_torch.obs.watch.history` — append-only bench-history JSONL
  keyed by commit + machine fingerprint, and the statistical regression
  sentinel behind ``python -m benchmarks.run --check-regressions``.
* :mod:`~repro_torch.obs.watch.dashboard` — the self-contained HTML
  observatory rendered from all of the above.
"""

from .detect import (DetectorConfig, TIER_CONFIGS, Firing, EWMADetector,
                     CUSUMDetector, RollingQuantileDetector, SeriesWatch,
                     StreamWatcher, RevisionResponder)
from .slo import (BurnRateRule, SERVING_RULES, SLOAlert, SLOWatcher,
                  watch_replay)
from .history import (HISTORY_SCHEMA, BenchRun, BenchHistory,
                      flatten_metrics, metric_direction, check_regressions,
                      format_report, history_dir)
from .dashboard import (collect_data, render_dashboard, save_dashboard,
                        history_series)

__all__ = [
    "DetectorConfig", "TIER_CONFIGS", "Firing", "EWMADetector",
    "CUSUMDetector", "RollingQuantileDetector", "SeriesWatch",
    "StreamWatcher", "RevisionResponder",
    "BurnRateRule", "SERVING_RULES", "SLOAlert", "SLOWatcher",
    "watch_replay",
    "HISTORY_SCHEMA", "BenchRun", "BenchHistory", "flatten_metrics",
    "metric_direction", "check_regressions", "format_report",
    "history_dir",
    "collect_data", "render_dashboard", "save_dashboard",
    "history_series",
]
