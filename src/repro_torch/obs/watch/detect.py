"""Streaming change-point and outlier detection over observation streams.

The telemetry drift check is a *batch* statistic: a rolling window of
residual rows whose mean relative error must cross a threshold — with the
default window of 10 that means a degraded link keeps mispredicting for
most of a window before anyone notices.  This module is the *streaming* complement:
three incremental detectors, each O(1) state and O(1)-ish update, run over
every observation as it happens —

* **EWMA** — exponentially weighted mean/variance; fires when a new
  observation sits more than ``ewma_k`` EW standard deviations from the
  EW mean.  Catches level shifts and single gross outliers.
* **CUSUM** — two-sided tabular cumulative sum with reference slack
  ``cusum_k`` and decision threshold ``cusum_h`` (both in units of the
  warm-up standard deviation).  The classic small-persistent-shift
  detector: a mean shift of ``delta`` fires after roughly
  ``h / (delta - k)`` observations — for the residual streams this is a
  handful of observations, well inside the telemetry drift window.
* **Rolling quantile** — a sorted sliding window (``bisect`` insert /
  remove, so the window stays small and the update cheap); fires when an
  observation exceeds ``quantile_factor`` times the window's
  ``quantile`` — scale-free outlier detection for heavy-tailed series
  (step times, queue depths) where a sigma rule misfires.

Detectors warm up on the first ``min_obs`` observations (estimating the
in-control mean/scale) and never fire during warm-up.  After a firing the
detector re-baselines (CUSUM resets its sums; EWMA keeps tracking), so a
genuine regime change fires once, not on every subsequent observation —
the same latch discipline :class:`~repro_torch.telemetry.drift.DriftLatch`
applies to the batch path.

Tier configs: the paper's regime split (Bienz et al. 1806.02030 —
injection-limited vs network-limited residuals behave differently)
motivates per-tier tuning: kernel-launch residuals are tight and
high-rate, op-dispatch residuals are medium, serving-step residuals are
noisy and bursty.  :data:`TIER_CONFIGS` carries one
:class:`DetectorConfig` per tier; :class:`StreamWatcher` resolves the
config from the span/residual tier automatically.
"""

from __future__ import annotations

import dataclasses
import math
from bisect import bisect_left, insort
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

from .. import alert as _obs_alert
from ..summary import tier_of


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """Knobs for one series' detector bank (all three run side by side)."""

    ewma_alpha: float = 0.15     # EW weight of the newest observation
    ewma_k: float = 5.0          # fire at |x - mean| > k * ew_std
    cusum_k: float = 0.5         # reference slack, in warm-up std units
    cusum_h: float = 5.0         # decision threshold, in warm-up std units
    quantile: float = 0.99       # rolling-quantile reference rank
    quantile_factor: float = 3.0  # fire at x > factor * window quantile
    quantile_window: int = 128   # sliding-window length
    min_obs: int = 8             # warm-up observations before arming
    min_std: float = 1e-12       # scale floor (constant warm-up series)
    adapt_alpha: float = 0.02    # CUSUM in-control baseline adaptation


#: per-tier detector configs for the rel-err residual streams.  Kernel
#: launches are many and tight (small alpha, long memory); op dispatches
#: are the paper's own validation tier (defaults); serving steps are
#: bursty (looser sigma, heavier quantile guard).
TIER_CONFIGS: Dict[str, DetectorConfig] = {
    "kernel": DetectorConfig(ewma_alpha=0.08, ewma_k=6.0, cusum_k=0.5,
                             cusum_h=6.0, quantile_window=256),
    "op": DetectorConfig(),
    "serve": DetectorConfig(ewma_alpha=0.2, ewma_k=6.0, cusum_k=1.0,
                            cusum_h=8.0, quantile=0.995,
                            quantile_factor=4.0),
}


@dataclasses.dataclass
class Firing:
    """One detector trigger: which detector, on which series, and the
    statistic/threshold pair that crossed."""

    series: str
    detector: str               # "ewma" | "cusum" | "quantile"
    value: float                # the observation that fired
    stat: float                 # detector statistic at fire time
    threshold: float            # what it crossed
    n_obs: int                  # observations seen on this series so far
    tier: Optional[str] = None
    meta: Dict[str, object] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class EWMADetector:
    """EW mean/variance sigma-rule detector (O(1) state)."""

    name = "ewma"

    def __init__(self, cfg: DetectorConfig):
        self.alpha = cfg.ewma_alpha
        self.k = cfg.ewma_k
        self.min_obs = cfg.min_obs
        self.min_std = cfg.min_std
        self.mean = 0.0
        self.var = 0.0
        self.n = 0

    def update(self, x: float) -> Optional[tuple]:
        """Feed one observation; returns (stat, threshold) on fire."""
        n = self.n = self.n + 1
        mean, var = self.mean, self.var
        fired = None
        if n <= self.min_obs:
            # warm-up: plain running moments (Welford)
            d = x - mean
            mean += d / n
            var += d * (x - mean)
            if n == self.min_obs:
                var = max(var / max(n - 1, 1), self.min_std ** 2)
        else:
            std = math.sqrt(var) if var > 0 else self.min_std
            dev = abs(x - mean)
            if dev > self.k * std:
                fired = (dev / std, self.k)
            a = self.alpha
            d = x - mean
            mean += a * d
            # EW variance of the residual around the EW mean
            var = (1 - a) * (var + a * d * d)
            if var < self.min_std ** 2:
                var = self.min_std ** 2
        self.mean, self.var = mean, var
        return fired


class CUSUMDetector:
    """Two-sided tabular CUSUM in warm-up-standardized units."""

    name = "cusum"

    def __init__(self, cfg: DetectorConfig):
        self.k = cfg.cusum_k
        self.h = cfg.cusum_h
        self.min_obs = cfg.min_obs
        self.min_std = cfg.min_std
        self.adapt_alpha = cfg.adapt_alpha
        self.target = 0.0
        self.scale = 1.0
        self.s_pos = 0.0
        self.s_neg = 0.0
        self.n = 0
        self._m = 0.0
        self._v = 0.0

    def update(self, x: float) -> Optional[tuple]:
        n = self.n = self.n + 1
        if n <= self.min_obs:
            d = x - self._m
            self._m += d / n
            self._v += d * (x - self._m)
            if n == self.min_obs:
                self.target = self._m
                self.scale = max(math.sqrt(self._v / max(n - 1, 1)),
                                 self.min_std)
            return None
        z = (x - self.target) / self.scale
        if abs(z) < 3.0:
            # in-control: slowly re-estimate the baseline.  The warm-up
            # scale comes from only ``min_obs`` samples — frozen, an
            # underestimate inflates every future z and the false-fire
            # rate explodes (~2% observed on clean Gaussian streams).
            # Shifted observations (|z| >= 3) never feed the baseline,
            # so a genuine regime change still accumulates.
            a = self.adapt_alpha
            self.target += a * (x - self.target)
            # sqrt(pi/2) converts EW mean absolute deviation to sigma
            self.scale = max(self.scale + a * (abs(x - self.target)
                                               * 1.2533 - self.scale),
                             self.min_std)
        self.s_pos = max(0.0, self.s_pos + z - self.k)
        self.s_neg = max(0.0, self.s_neg - z - self.k)
        stat = max(self.s_pos, self.s_neg)
        if stat > self.h:
            # re-baseline: a persistent shift fires once, and the next
            # regime is judged from a clean slate
            self.s_pos = self.s_neg = 0.0
            return (stat, self.h)
        return None


class RollingQuantileDetector:
    """Sliding-window quantile outlier guard (sorted window, bisect)."""

    name = "quantile"

    def __init__(self, cfg: DetectorConfig):
        self.q = cfg.quantile
        self.factor = cfg.quantile_factor
        self.window = cfg.quantile_window
        self.min_obs = min(cfg.min_obs, cfg.quantile_window)
        self._fifo: deque = deque()
        self._sorted: List[float] = []

    def update(self, x: float) -> Optional[tuple]:
        s = self._sorted
        fired = None
        if len(s) >= self.min_obs:
            k = min(len(s) - 1, max(0, int(round(self.q * (len(s) - 1)))))
            ref = s[k]
            thr = self.factor * ref
            # the reference must be a real positive scale: a window of
            # zeros (e.g. residuals of a perfectly-predicted phase) makes
            # any nonzero observation "infinite" — treat that as no scale
            if ref > 0 and x > thr:
                fired = (x / ref, self.factor)
        self._fifo.append(x)
        insort(s, x)
        if len(self._fifo) > self.window:
            old = self._fifo.popleft()
            del s[bisect_left(s, old)]
        return fired


class SeriesWatch:
    """The three detectors side by side over one named series."""

    def __init__(self, series: str, cfg: DetectorConfig,
                 tier: Optional[str] = None):
        self.series = series
        self.cfg = cfg
        self.tier = tier
        self.n_obs = 0
        self.detectors = (EWMADetector(cfg), CUSUMDetector(cfg),
                          RollingQuantileDetector(cfg))

    def observe(self, value: float) -> List[Firing]:
        """Feed one observation through every detector; the incremental
        hot path (bench-gated >= 100k obs/s)."""
        self.n_obs += 1
        out: List[Firing] = []
        for det in self.detectors:
            hit = det.update(value)
            if hit is not None:
                out.append(Firing(self.series, det.name, float(value),
                                  float(hit[0]), float(hit[1]),
                                  self.n_obs, tier=self.tier))
        return out


class StreamWatcher:
    """Incremental anomaly watch over named observation streams.

    One :class:`SeriesWatch` per series key, created lazily with the
    config for its tier.  Feed it three ways:

    * :meth:`observe` — any named scalar stream;
    * :meth:`observe_span` — a closed :class:`~repro_torch.obs.spans.Span`
      whose ``rel_err`` pairs prediction with measurement (series key
      ``rel_err/<tier>/<op>``);
    * :meth:`observe_residual` — a telemetry
      :class:`~repro_torch.telemetry.residuals.Residual` row (series key
      ``rel_err/op/<op>``), the closed-loop entry point;
    * :meth:`poll_gauges` — sample every gauge of a
      :class:`~repro_torch.obs.metrics.MetricsRegistry` as one observation
      each (queue depths, KV utilization...).

    Firings are returned, kept in :attr:`firings` (bounded), emitted as
    structured ``obs.alert("watch", ...)`` instants (feeding the existing
    ``obs_alerts_total`` counter), and passed to ``on_fire`` — wire
    :class:`RevisionResponder` there to close the loop into the tuner.
    """

    def __init__(self, configs: Optional[Dict[str, DetectorConfig]] = None,
                 default: Optional[DetectorConfig] = None,
                 on_fire: Optional[Callable[[Firing], object]] = None,
                 emit_alerts: bool = True, max_firings: int = 1024):
        self.configs = dict(TIER_CONFIGS if configs is None else configs)
        self.default = default or DetectorConfig()
        self.on_fire = on_fire
        self.emit_alerts = emit_alerts
        self.firings: deque = deque(maxlen=max_firings)
        self._series: Dict[str, SeriesWatch] = {}

    def config_for(self, tier: Optional[str]) -> DetectorConfig:
        return self.configs.get(tier, self.default)

    def series(self, name: str, tier: Optional[str] = None) -> SeriesWatch:
        sw = self._series.get(name)
        if sw is None:
            sw = self._series[name] = SeriesWatch(
                name, self.config_for(tier), tier=tier)
        return sw

    # -- feeds ---------------------------------------------------------------
    def observe(self, series: str, value: float,
                tier: Optional[str] = None, **meta) -> List[Firing]:
        fires = self.series(series, tier).observe(float(value))
        for f in fires:
            if meta:
                f.meta.update(meta)
            self._fired(f)
        return fires

    def observe_span(self, span) -> List[Firing]:
        """Residual watch on one closed span (no-op for unpaired spans)."""
        err = span.rel_err
        if err is None:
            return []
        tier = tier_of(span.cat) or "op"
        op = span.args.get("op", span.name)
        return self.observe(f"rel_err/{tier}/{op}", err, tier=tier,
                            span=span.name)

    def observe_residual(self, row) -> List[Firing]:
        """Residual watch on one telemetry join row — the stream the
        telemetry drift window consumes in batch."""
        return self.observe(f"rel_err/op/{row.op}", row.rel_err, tier="op",
                            op=row.op, phase=row.phase,
                            machine=row.machine)

    def poll_gauges(self, registry, prefix: str = "") -> List[Firing]:
        """Sample every (matching) gauge's current value as one
        observation — call once per scheduler step / scrape tick."""
        from ..metrics import Gauge
        out: List[Firing] = []
        for m in registry.metrics():
            if not isinstance(m, Gauge) or not m.name.startswith(prefix):
                continue
            key = "gauge/" + m.name
            if m.labels:
                key += "{" + ",".join(f"{k}={v}" for k, v in m.labels) + "}"
            tier = "serve" if m.name.startswith("serve") else None
            out.extend(self.observe(key, m.value, tier=tier))
        return out

    # -- accounting ----------------------------------------------------------
    def _fired(self, f: Firing) -> None:
        self.firings.append(f)
        if self.emit_alerts:
            _obs_alert("watch", series=f.series, detector=f.detector,
                       value=f.value, stat=f.stat, threshold=f.threshold,
                       n_obs=f.n_obs, tier=f.tier)
        if self.on_fire is not None:
            self.on_fire(f)

    @property
    def n_series(self) -> int:
        return len(self._series)

    def summary(self) -> dict:
        """JSON-ready roll-up (feeds the observatory dashboard)."""
        return {
            "n_series": len(self._series),
            "n_obs": sum(s.n_obs for s in self._series.values()),
            "n_firings": len(self.firings),
            "firings": [f.to_dict() for f in self.firings],
        }


class RevisionResponder:
    """Close the loop: a watch firing retires the machine profile through
    the *same* revision-bump/re-key path the batch drift detector uses —
    ``telemetry.bump_revision`` changes ``Machine.fingerprint()`` and
    with it every tuner plan-cache key and telemetry store file.

    One bump per revision: after firing, further firings are swallowed
    until something else moves the revision (mirroring
    :class:`~repro_torch.telemetry.drift.DriftLatch` — without this, a burst of
    detector firings would bump the revision once per firing).
    """

    def __init__(self, registry, machine_name: str,
                 series_filter: Optional[Callable[[Firing], bool]] = None):
        self.registry = registry
        self.machine_name = machine_name
        self.series_filter = series_filter
        self.bumps: List[dict] = []
        self._fired_at_revision: Optional[int] = None

    def __call__(self, firing: Firing):
        if self.series_filter is not None and not self.series_filter(firing):
            return None
        from ...telemetry.drift import bump_revision
        current = self.registry.machine(self.machine_name).machine.revision
        if self._fired_at_revision is not None \
                and current == self._fired_at_revision:
            return None                      # already responded; latched
        machine = bump_revision(self.registry, self.machine_name)
        self._fired_at_revision = machine.revision
        self.bumps.append({"series": firing.series,
                           "detector": firing.detector,
                           "revision": machine.revision})
        return machine
