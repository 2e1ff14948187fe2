"""Multi-window SLO burn-rate alerting over the serving stream.

An SLO is an objective over a rolling fraction of good events ("99% of
requests get their first token within the TTFT SLO").  The *burn rate*
over a window is how fast the error budget is being consumed:

    burn = (bad / total within the window) / (1 - objective)

burn == 1 means "exactly on budget"; burn == 14.4 over an hour means the
whole 30-day budget would be gone in ~2 days.  A single window either
pages too slowly (long window) or flaps on noise (short window); the
standard multi-window rule fires only when **both** a fast and a slow
window exceed their thresholds — the slow window confirms the problem is
real, the fast window confirms it is *still happening* (the alert
self-clears once the fast window drains).

The serving scheduler streams per-request outcomes here (one
``record(...)`` per evicted request, on the scheduler's own clock — the
simulated clock during trace replay, so replays exercise the exact alert
path production would).  ``check()`` evaluates every rule, emits
structured ``obs.alert("slo_burn", ...)`` instants into the existing
alert stream/counter, keeps a sampled burn-rate timeline for the
observatory dashboard, and re-arms only after the rule stops firing
(hysteresis — one alert per violation episode, not one per request).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

from .. import alert as _obs_alert


@dataclasses.dataclass(frozen=True)
class BurnRateRule:
    """One multi-window burn-rate rule over a named good/bad stream."""

    name: str                    # "ttft", "tpot", "goodput"...
    objective: float = 0.99      # target good fraction (budget = 1 - obj)
    fast_window_s: float = 60.0
    slow_window_s: float = 600.0
    fast_burn: float = 14.4      # page-grade defaults (SRE workbook)
    slow_burn: float = 6.0
    min_events: int = 10         # slow-window events before the rule arms

    @property
    def budget(self) -> float:
        return max(1.0 - self.objective, 1e-9)


#: serving defaults: TTFT and TPOT latency objectives plus a combined
#: goodput objective (the SLO-met flag the scheduler already computes).
SERVING_RULES: Tuple[BurnRateRule, ...] = (
    BurnRateRule("ttft", objective=0.95),
    BurnRateRule("tpot", objective=0.95),
    # wide budget -> page-grade burns would need a bad-ratio > 1 (a burn
    # of 14.4 on a 10% budget is unreachable); scale the thresholds so
    # the rule can actually fire while keeping the fast/slow shape.
    BurnRateRule("goodput", objective=0.90, fast_burn=6.0, slow_burn=3.0),
)


@dataclasses.dataclass
class SLOAlert:
    rule: str
    clock: float
    fast_burn: float
    slow_burn: float
    fast_threshold: float
    slow_threshold: float
    n_fast: int
    n_slow: int

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class _WindowedRatio:
    """Bad/total counts over a sliding time window of (t, good) events."""

    __slots__ = ("window_s", "events", "bad")

    def __init__(self, window_s: float):
        self.window_s = window_s
        self.events: Deque[Tuple[float, bool]] = deque()
        self.bad = 0

    def add(self, t: float, good: bool) -> None:
        self.events.append((t, good))
        if not good:
            self.bad += 1
        self.trim(t)

    def trim(self, now: float) -> None:
        cut = now - self.window_s
        ev = self.events
        while ev and ev[0][0] < cut:
            _, good = ev.popleft()
            if not good:
                self.bad -= 1

    def ratio(self) -> float:
        n = len(self.events)
        return self.bad / n if n else 0.0


class SLOWatcher:
    """Streams (clock, rule, good) outcomes into multi-window burn rates.

    ``record`` is O(1) amortized per event per rule; ``check`` is O(rules)
    and safe to call every scheduler step.  ``timeline`` keeps a bounded
    sample of (clock, rule, fast, slow, firing) points — the observatory
    dashboard's burn-rate chart reads it directly.
    """

    def __init__(self, rules: Sequence[BurnRateRule] = SERVING_RULES,
                 on_fire: Optional[Callable[[SLOAlert], object]] = None,
                 emit_alerts: bool = True, max_timeline: int = 4096,
                 sample_every_s: float = 0.0):
        self.rules = {r.name: r for r in rules}
        self.on_fire = on_fire
        self.emit_alerts = emit_alerts
        self.alerts: List[SLOAlert] = []
        self.timeline: Deque[dict] = deque(maxlen=max_timeline)
        self.sample_every_s = sample_every_s
        self._last_sample: Dict[str, float] = {}
        self._firing: Dict[str, bool] = {}
        self._win: Dict[str, Tuple[_WindowedRatio, _WindowedRatio]] = {
            name: (_WindowedRatio(r.fast_window_s),
                   _WindowedRatio(r.slow_window_s))
            for name, r in self.rules.items()}

    # -- ingestion -----------------------------------------------------------
    def record(self, clock: float, rule: str, good: bool) -> None:
        """One request outcome against one rule (unknown rules ignored so
        callers can stream superset outcomes)."""
        win = self._win.get(rule)
        if win is None:
            return
        win[0].add(clock, good)
        win[1].add(clock, good)

    def record_outcomes(self, clock: float, **outcomes: bool) -> None:
        """``record_outcomes(t, ttft=True, tpot=False, goodput=False)``"""
        for rule, good in outcomes.items():
            self.record(clock, rule, good)

    # -- evaluation ----------------------------------------------------------
    def burn_rates(self, clock: float, rule: str) -> Tuple[float, float,
                                                           int, int]:
        r = self.rules[rule]
        fast, slow = self._win[rule]
        fast.trim(clock)
        slow.trim(clock)
        return (fast.ratio() / r.budget, slow.ratio() / r.budget,
                len(fast.events), len(slow.events))

    def check(self, clock: float) -> List[SLOAlert]:
        """Evaluate every rule at ``clock``; returns (and emits) new
        alerts.  A rule that keeps burning stays in the "firing" state
        and does not re-alert until it first clears (hysteresis)."""
        out: List[SLOAlert] = []
        for name, r in self.rules.items():
            fb, sb, n_fast, n_slow = self.burn_rates(clock, name)
            firing = (n_slow >= r.min_events
                      and fb >= r.fast_burn and sb >= r.slow_burn)
            self._sample(clock, name, fb, sb, firing)
            was = self._firing.get(name, False)
            self._firing[name] = firing
            if not firing or was:
                continue
            al = SLOAlert(name, clock, fb, sb, r.fast_burn, r.slow_burn,
                          n_fast, n_slow)
            self.alerts.append(al)
            out.append(al)
            if self.emit_alerts:
                _obs_alert("slo_burn", rule=name, clock=clock,
                           fast_burn=fb, slow_burn=sb,
                           fast_threshold=r.fast_burn,
                           slow_threshold=r.slow_burn)
            if self.on_fire is not None:
                self.on_fire(al)
        return out

    def _sample(self, clock: float, rule: str, fast: float, slow: float,
                firing: bool) -> None:
        last = self._last_sample.get(rule)
        if last is not None and clock - last < self.sample_every_s \
                and not firing:
            return
        self._last_sample[rule] = clock
        self.timeline.append({"t": round(float(clock), 6), "rule": rule,
                              "fast": round(float(fast), 4),
                              "slow": round(float(slow), 4),
                              "firing": firing})

    def firing(self) -> List[str]:
        """Rules currently in the firing state (as of the last ``check``).
        ``check`` only *returns* an alert on the clear->firing edge; a
        degradation controller needs the level, not the edge."""
        return [name for name, f in self._firing.items() if f]

    # -- output --------------------------------------------------------------
    def summary(self) -> dict:
        """JSON-ready state (dashboard + CI consumption)."""
        rules = {}
        for name, r in self.rules.items():
            fast, slow = self._win[name]
            rules[name] = {
                "objective": r.objective,
                "fast_window_s": r.fast_window_s,
                "slow_window_s": r.slow_window_s,
                "fast_burn_threshold": r.fast_burn,
                "slow_burn_threshold": r.slow_burn,
                "firing": self._firing.get(name, False),
                "n_alerts": sum(1 for a in self.alerts if a.rule == name),
            }
        return {"rules": rules,
                "n_alerts": len(self.alerts),
                "alerts": [a.to_dict() for a in self.alerts[-64:]],
                "timeline": list(self.timeline)}


def watch_replay(reports, scheduler, watcher: Optional[SLOWatcher] = None,
                 ) -> SLOWatcher:
    """Post-hoc burn-rate pass over finished scheduler state — for runs
    that did not attach a watcher live.  Uses each request's recorded
    finish clock and the scheduler's SLO thresholds."""
    w = watcher or SLOWatcher()
    outcomes = []
    for rs in scheduler.finished.values():
        m = rs.metrics()
        ttft_ok = (scheduler.ttft_slo_s is None or
                   (m["ttft_s"] is not None
                    and m["ttft_s"] <= scheduler.ttft_slo_s))
        tpot_ok = (scheduler.tpot_slo_s is None or m["n_out"] <= 1
                   or m["tpot_s"] <= scheduler.tpot_slo_s)
        outcomes.append((rs.finish_s, ttft_ok, tpot_ok))
    outcomes.sort(key=lambda x: x[0])
    for t, ttft_ok, tpot_ok in outcomes:
        w.record_outcomes(t, ttft=ttft_ok, tpot=tpot_ok,
                          goodput=ttft_ok and tpot_ok)
        w.check(t)
    return w
