"""Fault tolerance: straggler detection and a model-guided restartable loop.

Straggler detection reuses the paper's central statistic: the ratio of the
slowest observation to the typical one.  On Hopper the paper measured
C_max/C_avg offline per communication pattern; here we estimate it *online*
from step wall-times — ``ratio = latest / median(window)`` — and treat a
sustained blow-up as a sick node / congested link signal.  (The latest
observation, not ``max(window)``: one historical spike must not keep the
statistic pinned high for a whole window after the machine recovers.)

``RestartableLoop`` wraps a step function with crash recovery: on an
injected/real fault it restores the latest checkpoint and replays.  With a
:class:`RecoveryPlanner` attached, straggler events are answered by the
*model* rather than a fixed rule: the planner compares the predicted cost
of finishing the remaining steps on the degraded machine against paying
the restart overhead to finish on a healthy one, and decides
``continue`` / ``checkpoint_now`` / ``reschedule`` — the training analog
of the tuner re-planning under a degraded profile.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np


@dataclasses.dataclass
class StragglerConfig:
    window: int = 20
    ratio_threshold: float = 2.5      # latest/median over the window
    sustained: int = 3                # consecutive anomalous steps
    min_steps: int = 10


class StragglerMonitor:
    """Online C_max/C_avg-style step-time statistic (paper §IV adapted)."""

    def __init__(self, cfg: Optional[StragglerConfig] = None):
        self.cfg = cfg if cfg is not None else StragglerConfig()
        self.times = collections.deque(maxlen=self.cfg.window)
        self._anomalous = 0
        self.events: list[dict] = []

    def record(self, seconds: float) -> Optional[dict]:
        self.times.append(seconds)
        if len(self.times) < max(self.cfg.min_steps, 4):
            return None
        arr = np.asarray(self.times)
        # the *latest* step against the window's typical step: a single
        # past spike ages out of the statistic the moment times recover,
        # instead of dominating max(window) until it leaves the deque
        ratio = float(arr[-1]) / max(float(np.median(arr)), 1e-9)
        if ratio > self.cfg.ratio_threshold:
            self._anomalous += 1
        else:
            self._anomalous = 0
        if self._anomalous >= self.cfg.sustained:
            event = {"type": "straggler", "ratio": ratio,
                     "median_s": float(np.median(arr)),
                     "latest_s": float(arr[-1]),
                     "max_s": float(arr.max())}
            self.events.append(event)
            self._anomalous = 0
            return event
        return None

    @property
    def online_cmax_over_cavg(self) -> float:
        if not self.times:
            return 1.0
        arr = np.asarray(self.times)
        return float(arr.max() / max(np.median(arr), 1e-9))


class FaultInjector:
    """Deterministic fault injection for tests/examples."""

    def __init__(self, fail_at_steps=(), exc=RuntimeError):
        self.fail_at = set(fail_at_steps)
        self.exc = exc
        self.fired = set()

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise self.exc(f"injected fault at step {step}")


@dataclasses.dataclass
class RestartPolicy:
    max_restarts: int = 3
    backoff_s: float = 0.0


class RescheduleRequested(RuntimeError):
    """The recovery planner decided migrating beats continuing degraded.

    Raised by :class:`RestartableLoop` *after* checkpointing, so the
    cluster scheduler can kill and relaunch the job with zero lost work;
    carries the decision that justified it."""

    def __init__(self, decision: "RecoveryDecision"):
        super().__init__(
            f"reschedule requested at step {decision.step}: degraded "
            f"continue {decision.continue_s:.3g}s vs reschedule "
            f"{decision.reschedule_s:.3g}s")
        self.decision = decision


@dataclasses.dataclass
class RecoveryDecision:
    """One planner verdict on a straggler event."""

    action: str                  # "continue" | "checkpoint_now" | "reschedule"
    step: int
    observed_ratio: float        # degraded-step time over healthy
    continue_s: float            # predicted cost of finishing degraded
    reschedule_s: float          # checkpoint + restart + finish healthy
    remaining_steps: int

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class RecoveryPlanner:
    """Model-guided recovery: continue degraded, checkpoint, or migrate?

    The same comparison the tuner makes between candidate grids, applied
    to the job itself.  Continuing costs
    ``remaining * healthy_step_s * max(ratio, 1)`` — the remaining work
    at the degraded rate the monitor observed.  Rescheduling costs
    ``checkpoint_s + restart_overhead_s + remaining * healthy_step_s`` —
    pay the migration once, then run at the healthy rate.  When
    rescheduling wins by ``margin`` (predictions are noisy; don't migrate
    on a coin flip) the verdict is ``reschedule``; a degradation too mild
    to justify migrating but above ``degraded_threshold`` earns a
    ``checkpoint_now`` (bound the work at risk while the machine is
    sick); otherwise ``continue``.
    """

    def __init__(self, healthy_step_s: float, *, restart_overhead_s: float,
                 checkpoint_s: float = 0.0, margin: float = 1.25,
                 degraded_threshold: float = 1.5):
        if healthy_step_s <= 0:
            raise ValueError("healthy_step_s must be > 0")
        if margin < 1.0:
            raise ValueError("margin must be >= 1")
        self.healthy_step_s = float(healthy_step_s)
        self.restart_overhead_s = float(restart_overhead_s)
        self.checkpoint_s = float(checkpoint_s)
        self.margin = float(margin)
        self.degraded_threshold = float(degraded_threshold)

    def decide(self, observed_ratio: float, remaining_steps: int, *,
               step: int = -1) -> RecoveryDecision:
        ratio = max(float(observed_ratio), 1.0)
        remaining = max(int(remaining_steps), 0)
        cont = remaining * self.healthy_step_s * ratio
        resch = (self.checkpoint_s + self.restart_overhead_s
                 + remaining * self.healthy_step_s)
        if resch * self.margin < cont:
            action = "reschedule"
        elif ratio > self.degraded_threshold:
            action = "checkpoint_now"
        else:
            action = "continue"
        return RecoveryDecision(action=action, step=step,
                                observed_ratio=ratio, continue_s=cont,
                                reschedule_s=resch,
                                remaining_steps=remaining)


class RestartableLoop:
    """run(step_fn, save_fn, restore_fn, n_steps): executes step_fn(step)
    for steps [start, n); on exception restores and continues from the
    last checkpointed step.  Returns a report dict.

    With ``planner`` set, a straggler event is routed through
    :meth:`RecoveryPlanner.decide`: ``continue`` does nothing,
    ``checkpoint_now`` bounds the at-risk work, and ``reschedule``
    checkpoints then raises :class:`RescheduleRequested` for the cluster
    scheduler.  Without a planner, every straggler event checkpoints
    (the legacy conservative rule)."""

    def __init__(self, policy: Optional[RestartPolicy] = None,
                 monitor: Optional[StragglerMonitor] = None,
                 checkpoint_every: int = 50,
                 planner: Optional[RecoveryPlanner] = None):
        self.policy = policy if policy is not None else RestartPolicy()
        self.monitor = monitor if monitor is not None else StragglerMonitor()
        self.checkpoint_every = checkpoint_every
        self.planner = planner

    def run(self, *, n_steps: int, step_fn: Callable[[int], dict],
            save_fn: Callable[[int], None],
            restore_fn: Callable[[], int]) -> dict:
        restarts = 0
        step = restore_fn()
        history: List[dict] = []
        decisions: List[RecoveryDecision] = []
        while step < n_steps:
            try:
                t0 = time.perf_counter()
                metrics = step_fn(step)
                dt = time.perf_counter() - t0
                event = self.monitor.record(dt)
                history.append({"step": step, "dt": dt, **(metrics or {})})
                step += 1
                if event is not None:
                    if self.planner is None:
                        save_fn(step)      # checkpoint-now on anomaly
                        # (post-increment: the state is *after* step-1)
                    else:
                        d = self.planner.decide(event["ratio"],
                                                n_steps - step,
                                                step=step)
                        decisions.append(d)
                        if d.action in ("checkpoint_now", "reschedule"):
                            save_fn(step)
                        if d.action == "reschedule":
                            raise RescheduleRequested(d)
                elif step % self.checkpoint_every == 0:
                    save_fn(step)
            except RescheduleRequested:
                raise                      # planner verdict, not a fault
            except Exception:  # noqa: BLE001 — restart path
                restarts += 1
                if restarts > self.policy.max_restarts:
                    raise
                time.sleep(self.policy.backoff_s)
                step = restore_fn()
                # the replayed steps are the checkpoint's future, not this
                # run's past: drop history at/after the resume point so a
                # step never appears twice
                history = [h for h in history if h["step"] < step]
        save_fn(step)
        return {"steps": step, "restarts": restarts,
                "straggler_events": self.monitor.events,
                "recovery_decisions": [d.to_dict() for d in decisions],
                "history": history}
