"""The instrumentation layer: per-phase wall-clock capture.

A :class:`PhaseTimer` accumulates named phase durations (context-manager
or decorator form) and emits one :class:`~repro_torch.telemetry.store.RunRecord`
tagged with (machine fingerprint, op, variant, n, p, c) — the exact key
the residual join needs to look up the model's prediction for the same
scenario.

Recording is off by default: the dispatch and serving hot paths pay one
``enabled()`` check and nothing else.  Turn it on either with
``REPRO_TELEMETRY=1`` in the environment (records land in the default
:class:`RunStore` under ``artifacts/telemetry_torch/``) or
programmatically with
``enable(store)``; explicit per-call opt-ins (``observe=True`` on the
dispatch entry points and ``Tuner.plan``) record regardless of the global
switch.
"""

from __future__ import annotations

import functools
import os
import threading
import time
from contextlib import contextmanager, nullcontext
from typing import Dict, Optional

from .store import RunRecord, RunStore
from .. import obs

_STATE_LOCK = threading.Lock()
_ENABLED: Optional[bool] = None          # None: fall back to the env var
_STORE: Optional[RunStore] = None

#: one reusable no-op context for every disabled phase_scope call — the
#: disabled hot path must not allocate (bench_telemetry asserts < 1 µs).
_NULL = nullcontext()


def enabled() -> bool:
    """True when measured runs should be recorded globally.  Lock-free:
    a single global read (atomic in CPython) — this sits on the dispatch
    hot path and must cost nanoseconds when recording is off."""
    e = _ENABLED
    if e is not None:
        return e
    return os.environ.get("REPRO_TELEMETRY", "") not in ("", "0", "false")


def enable(store: Optional[RunStore] = None) -> RunStore:
    """Turn recording on (optionally into a specific store); returns the
    store every subsequent emission will append to."""
    global _ENABLED, _STORE
    with _STATE_LOCK:
        _ENABLED = True
        if store is not None:
            _STORE = store
        elif _STORE is None:
            _STORE = RunStore()
        return _STORE


def disable() -> None:
    global _ENABLED
    with _STATE_LOCK:
        _ENABLED = False


def reset() -> None:
    """Back to env-var-controlled recording with the default store (tests)."""
    global _ENABLED, _STORE
    with _STATE_LOCK:
        _ENABLED = None
        _STORE = None
    from .drift import reset_latch
    reset_latch()


def default_store() -> RunStore:
    global _STORE
    with _STATE_LOCK:
        if _STORE is None:
            _STORE = RunStore()
        return _STORE


class PhaseTimer:
    """Accumulates per-phase wall seconds for one logical run.

    >>> pt = PhaseTimer("summa", variant="2d", n=4096, p=16)
    >>> with pt.phase("execute"):
    ...     do_work()
    >>> pt.emit()            # -> RunRecord appended to the active store

    Re-entering a phase accumulates (the serving engine enters ``decode``
    once per generated token).  ``wrap`` is the decorator form.
    """

    def __init__(self, op: str, *, variant: str = "", n: int = 0, p: int = 1,
                 c: int = 1, dtype: str = "float32", machine: str = "",
                 fingerprint: str = "", kind: str = "manual",
                 predicted: Optional[Dict[str, float]] = None,
                 meta: Optional[Dict[str, object]] = None):
        self.op = op
        self.variant = variant
        self.n = int(n)
        self.p = int(p)
        self.c = int(c)
        self.dtype = dtype
        self.machine = machine
        self.fingerprint = fingerprint
        self.kind = kind
        self.predicted = dict(predicted or {})
        self.meta = dict(meta or {})
        self.phases: Dict[str, float] = {}

    #: phase names whose prediction falls back to ``predicted["total"]``
    #: when no same-named entry exists (mirrors residuals.TOTAL_PHASES).
    _TOTALISH = ("execute", "total", "step")

    def _predicted_for(self, name: str) -> Optional[float]:
        p = self.predicted.get(name)
        if p is None and name in self._TOTALISH:
            p = self.predicted.get("total")
        return p

    @contextmanager
    def phase(self, name: str):
        sp = tr = None
        if obs.enabled():
            tr = obs.tracer()
            sp = tr.begin(name, cat=self.kind,
                          args={"op": self.op, "variant": self.variant,
                                "n": self.n, "p": self.p})
        t0 = time.perf_counter()
        err = False
        try:
            yield self
        except BaseException:
            err = True
            raise
        finally:
            dt = time.perf_counter() - t0
            self.phases[name] = self.phases.get(name, 0.0) + dt
            if sp is not None:
                # span duration = exactly what the phase accounting saw,
                # paired with the plan's prediction for the same phase
                sp.predicted_s = self._predicted_for(name)
                tr.end(sp, error=err, dur_s=dt)

    def wrap(self, name: str):
        def deco(fn):
            @functools.wraps(fn)
            def wrapper(*args, **kwargs):
                with self.phase(name):
                    return fn(*args, **kwargs)
            return wrapper
        return deco

    def add(self, name: str, seconds: float) -> None:
        """Account externally-measured seconds to a phase."""
        self.phases[name] = self.phases.get(name, 0.0) + float(seconds)

    def record(self) -> RunRecord:
        return RunRecord(
            fingerprint=self.fingerprint, machine=self.machine, op=self.op,
            variant=self.variant, n=self.n, p=self.p, c=self.c,
            dtype=self.dtype, kind=self.kind, phases=dict(self.phases),
            predicted=dict(self.predicted), meta=dict(self.meta))

    def emit(self, store: Optional[RunStore] = None,
             force: bool = False) -> Optional[RunRecord]:
        """Append the accumulated record.  Returns it, or None when
        recording is off (and not forced) or no phase was timed."""
        if not (force or enabled()) or not self.phases:
            return None
        rec = self.record()
        (store or default_store()).append(rec)
        return rec


def phase_scope(pt: Optional["PhaseTimer"], name: str):
    """``pt.phase(name)`` when a timer is active, else a shared no-op
    context — the guard every instrumented hot path needs, written once,
    allocation-free when recording is off."""
    return pt.phase(name) if pt is not None else _NULL


def timer_for_plan(plan, kind: str = "dispatch",
                   meta: Optional[Dict[str, object]] = None) -> PhaseTimer:
    """A PhaseTimer pre-tagged from an ExecutionPlan — the dispatch layer's
    one-liner.  ``plan.algo`` (not the public op name) keys the record so
    the residual join can look the cost-IR program straight up."""
    return PhaseTimer(plan.algo, variant=plan.variant, n=plan.n, p=plan.p,
                      c=plan.c, dtype=plan.dtype, machine=plan.machine,
                      fingerprint=plan.fingerprint, kind=kind,
                      predicted=dict(plan.predicted), meta=meta)


def kernel_timer(kernel: str, shape, tiles, *, dtype: str = "float32",
                 machine: str = "", fingerprint: str = "",
                 itemsize: Optional[int] = None,
                 mm_tile: Optional[Dict[str, int]] = None,
                 predicted: Optional[Dict[str, float]] = None) -> PhaseTimer:
    """A PhaseTimer for one Pallas kernel run, tagged the way
    ``telemetry.refit_kernels`` consumes it: ``op = "kernel:<family>"``,
    ``meta`` carrying the problem shape, the tile block dict (a
    :class:`~repro_torch.perf.kernel.TilePlan` or plain dict) and the itemsize.
    Time the launch under ``phase("execute")`` (or split h2d/compute/d2h
    when the harness can) and ``emit(force=True)``.
    """
    blocks = tiles.block_dict() if hasattr(tiles, "block_dict") else dict(tiles)
    meta: Dict[str, object] = {
        "kernel": kernel,
        "shape": [int(x) for x in shape],
        "tile": {d: int(v) for d, v in blocks.items()},
        "itemsize": int(itemsize) if itemsize is not None else None,
    }
    if mm_tile:
        meta["mm_tile"] = {d: int(v) for d, v in dict(mm_tile).items()}
    return PhaseTimer(f"kernel:{kernel}", variant="pallas",
                      n=int(max(shape)), dtype=dtype, machine=machine,
                      fingerprint=fingerprint, kind="kernel",
                      predicted=predicted, meta=meta)


def observe_plan(plan, store: Optional[RunStore] = None) -> RunRecord:
    """Record a planning decision itself (``Tuner.plan(..., observe=True)``):
    a zero-phase record carrying the prediction, so the store holds what
    the model *promised* even for scenarios never executed here."""
    rec = RunRecord(
        fingerprint=plan.fingerprint, machine=plan.machine, op=plan.algo,
        variant=plan.variant, n=plan.n, p=plan.p, c=plan.c, dtype=plan.dtype,
        kind="plan", phases={}, predicted=dict(plan.predicted))
    (store or default_store()).append(rec)
    return rec
