"""`repro_torch.obs` — unified span tracing + metrics, predicted vs measured.

One switch (:func:`enable` / env ``REPRO_OBS=1``), one process-global
:class:`~repro_torch.obs.spans.Tracer` and :class:`MetricsRegistry`, and one
hot-path guard — :func:`enabled` is a single global read and
:func:`maybe_span` returns a shared no-op context manager when tracing
is off, so the instrumented layers (telemetry PhaseTimer, tuner
dispatch, kernel timers, the serving scheduler) pay nothing measurable
when nobody is watching.  When tracing is on, every timed region that
knows its model-predicted duration carries it on the span, and
:mod:`repro_torch.obs.export` renders measured and predicted timelines
side-by-side with flow links and signed residuals.
"""

from __future__ import annotations

import os
import threading
from contextlib import nullcontext
from typing import Optional

from .spans import DEFAULT_CAPACITY, Span, Tracer
from .metrics import (Counter, Gauge, Histogram, LATENCY_BUCKETS,
                      MetricsRegistry, REL_ERR_BUCKETS,
                      parse_prometheus_text)
from .export import (TraceBuilder, export_spans, save_trace, serving_trace,
                     sim_trace)
from .summary import save_summary, summary, tier_of

__all__ = [
    "Span", "Tracer", "TraceBuilder", "MetricsRegistry",
    "Counter", "Gauge", "Histogram",
    "LATENCY_BUCKETS", "REL_ERR_BUCKETS", "DEFAULT_CAPACITY",
    "enabled", "enable", "disable", "reset", "tracer", "default_registry",
    "maybe_span", "alert",
    "export_spans", "sim_trace", "serving_trace", "save_trace",
    "summary", "save_summary", "tier_of", "parse_prometheus_text",
    "watch",
]

def __getattr__(name):
    # `watch` is loaded lazily: its modules use ``from .. import alert``,
    # which needs this module fully initialized first.
    if name == "watch":
        import importlib
        return importlib.import_module(".watch", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


_LOCK = threading.Lock()
_ENABLED: Optional[bool] = None     # None -> consult the environment
_TRACER: Optional[Tracer] = None
_REGISTRY: Optional[MetricsRegistry] = None

#: shared no-op context manager — ``nullcontext`` is reentrant and
#: reusable, so one instance serves every disabled ``maybe_span`` call
#: without an allocation.
_NULL = nullcontext()


def enabled() -> bool:
    """Is span/metric recording on?  Lock-free single global read on
    the hot path (CPython global loads are atomic); only the first call
    ever consults the environment."""
    e = _ENABLED
    if e is None:
        e = os.environ.get("REPRO_OBS", "") not in ("", "0", "false")
        _set_enabled(e)
    return e


def _set_enabled(v: Optional[bool]) -> None:
    global _ENABLED
    with _LOCK:
        _ENABLED = v


def enable(capacity: Optional[int] = None) -> Tracer:
    """Turn recording on (optionally resizing the ring) and return the
    process tracer."""
    global _TRACER
    with _LOCK:
        if capacity is not None and (_TRACER is None
                                     or _TRACER.capacity != capacity):
            _TRACER = Tracer(capacity)
    _set_enabled(True)
    return tracer()


def disable() -> None:
    _set_enabled(False)


def reset() -> None:
    """Forget everything: enabled flag back to env-derived, fresh tracer
    and registry on next use.  Tests lean on this."""
    global _TRACER, _REGISTRY
    with _LOCK:
        global _ENABLED
        _ENABLED = None
        _TRACER = None
        _REGISTRY = None


def tracer() -> Tracer:
    """The process-global tracer (created on first use)."""
    global _TRACER
    tr = _TRACER
    if tr is None:
        with _LOCK:
            if _TRACER is None:
                _TRACER = Tracer()
            tr = _TRACER
    return tr


def default_registry() -> MetricsRegistry:
    """The process-global metrics registry (created on first use)."""
    global _REGISTRY
    reg = _REGISTRY
    if reg is None:
        with _LOCK:
            if _REGISTRY is None:
                _REGISTRY = MetricsRegistry()
            reg = _REGISTRY
    return reg


def maybe_span(name: str, cat: str = "",
               predicted_s: Optional[float] = None, **args):
    """``tracer().span(...)`` when recording, a shared no-op context
    manager when not — the one-line instrumentation hook every layer
    uses."""
    if not enabled():
        return _NULL
    return tracer().span(name, cat, predicted_s, **args)


def alert(name: str, **args) -> Optional[Span]:
    """Emit a structured alert: an instant event in the trace stream
    plus an ``obs_alerts_total{kind=...}`` counter.  No-op when
    disabled."""
    if not enabled():
        return None
    default_registry().counter("obs_alerts_total", kind=name).inc()
    return tracer().instant(name, cat="alert", args=args or None)
