"""Hierarchical span tracing: who did what, when, inside what.

A :class:`Span` is one timed region — name, category, (trace, span,
parent) ids, wall start/duration, free-form args — optionally carrying
the model's *predicted* duration for the same region
(``predicted_s``), which is what lets the exporter draw the predicted
twin track and annotate the signed residual.

The :class:`Tracer` keeps a bounded ring buffer of closed spans (a
``deque`` with ``maxlen``: always-on tracing can never grow without
bound — old spans fall off the back and ``dropped`` counts them) and a
per-thread open-span stack that supplies parent/trace ids, so nesting
is free for callers: whichever span is innermost on this thread when a
new one opens becomes its parent.

Closing is exception-safe by construction: the ``span()`` context
manager records the duration and tags ``error=True`` in its
``finally``, so a region exited via ``raise`` still lands in the
buffer with real timing.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Deque, Dict, List, Optional

#: bump when the span field set changes incompatibly.
SPAN_SCHEMA = 1

#: default ring capacity — ~30 MB of spans at worst, hours of serving
#: steps, and a hard memory bound either way.
DEFAULT_CAPACITY = 65536


@dataclasses.dataclass
class Span:
    """One closed (or still-open, while ``dur_s < 0``) traced region."""

    name: str
    cat: str = ""
    trace_id: int = 0
    span_id: int = 0
    parent_id: Optional[int] = None
    start_s: float = 0.0            # time.perf_counter() domain
    dur_s: float = -1.0             # -1 while open
    predicted_s: Optional[float] = None
    error: bool = False
    kind: str = "span"              # "span" | "instant"
    thread: int = 0
    args: Dict[str, object] = dataclasses.field(default_factory=dict)

    @property
    def residual_s(self) -> Optional[float]:
        """Signed measured-minus-predicted seconds (None when unpaired)."""
        if self.predicted_s is None or self.predicted_s <= 0 \
                or self.dur_s < 0:
            return None
        return self.dur_s - self.predicted_s

    @property
    def rel_err(self) -> Optional[float]:
        """|predicted - measured| / measured, the paper's accuracy metric
        (None when unpaired or the measurement is empty)."""
        r = self.residual_s
        if r is None or self.dur_s <= 0:
            return None
        return abs(r) / self.dur_s

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["schema"] = SPAN_SCHEMA
        return d


class Tracer:
    """Ring-buffered span recorder; see module docstring.

    Thread-safe: the buffer append is locked, the open-span stack is
    per-thread.  ``begin``/``end`` are the primitives (used by callers
    that measure time themselves, like ``telemetry.PhaseTimer``);
    ``span()`` is the context-manager form; ``complete``/``instant``
    record externally-timed or zero-duration events directly.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = int(capacity)
        self._buf: Deque[Span] = deque(maxlen=self.capacity)
        self._ids = itertools.count(1)
        self._tls = threading.local()
        self._lock = threading.Lock()
        self.n_closed = 0

    # -- open-span stack ------------------------------------------------------
    def _stack(self) -> List[Span]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def current(self) -> Optional[Span]:
        """The innermost open span on this thread, if any."""
        stack = self._stack()
        return stack[-1] if stack else None

    # -- primitives -----------------------------------------------------------
    def begin(self, name: str, cat: str = "",
              args: Optional[Dict[str, object]] = None,
              predicted_s: Optional[float] = None) -> Span:
        stack = self._stack()
        sid = next(self._ids)
        if stack:
            parent, trace = stack[-1].span_id, stack[-1].trace_id
        else:
            parent, trace = None, sid
        sp = Span(name=name, cat=cat, trace_id=trace, span_id=sid,
                  parent_id=parent, start_s=time.perf_counter(),
                  predicted_s=predicted_s, thread=threading.get_ident(),
                  args=dict(args) if args else {})
        stack.append(sp)
        return sp

    def end(self, span: Span, error: bool = False,
            dur_s: Optional[float] = None) -> Span:
        """Close ``span``: duration from the wall clock (or explicit
        ``dur_s`` for externally-timed regions) and append to the ring.
        Any spans opened under it and left open are closed too (crash
        hygiene: an exception that skipped inner ``end`` calls must not
        corrupt the stack for the next span)."""
        span.dur_s = (time.perf_counter() - span.start_s
                      if dur_s is None else float(dur_s))
        span.error = span.error or error
        stack = self._stack()
        while stack:
            top = stack.pop()
            if top.span_id == span.span_id:
                break
        with self._lock:
            self._buf.append(span)
            self.n_closed += 1
        return span

    @contextmanager
    def span(self, name: str, cat: str = "",
             predicted_s: Optional[float] = None, **args):
        """``with tracer.span("execute", cat="dispatch", n=4096) as sp:``
        — exception-safe: a ``raise`` inside still records the duration
        and tags ``error=True``."""
        sp = self.begin(name, cat, args or None, predicted_s)
        try:
            yield sp
        except BaseException:
            sp.error = True
            raise
        finally:
            self.end(sp)

    def complete(self, name: str, dur_s: float, cat: str = "",
                 args: Optional[Dict[str, object]] = None,
                 predicted_s: Optional[float] = None,
                 start_s: Optional[float] = None) -> Span:
        """Record an already-measured region (it ran just now, for
        ``dur_s`` seconds).  Parent is whatever is open on this thread."""
        now = time.perf_counter()
        sp = self.begin(name, cat, args, predicted_s)
        sp.start_s = now - float(dur_s) if start_s is None else float(start_s)
        return self.end(sp, dur_s=float(dur_s))

    def instant(self, name: str, cat: str = "",
                args: Optional[Dict[str, object]] = None) -> Span:
        """A zero-duration marker event (drift alerts, admissions...)."""
        sp = self.begin(name, cat, args)
        sp.kind = "instant"
        return self.end(sp, dur_s=0.0)

    # -- buffer access --------------------------------------------------------
    @property
    def dropped(self) -> int:
        """Closed spans that have already fallen off the ring."""
        with self._lock:
            return self.n_closed - len(self._buf)

    def spans(self) -> List[Span]:
        """Snapshot of the buffered (closed) spans, oldest first."""
        with self._lock:
            return list(self._buf)

    def drain(self) -> List[Span]:
        """Return the buffered spans and clear the ring (counters kept)."""
        with self._lock:
            out = list(self._buf)
            self._buf.clear()
        return out

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self.n_closed = 0
