"""The metrics registry: counters, gauges, fixed-bucket histograms.

Everything the trace layer can't express as a span lands here: queue
depths, KV-block occupancy, TTFT/TPOT distributions, residual
relative-error histograms.  The registry is label-aware (one metric
object per (name, sorted label set)), snapshot-able to JSON/JSONL, and
renders Prometheus text exposition (`metric{label="v"} value` with the
cumulative ``_bucket``/``_sum``/``_count`` histogram convention) so an
external scraper needs no custom glue.  :func:`parse_prometheus_text`
is the matching reader — the exposition round-trips, and the test
suite pins that.

Histograms use *fixed* bucket bounds chosen at creation (bounded
memory, mergeable across processes).  ``keep_values=True`` additionally
retains raw observations so exact nearest-rank percentiles are
available — the serving replay harness uses this so its reported
TTFT/TPOT percentiles and the obs summary agree by construction.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import threading
import time
from bisect import bisect_left
from typing import Dict, List, Optional, Sequence, Tuple

#: wall-seconds latency buckets (spans, step times).
LATENCY_BUCKETS = (1e-5, 1e-4, 1e-3, 1e-2, 0.1, 0.5, 1.0, 5.0, 30.0)
#: relative-error buckets (predicted-vs-measured residual roll-ups).
REL_ERR_BUCKETS = (0.01, 0.02, 0.05, 0.1, 0.2, 0.5, 1.0, 2.0, 5.0)

LabelSet = Tuple[Tuple[str, str], ...]


def _labels(labels: Dict[str, object]) -> LabelSet:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _escape_label_value(v: str) -> str:
    # Prometheus text exposition: backslash, double-quote and newline
    # must be escaped inside label values (in this order — backslash
    # first, or the other escapes get double-escaped).
    return (v.replace("\\", "\\\\").replace('"', '\\"')
             .replace("\n", "\\n"))


def _unescape_label_value(v: str) -> str:
    out: List[str] = []
    it = iter(v)
    for ch in it:
        if ch != "\\":
            out.append(ch)
            continue
        nxt = next(it, "")
        out.append({"n": "\n", '"': '"', "\\": "\\"}.get(nxt, "\\" + nxt))
    return "".join(out)


def _label_str(labels: LabelSet) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f'{k}="{_escape_label_value(v)}"'
                          for k, v in labels) + "}"


class Counter:
    """Monotone float counter."""

    kind = "counter"

    def __init__(self, name: str, labels: LabelSet = (), help: str = ""):
        self.name, self.labels, self.help = name, labels, help
        self._lock = threading.Lock()
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self.value += v

    def to_dict(self) -> dict:
        return {"name": self.name, "labels": dict(self.labels),
                "kind": self.kind, "value": self.value}


class Gauge:
    """Last-value gauge; also tracks the max ever set (free high-water
    marks for queue depth / occupancy / makespan)."""

    kind = "gauge"

    def __init__(self, name: str, labels: LabelSet = (), help: str = ""):
        self.name, self.labels, self.help = name, labels, help
        self._lock = threading.Lock()
        self.value = 0.0
        self.max_value = -math.inf

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)
            if v > self.max_value:
                self.max_value = float(v)

    def inc(self, v: float = 1.0) -> None:
        with self._lock:
            self.value += v
            if self.value > self.max_value:
                self.max_value = self.value

    def dec(self, v: float = 1.0) -> None:
        self.inc(-v)

    def to_dict(self) -> dict:
        return {"name": self.name, "labels": dict(self.labels),
                "kind": self.kind, "value": self.value,
                "max": self.max_value if self.max_value > -math.inf else None}


class Histogram:
    """Fixed-bucket histogram (Prometheus ``le`` convention: an
    observation lands in the first bucket whose upper bound is >= it;
    values above every bound land in the +Inf overflow bucket)."""

    kind = "histogram"

    def __init__(self, name: str, labels: LabelSet = (),
                 buckets: Sequence[float] = LATENCY_BUCKETS,
                 keep_values: bool = False, help: str = ""):
        self.name, self.labels, self.help = name, labels, help
        self.bounds: Tuple[float, ...] = tuple(sorted(float(b)
                                                      for b in buckets))
        if not self.bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self._lock = threading.Lock()
        self.counts: List[int] = [0] * (len(self.bounds) + 1)  # +Inf last
        self.sum = 0.0
        self.count = 0
        self.min = math.inf
        self.max = -math.inf
        self._values: Optional[List[float]] = [] if keep_values else None

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.counts[bisect_left(self.bounds, v)] += 1
            self.sum += v
            self.count += 1
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v
            if self._values is not None:
                self._values.append(v)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def percentile(self, q: float) -> Optional[float]:
        """Nearest-rank percentile: exact when raw values are kept
        (identical to the serving replay's historical formula), else the
        upper bound of the bucket holding that rank (``max`` for the
        overflow bucket).  ``None`` for an empty histogram — a made-up
        0.0 is indistinguishable from a real zero-latency sample, and
        callers that want a default can coalesce."""
        with self._lock:
            if self.count == 0:
                return None
            if self._values is not None:
                s = sorted(self._values)
                k = min(len(s) - 1,
                        max(0, int(round(q / 100.0 * (len(s) - 1)))))
                return float(s[k])
            rank = min(self.count - 1,
                       max(0, int(round(q / 100.0 * (self.count - 1)))))
            cum = 0
            for bound, c in zip(self.bounds, self.counts):
                cum += c
                if rank < cum:
                    return float(bound)
            return float(self.max)

    def to_dict(self) -> dict:
        return {"name": self.name, "labels": dict(self.labels),
                "kind": self.kind, "count": self.count, "sum": self.sum,
                "mean": self.mean,
                "min": self.min if self.count else None,
                "max": self.max if self.count else None,
                "buckets": [{"le": b, "count": c}
                            for b, c in zip(self.bounds, self.counts)]
                + [{"le": "+Inf", "count": self.counts[-1]}]}


class MetricsRegistry:
    """Get-or-create registry of metrics keyed by (name, labels)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, LabelSet], object] = {}

    def _get(self, cls, name: str, labels: Dict[str, object],
             **kwargs):
        key = (name, _labels(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, key[1], **kwargs)
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise TypeError(f"{name} already registered as "
                                f"{type(m).__name__}, wanted {cls.__name__}")
            return m

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get(Counter, name, labels, help=help)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get(Gauge, name, labels, help=help)

    def histogram(self, name: str, buckets: Sequence[float] = LATENCY_BUCKETS,
                  keep_values: bool = False, help: str = "",
                  **labels) -> Histogram:
        return self._get(Histogram, name, labels, buckets=buckets,
                         keep_values=keep_values, help=help)

    def metrics(self) -> List[object]:
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()

    # -- output ---------------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-ready state of every metric."""
        return {"metrics": [m.to_dict() for m in self.metrics()]}

    def dump_jsonl(self, path: str) -> str:
        """Append one timestamped snapshot line (the obs analog of the
        telemetry run store: cheap, append-only, machine-readable)."""
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        line = json.dumps({"ts": time.time(), **self.snapshot()},
                          sort_keys=True)
        with open(path, "a") as f:
            f.write(line + "\n")
        return path

    def prometheus_text(self) -> str:
        """Prometheus text exposition of the whole registry."""
        by_name: Dict[str, List[object]] = {}
        for m in self.metrics():
            by_name.setdefault(m.name, []).append(m)
        out: List[str] = []
        for name in sorted(by_name):
            group = by_name[name]
            first = group[0]
            if first.help:
                out.append(f"# HELP {name} {first.help}")
            out.append(f"# TYPE {name} {first.kind}")
            for m in group:
                ls = m.labels
                if isinstance(m, Histogram):
                    cum = 0
                    for bound, c in zip(m.bounds, m.counts):
                        cum += c
                        bl = ls + (("le", format(bound, "g")),)
                        out.append(f"{name}_bucket{_label_str(bl)} {cum}")
                    bl = ls + (("le", "+Inf"),)
                    out.append(f"{name}_bucket{_label_str(bl)} {m.count}")
                    out.append(f"{name}_sum{_label_str(ls)} {m.sum:.9g}")
                    out.append(f"{name}_count{_label_str(ls)} {m.count}")
                else:
                    out.append(f"{name}{_label_str(ls)} "
                               f"{format(m.value, '.9g')}")
        return "\n".join(out) + "\n"


def parse_prometheus_text(text: str) -> Dict[str, float]:
    """Inverse of :meth:`MetricsRegistry.prometheus_text` for the subset
    this module emits: ``{'name{k="v",...}': value}`` (comment and blank
    lines skipped).  Exists so the exposition format is round-trip
    tested, not write-only."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        body, _, value = line.rpartition(" ")
        if "{" in body:
            name, _, rest = body.partition("{")
            # label values are quoted and may contain escaped quotes,
            # backslashes, newlines — and literal commas — so a naive
            # split on "," mangles them; scan quote-aware instead.
            pairs = [(k, _unescape_label_value(v)) for k, v in
                     _LABEL_RE.findall(rest.rsplit("}", 1)[0])]
            key = name + _label_str(tuple(sorted(pairs)))
        else:
            key = body
        out[key] = float(value)
    return out


#: one ``key="value"`` pair; the value is any run of non-quote,
#: non-backslash characters or backslash escapes.
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


@dataclasses.dataclass(frozen=True)
class MetricKey:
    """Convenience for tests: the canonical exposition key of a sample."""

    name: str
    labels: Tuple[Tuple[str, str], ...] = ()

    def __str__(self) -> str:
        return self.name + _label_str(self.labels)
