"""Append-only JSONL run store under ``artifacts/telemetry_torch/``
(``$REPRO_TORCH_TELEMETRY_DIR``; ``repro_torch.paths``).

Measured runs are small self-describing records; the store groups them by
machine fingerprint (one ``runs-<fingerprint>.jsonl`` file each, like the
tuner's plan cache keys plans) so profiles from different hardware — or
different drift-bumped *revisions* of the same hardware — never mix.

The format is versioned (``TELEMETRY_SCHEMA``): readers skip lines whose
schema they do not understand instead of misreading them, and
``compact()`` rewrites a file dropping unreadable lines and capping the
per-scenario history, mirroring how the plan cache treats corrupt or
schema-mismatched entries as misses.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import threading
import time
from typing import Dict, Iterable, List, Optional

from .. import paths

#: bump when the record field set changes incompatibly — old lines are
#: skipped on read and dropped on compaction, never misread.
TELEMETRY_SCHEMA = 1


def telemetry_dir() -> str:
    """The default store's directory, resolved at each call."""
    return paths.telemetry_dir()


@dataclasses.dataclass
class RunRecord:
    """One measured execution, tagged with everything the residual join
    needs to look up the model's prediction for the same scenario."""

    fingerprint: str            # machine fingerprint (keys the store file)
    machine: str                # machine-model name ("cpu-host", ...)
    op: str                     # algo/model key: "summa", "cannon", "serve"...
    variant: str                # "2d", "2.5d_ovlp", ... ("" when N/A)
    n: int                      # problem size (seq len for serving)
    p: int                      # processes used
    c: int                      # replication factor
    dtype: str = "float32"
    kind: str = "dispatch"      # "dispatch" | "serve" | "plan" | "manual"
    phases: Dict[str, float] = dataclasses.field(default_factory=dict)
    predicted: Dict[str, float] = dataclasses.field(default_factory=dict)
    meta: Dict[str, object] = dataclasses.field(default_factory=dict)
    timestamp: float = 0.0

    def __post_init__(self):
        if not self.timestamp:
            self.timestamp = time.time()

    @property
    def total(self) -> float:
        """Measured wall seconds: the explicit "total" phase when present,
        else the sum of the recorded phases."""
        if "total" in self.phases:
            return float(self.phases["total"])
        return float(sum(self.phases.values()))

    def scenario_key(self) -> str:
        return f"{self.kind}-{self.op}-{self.variant}-n{self.n}-p{self.p}-c{self.c}-{self.dtype}"

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["schema"] = TELEMETRY_SCHEMA
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "RunRecord":
        d = dict(d)
        if d.pop("schema", None) != TELEMETRY_SCHEMA:
            raise ValueError("telemetry schema mismatch")
        return cls(**d)


class RunStore:
    """Append-only JSONL store of :class:`RunRecord`, one file per machine
    fingerprint.  Appends are line-atomic (single ``write`` of one
    ``\\n``-terminated line under a lock); reads tolerate torn or foreign
    lines by skipping them."""

    def __init__(self, directory: Optional[str] = None):
        self.directory = directory or telemetry_dir()
        self._lock = threading.Lock()
        self.appended = 0
        self.skipped_lines = 0

    def path_for(self, fingerprint: str) -> str:
        safe = re.sub(r"[^A-Za-z0-9._-]", "_", fingerprint or "unknown")
        return os.path.join(self.directory, f"runs-{safe}.jsonl")

    def fingerprints(self) -> List[str]:
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        out = []
        for name in sorted(names):
            m = re.fullmatch(r"runs-(.+)\.jsonl", name)
            if m:
                out.append(m.group(1))
        return out

    def append(self, record: RunRecord) -> None:
        os.makedirs(self.directory, exist_ok=True)
        line = json.dumps(record.to_dict(), sort_keys=True) + "\n"
        path = self.path_for(record.fingerprint)
        with self._lock:
            with open(path, "a") as f:
                f.write(line)
            self.appended += 1

    def extend(self, records: Iterable[RunRecord]) -> None:
        for r in records:
            self.append(r)

    def load(self, fingerprint: Optional[str] = None) -> List[RunRecord]:
        """All readable records (for one fingerprint, or every file),
        oldest first.  Unparseable / wrong-schema lines are counted in
        ``skipped_lines`` and otherwise ignored."""
        fps = [fingerprint] if fingerprint is not None else self.fingerprints()
        out: List[RunRecord] = []
        for fp in fps:
            try:
                with open(self.path_for(fp)) as f:
                    lines = f.readlines()
            except OSError:
                continue
            for line in lines:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(RunRecord.from_dict(json.loads(line)))
                except (ValueError, TypeError):
                    with self._lock:
                        self.skipped_lines += 1
        out.sort(key=lambda r: r.timestamp)
        return out

    def count(self, fingerprint: Optional[str] = None) -> int:
        return len(self.load(fingerprint))

    def compact(self, fingerprint: Optional[str] = None,
                keep_last: int = 256) -> int:
        """Rewrite the store file(s): drop unreadable and old-schema lines,
        keep at most ``keep_last`` most-recent records per scenario key.
        Returns the number of lines dropped.  The rewrite goes through a
        temp file + ``os.replace`` so concurrent readers never see a
        partial file."""
        fps = [fingerprint] if fingerprint is not None else self.fingerprints()
        dropped = 0
        for fp in fps:
            path = self.path_for(fp)
            # read-filter-rewrite under the lock: an append racing an
            # unlocked read would be erased by the replace below
            with self._lock:
                try:
                    with open(path) as f:
                        lines = [ln for ln in f.read().splitlines()
                                 if ln.strip()]
                except OSError:
                    continue
                records: List[RunRecord] = []
                for line in lines:
                    try:
                        records.append(RunRecord.from_dict(json.loads(line)))
                    except (ValueError, TypeError):
                        dropped += 1
                by_scenario: Dict[str, List[RunRecord]] = {}
                for r in records:
                    by_scenario.setdefault(r.scenario_key(), []).append(r)
                keep: List[RunRecord] = []
                for scen in by_scenario.values():
                    scen.sort(key=lambda r: r.timestamp)
                    dropped += max(0, len(scen) - keep_last)
                    keep.extend(scen[-keep_last:])
                keep.sort(key=lambda r: r.timestamp)
                tmp = f"{path}.tmp.{os.getpid()}"
                with open(tmp, "w") as f:
                    for r in keep:
                        f.write(json.dumps(r.to_dict(), sort_keys=True) + "\n")
                os.replace(tmp, path)
        return dropped
