"""Execution plans and the persistent plan cache.

An ``ExecutionPlan`` is the tuner's output: everything the dispatch layer
needs to run a distributed linalg call — the chosen algorithm variant, the
replication factor ``c``, block-cyclic ``r``, the process-grid edge ``g``
(mesh shape is ``(c, g, g)``, or ``(g, g)`` at ``c=1``), the local-kernel
choice, and the model's predicted timing for observability.

Plans persist as JSON under ``artifacts/plans_torch/``
(``$REPRO_TORCH_PLAN_DIR``; ``repro_torch.paths``) keyed by

    (machine fingerprint, algo, n, p, dtype)

so a repeated call — even from a fresh process — skips model evaluation
entirely.  The machine fingerprint hashes the machine-model name, the device
platform, the device kind and the device count: moving the same
scenario to different hardware (or resizing the pool) invalidates the
cached plan, while re-running on the same pool hits it.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import threading
from typing import Dict, Optional

from .. import paths
from ..perf import MODEL_VERSION

#: bump when the plan *schema* (the JSON field set) changes incompatibly —
#: stale cache entries are ignored, not misread.  Schema 2 added the
#: ``model_version`` field; schema 3 added the kernel-tier ``tiles`` map.
PLAN_SCHEMA = 3


def default_plan_dir() -> str:
    """A cache's directory when none is given, resolved at each call."""
    return paths.plan_dir()


def machine_fingerprint(machine, platform: str, device_kind: str,
                        device_count: int) -> str:
    """Short stable hash of the execution substrate a plan was tuned for.

    ``machine`` is a :class:`~repro_torch.core.machine.Machine` (preferred: its
    own ``fingerprint()`` — a hash of every profile field including the
    telemetry-bumped ``revision`` — becomes part of the key, so refits and
    drift invalidation retire stale plans automatically) or a plain string
    tag for non-profile keys like the LM fsdp recommendation."""
    tag = machine.fingerprint() if hasattr(machine, "fingerprint") \
        else str(machine)
    blob = f"{tag}|{platform}|{device_kind}|{device_count}"
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


def plan_key(fingerprint: str, algo: str, n: int, p: int, dtype: str) -> str:
    return f"{fingerprint}-{algo}-n{n}-p{p}-{dtype}"


@dataclasses.dataclass
class ExecutionPlan:
    """A fully-resolved decision for one (machine, algo, n, p, dtype) cell."""

    algo: str               # "cannon" | "summa" | "trsm" | "cholesky"
    variant: str            # "2d" | "2d_ovlp" | "2.5d" | "2.5d_ovlp"
    n: int                  # global problem size
    p: int                  # processes used (c * g * g)
    c: int                  # replication factor (1 for 2D)
    r: int                  # block-cyclic factor (executables use 1)
    g: int                  # grid edge: mesh is (c, g, g)
    local_kernel: str       # "pallas" | "jnp"
    dtype: str
    machine: str            # machine-model name the prediction used
    fingerprint: str
    predicted: Dict[str, float]  # {"total": s, "comm": s, "comp": s}
    # kernel family -> block dict, e.g. {"matmul": {"bm": 256, ...}} —
    # resolved by the kernel-tier model (perf.kernel.tiles_for_plan), or
    # the heuristic blocks when the machine has no kernel_constants
    tiles: Dict[str, Dict[str, int]] = dataclasses.field(
        default_factory=dict)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["schema"] = PLAN_SCHEMA
        d["model_version"] = MODEL_VERSION
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ExecutionPlan":
        """Raises ValueError on schema *or* model-version mismatch: a plan
        picked by older model equations must be re-planned, not silently
        served (callers treat the ValueError as a cache miss)."""
        d = dict(d)
        if d.pop("schema", None) != PLAN_SCHEMA:
            raise ValueError("plan schema mismatch")
        if d.pop("model_version", None) != MODEL_VERSION:
            raise ValueError("plan model-version mismatch")
        return cls(**d)


class PlanCache:
    """Two-layer (memory + JSON-on-disk) cache of plan payloads.

    Payloads are plain dicts (``ExecutionPlan.to_dict`` for linalg plans;
    other tuner decisions, e.g. the LM fsdp recommendation, store their own
    small dicts).  Corrupt or schema-mismatched files read as misses.
    """

    def __init__(self, directory: Optional[str] = None):
        self.directory = directory or default_plan_dir()
        self._mem: Dict[str, dict] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.disk_hits = 0

    def _path(self, key: str) -> str:
        safe = re.sub(r"[^A-Za-z0-9._-]", "_", key)
        return os.path.join(self.directory, f"{safe}.json")

    def get(self, key: str) -> Optional[dict]:
        with self._lock:
            if key in self._mem:
                self.hits += 1
                return self._mem[key]
        path = self._path(key)
        try:
            with open(path) as f:
                payload = json.load(f)
        except (OSError, json.JSONDecodeError):
            with self._lock:
                self.misses += 1
            return None
        with self._lock:
            self._mem[key] = payload
            self.hits += 1
            self.disk_hits += 1
        return payload

    def put(self, key: str, payload: dict) -> None:
        with self._lock:
            self._mem[key] = payload
        os.makedirs(self.directory, exist_ok=True)
        path = self._path(key)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
        os.replace(tmp, path)  # atomic: concurrent readers never see partial JSON

    def invalidate(self, key: str) -> None:
        with self._lock:
            self._mem.pop(key, None)
        try:
            os.remove(self._path(key))
        except OSError:
            pass

    def clear_memory(self) -> None:
        """Drop the in-process layer (tests use this to prove disk hits)."""
        with self._lock:
            self._mem.clear()
