"""Shared benchmark plumbing of the port: CSV emission
(name,us_per_call,derived), group runs for the benches that need several
ranks, and the run-metadata stamp every emitted JSON carries (commit SHA,
timestamp, machine fingerprint, repeat count; on a card also its name and
power limit) so that the bench-history sentinel can join runs across
commits and keep noise bands per machine.

Artifacts go under ``ART`` (``$REPRO_ARTIFACTS``, default the checkout's
``artifacts/``); the stamped JSONs under ``ART/bench_torch/``, apart from
the reference suite's ``artifacts/bench/``.
"""

from __future__ import annotations

import hashlib
import os
import platform
import subprocess
import tempfile
import time
from typing import Callable, Optional, Sequence

from ..core.calibration import ARTIFACTS_DIR

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
ART = os.path.abspath(ARTIFACTS_DIR)

#: repeat count the emitters report in their stamp (env-overridable so a
#: CI matrix leg that runs each bench N times can say so).
DEFAULT_REPEATS = int(os.environ.get("REPRO_BENCH_REPEATS", "1"))

#: bytes of a word in the link benchmarks (fig2, fig34, fig5to8): fp32, the
#: blocks' type and the reference's (it asks for float64, which it gets as
#: float32 without x64), so that beta is per word as the model counts one
WORD_BYTES = 4

#: seconds a group bench's world may run before ``spawn`` fails it
GROUP_TIMEOUT_S = 900.0


def git_commit() -> str:
    """Current commit SHA — CI env vars first (works in shallow/exported
    checkouts), then git, else ""."""
    for var in ("REPRO_BENCH_COMMIT", "GITHUB_SHA"):
        sha = os.environ.get(var)
        if sha:
            return sha
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"], cwd=REPO,
                             capture_output=True, text=True, timeout=10)
        if out.returncode == 0:
            return out.stdout.strip()
    except OSError:
        pass
    return ""


def _card_name() -> Optional[str]:
    """The current CUDA device's name, None without a GPU."""
    import torch
    if not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_name()


def machine_fingerprint() -> str:
    """Short stable id of the *host* running the benches (distinct from
    the model's ``Machine.fingerprint()``, which names a calibrated
    profile).  Same host + toolchain + package (and card) -> same id;
    history noise bands are only computed within one id, so the port's
    runs never join the reference suite's on the same host.
    ``REPRO_BENCH_FINGERPRINT`` overrides (CI sets one per runner
    class)."""
    env = os.environ.get("REPRO_BENCH_FINGERPRINT")
    if env:
        return env
    parts = [platform.machine(), platform.system(), platform.processor(),
             str(os.cpu_count()), platform.python_version(), "torch"]
    card = _card_name()
    if card:
        parts.append(card)
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:12]


def card_stamp() -> dict:
    """``{"device": name, "power_limit_w": watts}`` of the first card, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    reports them; empty without a GPU."""
    if _card_name() is None:
        return {}
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    name, limit = out.stdout.strip().splitlines()[0].rsplit(",", 1)
    return {"device": name.strip(),
            "power_limit_w": float(limit.strip().split()[0])}


def run_meta(repeats: int = DEFAULT_REPEATS) -> dict:
    """The ``_meta`` stamp written into every bench JSON."""
    meta = {
        "commit": git_commit(),
        "timestamp": time.time(),
        "fingerprint": machine_fingerprint(),
        "repeats": int(repeats),
        "python": platform.python_version(),
        "platform": f"{platform.system()}-{platform.machine()}",
    }
    meta.update(card_stamp())
    return meta


def emit(name: str, us_per_call: float, derived: str = ""):
    print(f"{name},{us_per_call:.3f},{derived}", flush=True)


def run_group_bench(fn: Callable, world: int, device: str = "cuda",
                    backend: str = "gloo", args: Sequence = ()) -> dict:
    """Run ``fn(rank, world, rank_device, *args)`` in a spawned
    ``torch.distributed`` world (``repro_torch.distributed.spawn``, its
    file store in a temporary directory, never a TCP port) and return rank
    0's result.  ``device``: ``"cpu"``, or ``"cuda"`` (every rank on
    cuda:0 under gloo, a card a rank under NCCL).  A rank that fails fails
    the call."""
    from ..distributed import devices_for, spawn
    place = devices_for(device, backend)
    if device == "cuda":
        from ..devices import default_devices
        default_devices()                 # no GPU: raise here, not in a rank
    with tempfile.TemporaryDirectory() as init_dir:
        return spawn(fn, world, backend=backend, device_of_rank=place,
                     init_dir=init_dir, timeout_s=GROUP_TIMEOUT_S,
                     args=tuple(args))[0]


class Timer:
    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *a):
        self.seconds = time.perf_counter() - self.t0
