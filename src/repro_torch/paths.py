"""Where the port writes by default, and the variables that move it.

The port keeps its artifacts apart from the reference's: it reads none of
the reference's location variables (``REPRO_ARTIFACTS``,
``REPRO_TELEMETRY_DIR``, ``REPRO_PLAN_DIR``, ``REPRO_BENCH_HISTORY_DIR``),
and under the root the two packages share by default each of its
directories and files has a name of its own, beside the reference's and
never inside them:

  artifacts root           $REPRO_TORCH_ARTIFACTS, else <checkout>/artifacts
  run store, report.json   $REPRO_TORCH_TELEMETRY_DIR, else <root>/telemetry_torch
  plan cache               $REPRO_TORCH_PLAN_DIR, else <root>/plans_torch
  harness JSONs            <root>/bench_torch
  bench history            $REPRO_TORCH_BENCH_HISTORY_DIR,
                           else <root>/bench_torch/history
  fitted Hopper caches     <root>/hopper_{calibration,joint}_torch.json
  traces                   <root>/traces_torch
  obs summary, dashboard   <root>/obs_torch
  examples' checkpoints    <root>/ckpt_torch

Every location is resolved when it is asked for, never when a module is
imported, so a process that sets the variables after importing the port
writes where they say.  (A :class:`~repro_torch.tuner.PlanCache` or
:class:`~repro_torch.telemetry.RunStore` built without a directory keeps
the one resolved when it was built, and the process-wide
``default_tuner()`` and ``default_store()`` are built once.)  The on/off
switches ``REPRO_TELEMETRY`` and ``REPRO_OBS`` are the reference's: they
say whether to record, not where.
"""

from __future__ import annotations

import os

#: the checkout that holds this package (``<checkout>/src/repro_torch``)
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _env(name: str):
    return os.environ.get(name) or None


def root() -> str:
    """The artifacts root: ``$REPRO_TORCH_ARTIFACTS``, else the checkout's
    ``artifacts/``."""
    return os.path.abspath(_env("REPRO_TORCH_ARTIFACTS")
                           or os.path.join(CHECKOUT, "artifacts"))


def telemetry_dir() -> str:
    """The telemetry run store and its ``report.json``."""
    return (_env("REPRO_TORCH_TELEMETRY_DIR")
            or os.path.join(root(), "telemetry_torch"))


def plan_dir() -> str:
    """The tuner's persistent plan cache."""
    return _env("REPRO_TORCH_PLAN_DIR") or os.path.join(root(), "plans_torch")


def bench_dir() -> str:
    """The benchmark harness's stamped JSONs (``benchmarks.run``)."""
    return os.path.join(root(), "bench_torch")


def bench_history_dir() -> str:
    """The regression sentinel's bench history (beside the harness's
    stamped JSONs, ``<root>/bench_torch/``)."""
    return (_env("REPRO_TORCH_BENCH_HISTORY_DIR")
            or os.path.join(bench_dir(), "history"))


def hopper_cache(kind: str) -> str:
    """The fitted Hopper cache ``kind`` (``"calibration"`` or
    ``"joint"``)."""
    return os.path.join(root(), f"hopper_{kind}_torch.json")


def traces_dir() -> str:
    """Chrome / Perfetto traces (the simulator's, obs's exporters')."""
    return os.path.join(root(), "traces_torch")


def obs_dir() -> str:
    """obs's summary JSON and the observatory dashboard."""
    return os.path.join(root(), "obs_torch")


def ckpt_dir() -> str:
    """The examples' default checkpoint directories
    (``examples/train_e2e.py``)."""
    return os.path.join(root(), "ckpt_torch")
