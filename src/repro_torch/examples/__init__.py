"""The reference's four examples on the port, each run as
``python -m repro_torch.examples.<name>``:

  quickstart       the paper's workflow: a fitted Hopper model, variant
                   choice, the cost IR, the simulator, the measured
                   feedback loop on the device (K1 on the card), the
                   observatory, a fault diagnosis, the LM table
  linalg_25d_demo  2D vs 2.5D Cannon / TRSM / Cholesky on a stacked grid
                   against numpy, the tuner's dispatch, the model's advice
  serve_batched    a reduced model served through ``Engine.generate``,
                   then a trace replayed on the simulated clock
  train_e2e        ``Trainer.run`` with checkpoints, straggler monitoring
                   and an optional injected fault

Each takes ``--device cuda|cpu``; the default is the current GPU, and
there is no CPU fallback: without a GPU, ``--device cuda`` exits with the
no-GPU message.  They write only under the port's artifact locations
(``repro_torch.paths``).
"""

from __future__ import annotations

import argparse

import torch

from ..devices import default_devices


def add_device_argument(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device of the example's tensors (default: the "
                         "current GPU; no CPU fallback)")


def device_for(name: str) -> torch.device:
    """``torch.device`` for ``--device``: the current GPU for ``cuda``
    (exits with the no-GPU message where there is none), else the CPU."""
    if name == "cpu":
        return torch.device("cpu")
    try:
        return default_devices()[0]
    except RuntimeError as exc:
        raise SystemExit(f"--device cuda: {exc}") from None
