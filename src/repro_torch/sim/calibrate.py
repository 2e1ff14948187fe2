"""Deriving ``C_avg`` / ``C_max`` calibration surfaces from simulated link
loads — the planning surface for machines we cannot benchmark (the paper's
extrapolation use-case).

Two derivation modes over the same topology layer:

* ``"static"`` (default) — the calibration factor of a rank is the peak
  load on its own DOR path when all ``p`` ranks shift simultaneously
  (serialization on the most-contended link): the paper's static
  link-load count, which the tables consumed by the LM-step model and the
  tuner are built from.
* ``"des"`` — run the shift pattern through the fluid max-rate
  :class:`~repro_torch.sim.network.Network` and read the factor off the actual
  completion times (``C = t / t_ideal``).  Dynamic factors are <= the
  static ones because link rates recover as competing transfers drain.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from ..core.perfmodel import CalibrationTable
from .network import Network, Transfer
from .topology import Topology, Torus


def hopper_like_topology() -> Torus:
    """A Gemini-like 3D torus sized for 4096 processes (Hopper scale)."""
    return Torus((16, 16, 16))


def v5e_pod_topology() -> Torus:
    """A v5e pod: 16x16 2D ICI torus (256 chips)."""
    return Torus((16, 16))


def shift_factors(topology: Topology, p: int, distance: int,
                  *, mode: str = "static") -> Tuple[float, float]:
    """(C_avg, C_max) when all ``p`` ranks send rank -> rank+distance."""
    p = min(int(p), topology.n_nodes)
    if mode == "static":
        paths = [topology.route(src, (src + distance) % p) for src in range(p)]
        load: Dict[int, int] = {}
        for path in paths:
            for link in path:
                load[link] = load.get(link, 0) + 1
        per_rank = [float(max((load[l] for l in path), default=1.0))
                    for path in paths]
        return float(np.mean(per_rank)), float(np.max(per_rank))
    if mode == "des":
        # unit-words transfers at beta=1, L=0: completion time IS the
        # effective serialization factor of each rank's message
        net = Network(topology, latency=0.0, beta=1.0)
        done = net.deliver([Transfer(src, (src + distance) % p, 1.0, 0.0)
                            for src in range(p)])
        done = np.maximum(done, 1.0)
        return float(done.mean()), float(done.max())
    raise ValueError(f"mode must be 'static' or 'des', got {mode!r}")


def derive_calibration(topology: Topology, ps: Sequence[int],
                       distances: Sequence[int],
                       *, mode: str = "static") -> CalibrationTable:
    """Build a :class:`~repro_torch.core.perfmodel.CalibrationTable` from
    simulated link loads on ``topology``, over a grid of process counts and
    shift distances.  Mirrors the paper's Fig. 3-4 aggregation: ``C_avg``
    is averaged over ``p`` (the paper finds it ~independent of p) while
    ``C_max`` keeps the full (p, d) surface."""
    avg: Dict[float, float] = {}
    mx: Dict[Tuple[float, float], float] = {}
    for d in distances:
        avgs = []
        for p in ps:
            a, m = shift_factors(topology, p, d, mode=mode)
            mx[(float(p), float(d))] = m
            avgs.append(a)
        avg[float(d)] = float(np.mean(avgs))
    return CalibrationTable(avg=avg, mx=mx)
