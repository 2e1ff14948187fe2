"""Paper Figs. 3-4 analog on the port: contention calibration factors.

    python -m repro_torch.benchmarks.fig34_calibration \\
        [--device cuda|cpu] [--world 4] [--backend gloo|nccl]

Two sources, reported side by side:
* measured — ``--world`` spawned ranks (``repro_torch.distributed.spawn``)
  shift at once at distance d (``core.calibration.bench_contention``);
  factor = slowest rank's wall / ideal, ideal = L + beta words from a ping
  between ranks 0 and 1 (the paper's "synchronized" case);
* simulated — the torus link-load model of the port's ``sim`` (Hopper-like
  3D torus and a v5e 2D pod), which also supplies C_avg and extends to p
  no machine here hosts.

Prints rank 0's JSON: the reference's keys, plus the transport the
measured factors are of, the device and the world.
"""

from __future__ import annotations

import argparse
import json
import tempfile

WORDS = 1 << 20


def measure(rank: int, world: int, device) -> dict:
    """One rank's part: the ping, its fit and the measured factors."""
    import torch.distributed as dist
    from ..core.calibration import (bench_contention, bench_ping,
                                    fit_alpha_beta)
    group = dist.group.WORLD
    ping = bench_ping(sizes_words=(1 << 18, 1 << 21), group=group,
                      device=device)
    L, beta = fit_alpha_beta(ping)
    ideal = L + beta * WORDS
    measured = {}
    for d in dict.fromkeys((1, 2, world // 2)):
        wall = bench_contention(world, d, words=WORDS, group=group,
                                device=device)
        measured[str(d)] = wall / ideal
    return {"measured_factor_vs_distance": measured, "ideal_s": ideal}


def simulated() -> dict:
    from ..sim import hopper_like_topology, shift_factors, v5e_pod_topology
    sim = {}
    for name, topo, ps in (("hopper3d", hopper_like_topology(),
                            (64, 1024, 4096)),
                           ("v5e2d", v5e_pod_topology(), (16, 64, 256))):
        rows = {}
        for d in (1, 4, 16, 32):
            for p in ps:
                cavg, cmax = shift_factors(topo, p, d)
                rows[f"p{p}_d{d}"] = {"c_avg": cavg, "c_max": cmax}
        sim[name] = rows
    return sim


def main(world: int = 4, device: str = "cuda",
         backend: str = "gloo") -> dict:
    from ..distributed import devices_for, spawn, transport
    from ..devices import device_kind_of
    place = devices_for(device, backend)
    with tempfile.TemporaryDirectory() as init_dir:
        out = spawn(measure, world, backend=backend, device_of_rank=place,
                    init_dir=init_dir)[0]
    out.update(simulated=simulated(), transport=transport(backend, device),
               world=world, device=device_kind_of(place(0)))
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    args = ap.parse_args()
    print(json.dumps(main(args.world, args.device, args.backend)))
