"""Paper Fig. 2 analog on the port: LogP ping between two ranks -> (L, beta).

    python -m repro_torch.benchmarks.fig2_alpha_beta \\
        [--device cuda|cpu] [--world 2] [--backend gloo|nccl]

Spawns ``--world`` processes joined in one ``torch.distributed`` group
(``repro_torch.distributed.spawn``; ``--device cuda`` puts every rank on
``cuda:0`` under gloo and rank r on ``cuda:r`` under NCCL), pings between
ranks 0 and 1 (``core.calibration.bench_ping``, round trip / 2) at the
reference's sizes and fits T(w) = L + beta w.  Prints rank 0's JSON: the
reference's keys, plus the transport the numbers measure, the device and
the world.
"""

from __future__ import annotations

import argparse
import json
import tempfile
SIZES = (1 << 10, 1 << 14, 1 << 18, 1 << 21, 1 << 23)


def measure(rank: int, world: int, device) -> dict:
    """One rank's part: the ping and the fit (every rank gets rank 0's)."""
    import torch.distributed as dist
    from ..core.calibration import bench_ping, fit_alpha_beta
    ping = bench_ping(sizes_words=SIZES, group=dist.group.WORLD,
                      device=device)
    L, beta = fit_alpha_beta(ping)
    return {"latency_s": L, "beta_s_per_word": beta,
            "bandwidth_GBps": 8.0 / beta / 1e9,
            "ping": {str(k): v for k, v in ping.items()}}


def main(world: int = 2, device: str = "cuda",
         backend: str = "gloo") -> dict:
    from ..distributed import devices_for, spawn, transport
    from ..devices import device_kind_of
    place = devices_for(device, backend)
    with tempfile.TemporaryDirectory() as init_dir:
        out = spawn(measure, world, backend=backend, device_of_rank=place,
                    init_dir=init_dir)[0]
    out.update(transport=transport(backend, device), world=world,
               device=device_kind_of(place(0)))
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    args = ap.parse_args()
    print(json.dumps(main(args.world, args.device, args.backend)))
