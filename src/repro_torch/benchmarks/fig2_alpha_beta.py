"""Paper Fig. 2 analog on the port: LogP ping between two ranks -> (L, beta).

    python -m repro_torch.benchmarks.fig2_alpha_beta \\
        [--device cuda|cpu] [--world 2] [--backend gloo|nccl]

Spawns ``--world`` processes joined in one ``torch.distributed`` group
(``repro_torch.distributed.spawn``; ``--device cuda`` puts every rank on
``cuda:0`` under gloo and rank r on ``cuda:r`` under NCCL), pings between
ranks 0 and 1 (``core.calibration.bench_ping``, round trip / 2) at the
reference's sizes in fp32 words (``common.WORD_BYTES``) and fits
T(w) = L + beta w.  Prints rank 0's JSON: the
reference's keys, plus the transport the numbers measure, the device and
the world.
"""

from __future__ import annotations

import argparse
import json

from .common import WORD_BYTES

SIZES = (1 << 10, 1 << 14, 1 << 18, 1 << 21, 1 << 23)


def measure(rank: int, world: int, device) -> dict:
    """One rank's part: the ping and the fit (every rank gets rank 0's)."""
    import torch.distributed as dist
    from ..core.calibration import bench_ping, fit_alpha_beta
    ping = bench_ping(sizes_words=SIZES, word_bytes=WORD_BYTES,
                      group=dist.group.WORLD, device=device)
    L, beta = fit_alpha_beta(ping)
    # the bytes of a word sent; the reference's 8.0 counts the float64 it
    # asks for, not the float32 it sends
    return {"latency_s": L, "beta_s_per_word": beta,
            "bandwidth_GBps": WORD_BYTES / beta / 1e9,
            "ping": {str(k): v for k, v in ping.items()}}


def main(world: int = 2, device: str = "cuda",
         backend: str = "gloo") -> dict:
    from ..devices import device_kind_of
    from ..distributed import devices_for, transport
    from .common import run_group_bench
    out = run_group_bench(measure, world, device, backend)
    out.update(transport=transport(backend, device), world=world,
               device=device_kind_of(devices_for(device, backend)(0)))
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    args = ap.parse_args()
    print(json.dumps(main(args.world, args.device, args.backend)))
