"""Paper Fig. 1 analog on the port's device: local-routine efficiency vs
block size, plus the fitted ``EfficiencyCurve`` parameters the performance
model plans from.

    python -m repro_torch.benchmarks.fig1_blas_efficiency \\
        [--device cuda] [--route kernels|library] [--sizes 256 512 ...]

Prints one JSON object: the device, the best dgemm rate (the measured
peak), and per routine its GFLOP/s by size, the kernel launches of one call
at each size (empty where the size ran a plain version or the library)
and the fitted ``(eff_max, n0)``.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

DEFAULT_SIZES = (128, 256, 512, 1024, 2048)


def main(sizes: Sequence[int] = DEFAULT_SIZES, device: Optional[str] = None,
         route: str = "kernels", reps: int = 3) -> dict:
    from ..core.calibration import fit_efficiency, rates, time_routines
    from ..devices import canonical, default_devices, device_kind_of
    dev = canonical(device) if device else default_devices()[0]
    entries = time_routines(sizes, device=dev, route=route, reps=reps)
    bench = rates(entries)
    peak = max(bench["dgemm"].values())
    out = {"device": device_kind_of(dev), "route": route,
           "dtype": "float32",
           "peak_gflops": peak / 1e9, "routines": {}}
    for rout, vals in bench.items():
        curve = fit_efficiency(vals, peak)
        out["routines"][rout] = {
            "gflops": {str(k): v / 1e9 for k, v in vals.items()},
            "launches": {str(e["n"]): {k: v for k, v in e["launches"].items()
                                       if v}
                         for e in entries if e["routine"] == rout},
            "eff_max": curve.eff_max, "n0": curve.n0,
        }
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    ap.add_argument("--route", choices=("kernels", "library"),
                    default="kernels")
    ap.add_argument("--sizes", type=int, nargs="+", default=DEFAULT_SIZES)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    print(json.dumps(main(args.sizes, args.device, args.route, args.reps)))
