"""The roofline table: the dry run's records (``launch/dryrun.py``,
``<root>/dryrun_torch/<mesh>/*.json`` under the port's artifacts root) as the per-(arch x shape x mesh) three
terms and the dominant bottleneck of each.  The terms are a spec-sheet
model of the H100 (``core/roofline.py``), not measurements.

    python -m repro_torch.benchmarks.roofline_table
    python -m repro_torch.benchmarks.roofline_table artifacts/dryrun_torch_dp_sp

(the second: the records a profile's dry run wrote under its ``--out``).
"""

import glob
import json
import os
import sys

from .. import paths


def load_cells(mesh: str = "pod", base: str = None):
    """The mesh's records, sorted by file name."""
    base = base or os.path.join(paths.root(), "dryrun_torch")
    cells = []
    for f in sorted(glob.glob(os.path.join(base, mesh, "*.json"))):
        with open(f) as fh:
            cells.append(json.load(fh))
    return cells


def markdown_table(cells) -> str:
    hdr = ("| arch | shape | compute s | memory s | collective s | dominant "
           "| MODEL_FLOPS | useful | roofline frac | GB/rank | fits |")
    sep = "|" + "---|" * 11
    lines = [hdr, sep]
    for c in cells:
        ma = c.get("memory_analysis", {})
        lines.append(
            f"| {c['arch']} | {c['shape']} | {c['compute_term']:.3g} | "
            f"{c['memory_term']:.3g} | {c['collective_term']:.3g} | "
            f"{c['dominant']} | {c['model_flops']:.3g} | "
            f"{c['useful_flops_fraction']:.2f} | "
            f"{c['roofline_fraction']:.3f} | "
            f"{ma.get('total_bytes', 0)/1e9:.1f} | "
            f"{'y' if c.get('fits_hbm') else 'n'} |")
    return "\n".join(lines)


def main(base: str = None) -> dict:
    out = {}
    for mesh in ("pod", "multipod"):
        cells = load_cells(mesh, base)
        if not cells:
            continue
        out[mesh] = {
            "n_cells": len(cells),
            "dominant_counts": {},
            "worst_fraction": None,
            "most_collective_bound": None,
            "fits_hbm": sum(bool(c.get("fits_hbm")) for c in cells),
        }
        for c in cells:
            d = c["dominant"]
            out[mesh]["dominant_counts"][d] = \
                out[mesh]["dominant_counts"].get(d, 0) + 1
        trains = [c for c in cells if c["kind"] == "train"]
        if trains:
            worst = min(trains, key=lambda c: c["roofline_fraction"])
            out[mesh]["worst_fraction"] = (
                f"{worst['arch']}@{worst['shape']}",
                worst["roofline_fraction"])
            collb = max(trains, key=lambda c: c["collective_term"]
                        / max(c["compute_term"], 1e-12))
            out[mesh]["most_collective_bound"] = (
                f"{collb['arch']}@{collb['shape']}",
                collb["collective_term"] / max(collb["compute_term"], 1e-12))
    return out


if __name__ == "__main__":
    base = sys.argv[1] if len(sys.argv) > 1 else None
    print(json.dumps(main(base)))
    for mesh in ("pod", "multipod"):
        print(f"\n{mesh}:\n" + markdown_table(load_cells(mesh, base)))
