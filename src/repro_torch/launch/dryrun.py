"""The dry run: one rank's step of every (arch x shape) cell on the
production meshes, counted on a host with no card, as JSON records for the
roofline table.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-110b \\
        --shape train_4k --mesh pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch starcoder2-3b \\
        --shape prefill_32k --device cuda          # the same rank on the card

Each mesh is the reference's, (16, 16) ``data, model`` and (2, 16, 16)
``pod, data, model``, as a ``counting_mesh``: rank 0 is built
(``launch/specs.py``; every rank's blocks have one shape) and its step runs
on the ``meta`` device under ``core/roofline.py``'s count, its collectives
recorded and not sent.  ``--device cuda`` runs the same rank's step on the
card (collectives still counted): the count of its first run, then a
second run, with the measured peak memory and both walls in the record.
It never falls back to the CPU.  A decode cell counts one serving step
(one new token a row) against the rank's blocks of its caches.

``--profile dp_sp`` / ``seq_sp`` count the cell under the reference's other
sharding profiles (``launch/specs.py::PROFILES``), with the record's
``profile`` saying which.  Records go to
``--out``/``<mesh>/<arch>@<shape>.json`` (default ``dryrun_torch`` under
the port's artifacts root, ``$REPRO_TORCH_ARTIFACTS`` or the checkout's
``artifacts/``; ``repro_torch.paths``);
existing ones are kept unless ``--force``, so a profile's run takes an
``--out`` of its own.  Every number in them is a spec-sheet model of the
card (``H100_SXM``), not a measurement, but for ``measured``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from .. import paths
from ..configs import ALL_CELLS, SHAPES
from ..core import roofline as rl
from ..core.machine import H100_SXM
from .mesh import counting_mesh, mesh_chips
from .specs import PROFILES, rules_for, step_and_specs

#: the reference's production meshes
MESHES = {"pod": (16, 16), "multipod": (2, 16, 16)}


def run_cell(arch: str, shape: str, mesh, mesh_name: str, out_dir: str,
             force: bool = False, verbose: bool = True,
             profile: str = "baseline", device: str = "meta",
             layers=None) -> dict:
    """Count rank ``mesh.rank``'s step of one cell and write its record
    (or read the one already written, unless ``force``)."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch}@{shape}.json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    dev = torch.device(device)
    if dev.type not in ("meta", "cuda"):
        raise ValueError(f"the dry run counts on 'meta' or 'cuda', got "
                         f"{device!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a GPU: this host has none")
    if dev.type == "cuda":
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    # the profile's rules travel with the mesh into the rank's step
    mesh = mesh.with_rules(rules_for(arch, profile))
    step_fn, args, model_flops, meta = step_and_specs(
        arch, shape, mesh, device=dev, layers=layers)
    t_build = time.perf_counter() - t0
    chips = mesh_chips(mesh)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    count = rl.count_step(lambda: step_fn(*args), args)
    terms = rl.terms_of(count, arch=arch, shape=shape, mesh_name=mesh_name,
                        chips=chips, model_flops=model_flops,
                        machine=H100_SXM)
    record = terms.to_dict()
    record.update(meta)
    record.update(lowered=True, device=dev.type, profile=profile,
                  ops=count.ops, peak_by_op=count.peak_by_op)
    # the reference's timing keys: building the rank's arguments, and the
    # counted run (which stands in for lowering and compiling)
    record["lower_s"] = round(t_build, 2)
    record["compile_s"] = round(count.wall_s, 2)
    ma = record["memory_analysis"]
    record["fits_hbm"] = bool(ma["total_bytes"] <= H100_SXM.mem_per_unit)
    if dev.type == "cuda":
        record["measured"] = measure_on_card(step_fn, args, count, base)
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    if verbose:
        print(summary(record), flush=True)
    return record


def measure_on_card(step_fn, args, count, base: int) -> dict:
    """The counted run's peak memory (``max_memory_allocated`` less the
    ``base`` allocated before the rank's arguments were made: the
    counterpart of the count's ``total_bytes``) and wall (its first run:
    ``cold_s`` includes the count's host work), then an uncounted second
    run's wall (``warm_s``), each ending in a synchronize."""
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    out = step_fn(*args)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    del out
    return {"max_memory_allocated": float(peak - base),
            "allocated_before": float(base), "cold_s": count.wall_s,
            "warm_s": warm, "card": torch.cuda.get_device_name(0)}


def summary(r: dict) -> str:
    head = f"[{r['mesh']}] {r['arch']}@{r['shape']}:"
    ma = r["memory_analysis"]
    return (f"{head} count {r['compile_s']:.1f}s  "
            f"args {ma['argument_bytes'] / 1e9:.2f} GB/rank  "
            f"peak {ma['total_bytes'] / 1e9:.2f} GB/rank  "
            f"compute {r['compute_term']:.4g}s memory "
            f"{r['memory_term']:.4g}s collective "
            f"{r['collective_term']:.4g}s  dominant={r['dominant']}  "
            f"roofline_frac={r['roofline_fraction']:.3f}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None,
                    choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", type=str, default="pod",
                    choices=("pod", "multipod", "both"))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--profile", type=str, default="baseline",
                    choices=tuple(PROFILES))
    ap.add_argument("--device", type=str, default="meta",
                    choices=("meta", "cuda"))
    ap.add_argument("--out", type=str,
                    default=os.path.join(paths.root(), "dryrun_torch"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda needs a GPU: this host has none")

    cells = ALL_CELLS if args.all else [
        (a, s) for (a, s) in ALL_CELLS
        if (args.arch is None or a == args.arch)
        and (args.shape is None or s == args.shape)]
    names = ("pod", "multipod") if args.mesh == "both" else (args.mesh,)

    failures = []
    for mesh_name in names:
        mesh = counting_mesh(MESHES[mesh_name], 0)
        for arch, shape in cells:
            try:
                run_cell(arch, shape, mesh, mesh_name,
                         os.path.join(args.out, mesh_name),
                         force=args.force, profile=args.profile,
                         device=args.device)
            except Exception as e:  # noqa: BLE001 -- report every cell
                failures.append((mesh_name, arch, shape, repr(e)))
                print(f"[{mesh_name}] {arch}@{shape}: FAIL {e}", flush=True)
                traceback.print_exc()
    n = len(cells) * len(names)
    print(f"\ndone: {n - len(failures)} counted, {len(failures)} failed")
    for f in failures:
        print("  FAIL:", *f)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
