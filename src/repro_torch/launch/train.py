"""Training launcher: ``Trainer.run`` on a reduced or full-width model with
weights drawn from a seed and the synthetic data pipeline, on one device or
sharded over a mesh of ranks.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-4b \
        --smoke --device cpu --steps 5
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-4b \
        --smoke --steps 50                    # the current GPU
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-4b \
        --smoke --device cpu --mesh 2,2,2     # 8 gloo ranks on the CPU

``--mesh pods,data,model`` spawns ``pods * data * model`` ranks
(``distributed.spawn``) joined in one group: gloo on the CPU with
``--device cpu``; gloo with every rank on the one card, staged through
pinned host memory, by default; NCCL with ``--backend nccl``, a card a
rank.  Launched inside a world (``WORLD_SIZE`` set, as ``torchrun`` sets
it), the launcher joins that world instead of spawning one.  Without
``--mesh`` a world of 256 ranks or more takes the production mesh
(``--multi-pod``: two pods); a smaller one, or none, trains unsharded, as
the reference does.

It prints the last logged steps' metrics and ``steps= restarts=`` (rank 0
only; every rank logs the same metrics).
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile

#: seconds a spawned world may run
WORLD_TIMEOUT_S = 3600.0


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config (fp32, 2 narrow layers)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mesh", default=None,
                    help="pods,data,model (elastic override)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current GPU)")
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"),
                    help="the group's backend under a mesh")
    return ap


def _train_config(args):
    from ..configs import get
    from ..training import AdamWConfig, DataConfig, TrainConfig
    cfg_m = get(args.arch)
    if args.smoke:
        cfg_m = cfg_m.reduced()
    return TrainConfig(
        model=cfg_m,
        opt=AdamWConfig(lr=3e-4, warmup_steps=min(20, args.steps // 5 + 1),
                        total_steps=args.steps),
        data=DataConfig(vocab_size=cfg_m.vocab_size, seq_len=args.seq,
                        global_batch=args.batch),
        n_steps=args.steps, checkpoint_dir=args.ckpt_dir)


def mesh_axes(text: str):
    """``"pods,data,model"`` as three ints, each at least 1."""
    axes = tuple(int(x) for x in text.split(","))
    if len(axes) != 3 or min(axes) < 1:
        raise ValueError(f"--mesh takes pods,data,model, each >= 1; got "
                         f"{text!r}")
    return axes


def _mesh_of(args, world: int):
    """The mesh over the current group: ``--mesh``, else the production
    mesh on 256 ranks or more, else None."""
    from .mesh import make_mesh, make_production_mesh
    if args.mesh:
        return make_mesh(*mesh_axes(args.mesh))
    if world >= 256:
        return make_production_mesh(multi_pod=args.multi_pod)
    return None


def _run(args, device, world: int) -> dict:
    from ..training import Trainer
    mesh = _mesh_of(args, world) if world > 1 or args.mesh else None
    return Trainer(_train_config(args), mesh=mesh, device=device).run()


def _rank(rank, world, device, argv):
    """One rank of a spawned world: its ``Trainer.run`` report."""
    return _run(_parser().parse_args(argv), device, world)


def _report(report: dict) -> None:
    for h in report["logged"][-5:]:
        print(h)
    print(f"steps={report['steps']} restarts={report['restarts']}")


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    kind = "cpu" if args.device == "cpu" else "cuda"
    if os.environ.get("WORLD_SIZE"):
        import torch
        import torch.distributed as dist
        from ..distributed import devices_for
        world = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ.get("RANK", "0"))
        local = int(os.environ.get("LOCAL_RANK", str(rank)))
        device = devices_for(kind, args.backend)(local)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        if not dist.is_initialized():
            dist.init_process_group(args.backend, init_method="env://",
                                    rank=rank, world_size=world)
        report = _run(args, device, world)
        if rank == 0:
            _report(report)
        return report
    if not args.mesh:
        report = _run(args, args.device, 1)
        _report(report)
        return report
    from ..distributed import devices_for, spawn
    pods, data, model = mesh_axes(args.mesh)
    init_dir = tempfile.mkdtemp(prefix="train_world_")
    try:
        reports = spawn(_rank, pods * data * model, backend=args.backend,
                        device_of_rank=devices_for(kind, args.backend),
                        init_dir=init_dir, timeout_s=WORLD_TIMEOUT_S,
                        args=(list(argv) if argv is not None
                              else sys.argv[1:],))
    finally:
        shutil.rmtree(init_dir, ignore_errors=True)
    _report(reports[0])
    return reports[0]


if __name__ == "__main__":
    main()
