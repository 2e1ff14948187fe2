"""Training launcher: ``Trainer.run`` on a reduced or full-width model with
weights drawn from a seed and the synthetic data pipeline.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-4b \
        --smoke --device cpu --steps 5
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-4b \
        --smoke --steps 50                    # the current GPU

It prints the last logged steps' metrics and ``steps= restarts=``.  Meshes
(``--mesh``) and several pods (``--multi-pod``) need the multi-device
backend, which the port does not have yet: both raise.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> dict:
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
    args = ap.parse_args(argv)
    if args.mesh or args.multi_pod:
        raise NotImplementedError(
            "--mesh / --multi-pod: sharded training needs the multi-device "
            "torch.distributed backend, which the port does not have yet")

    from ..configs import get
    from ..training import AdamWConfig, DataConfig, TrainConfig, Trainer

    cfg_m = get(args.arch)
    if args.smoke:
        cfg_m = cfg_m.reduced()
    tc = TrainConfig(
        model=cfg_m,
        opt=AdamWConfig(lr=3e-4, warmup_steps=min(20, args.steps // 5 + 1),
                        total_steps=args.steps),
        data=DataConfig(vocab_size=cfg_m.vocab_size, seq_len=args.seq,
                        global_batch=args.batch),
        n_steps=args.steps, checkpoint_dir=args.ckpt_dir)
    report = Trainer(tc, device=args.device).run()
    for h in report["logged"][-5:]:
        print(h)
    print(f"steps={report['steps']} restarts={report['restarts']}")
    return report


if __name__ == "__main__":
    main()
