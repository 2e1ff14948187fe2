"""End-to-end training driver: train a ~100M-parameter qwen-family model
for a few hundred steps on synthetic structured data, with checkpointing,
straggler monitoring and (optional) injected faults.

    PYTHONPATH=src python -m repro_torch.examples.train_e2e --steps 300 \
        [--arch qwen1.5-4b]
    PYTHONPATH=src python -m repro_torch.examples.train_e2e --steps 50 \
        --smoke [--device cpu]

The weights are drawn from seed 0 (``torch.Generator``) on the device.
Checkpoints go to ``--ckpt-dir`` every ``max(50, steps // 4)`` steps and at
the end; a run that finds a checkpoint there resumes from it, and one that
finds the last step's runs no step.  The default directory is one for each
architecture and size under the port's root (:func:`default_ckpt_dir`),
so that the reduced model never meets the 100M one's checkpoint.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

from .. import paths
from ..configs import get
from ..training import (AdamWConfig, DataConfig, FaultInjector, TrainConfig,
                        Trainer)
from . import add_device_argument, device_for


def build_100m(arch: str):
    """A ~100M-param member of the chosen architecture family."""
    cfg = get(arch)
    return dataclasses.replace(
        cfg, n_layers=8, d_model=512, n_heads=8,
        n_kv_heads=min(cfg.n_kv_heads, 8) if cfg.n_kv_heads < cfg.n_heads else 8,
        head_dim=64, d_ff=0 if cfg.d_ff == 0 else 2048,
        vocab_size=32768, dtype="float32", remat=False, max_position=0,
        sliding_window=256 if cfg.sliding_window else 0, logits_chunk=0)


def default_ckpt_dir(arch: str, smoke: bool) -> str:
    """``<root>/ckpt_torch/train_e2e/<arch>-{smoke,100m}``, resolved when
    it is asked for."""
    return os.path.join(paths.ckpt_dir(), "train_e2e",
                        f"{arch}-{'smoke' if smoke else '100m'}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen1.5-4b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny config for CI")
    ap.add_argument("--inject-fault-at", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: default_ckpt_dir(arch, smoke)")
    add_device_argument(ap)
    args = ap.parse_args(argv)
    device = device_for(args.device)
    ckpt_dir = args.ckpt_dir or default_ckpt_dir(args.arch, args.smoke)

    cfg_m = get(args.arch).reduced() if args.smoke else build_100m(args.arch)
    n_params_est = cfg_m.param_count()
    print(f"arch={cfg_m.name} ~{n_params_est/1e6:.0f}M params, "
          f"{args.steps} steps, batch {args.batch} x seq {args.seq}")

    tc = TrainConfig(
        model=cfg_m,
        opt=AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=args.steps),
        data=DataConfig(vocab_size=cfg_m.vocab_size, seq_len=args.seq,
                        global_batch=args.batch),
        n_steps=args.steps, checkpoint_dir=ckpt_dir,
        checkpoint_every=max(50, args.steps // 4), log_every=10)
    trainer = Trainer(tc, device=device)
    injector = (FaultInjector(fail_at_steps=(args.inject_fault_at,))
                if args.inject_fault_at else None)
    report = trainer.run(injector)

    print(f"\ndone: {report['steps']} steps, {report['restarts']} restarts, "
          f"{len(report['straggler_events'])} straggler events")
    if not report["history"]:
        print(f"no step run: the checkpoint under {ckpt_dir} is at step "
              f"{report['steps']} (--ckpt-dir elsewhere trains afresh)")
        return report
    # a resumed run may log no step of its own
    logged = report["logged"] or report["history"]
    for h in logged[:: max(1, len(logged) // 10)]:
        print(f"  step {h['step']:4d} loss {h['loss']:.4f} "
              f"lr {h['lr']:.2e} gnorm {h['grad_norm']:.3f}")
    first, last = logged[0]["loss"], logged[-1]["loss"]
    print(f"loss: {first:.4f} -> {last:.4f} "
          f"({'LEARNING' if last < first - 0.2 else 'check config'})")
    return report


if __name__ == "__main__":
    main()
