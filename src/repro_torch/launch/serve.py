"""Serving launcher: batched generation (greedy by default) through
``serving.Engine`` against a reduced or full-width model with weights drawn
from a seed.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-3b \
        --batch 4 --prompt-len 512 --new-tokens 32     # the current GPU

Whisper (encdec) and the VLM take the stub frame / image embeddings of
:func:`launch.prefill.stub_inputs`, drawn from the seed.  It prints each
row's tokens and the wall time of the call.  Checkpoints come with the
training slice of the port: ``--ckpt-dir`` raises until then.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get
from ..models import build_model
from ..serving import Engine, ServeConfig
from .prefill import stub_inputs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config (fp32, 2 narrow layers)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current GPU)")
    ap.add_argument("--ckpt-dir", default=None)
    args = ap.parse_args(argv)
    if args.ckpt_dir:
        raise NotImplementedError(
            "--ckpt-dir: checkpoints come with the training slice of the "
            "port, which is not ported yet")

    cfg = get(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    model = build_model(cfg)
    net = model.init(0, device=args.device)
    device = net.embed.w.device
    engine = Engine(model, net, ServeConfig(
        max_new_tokens=args.new_tokens,
        max_cache_len=args.prompt_len + args.new_tokens + 8))
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len))).to(device)
    stubs = stub_inputs(cfg, args.batch, seed=0, device=device)
    t0 = time.perf_counter()
    out = engine.generate(prompts, batch_inputs=stubs or None)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    for i, row in enumerate(out.tolist()):
        print(f"[{i}] {row}")
    print(f"serve {cfg.name} B={args.batch} S={args.prompt_len} "
          f"new={args.new_tokens} on {device}: {wall:.4f} s")


if __name__ == "__main__":
    main()
