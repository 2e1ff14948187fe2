"""Prefill launcher: the full-sequence forward of a batch of prompts and
the last position's logits, the serving prefill output.

    PYTHONPATH=src python -m repro_torch.launch.prefill --arch hymba-1.5b \
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.prefill --arch starcoder2-3b \
        --batch 4 --prompt-len 4096           # the current GPU, full width

It prints each row's argmax token and the wall time of the call.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get
from ..models import Model, build_model
from ..models.transformer import Decoder, decoder_forward_train, lm_logits


def make_prefill_step(model: Model):
    """``prefill_step(net, tokens)``: tokens (B, S) int -> the last
    position's logits (B, 1, V), no gradient kept."""
    cfg = model.cfg

    @torch.inference_mode()
    def prefill_step(net: Decoder, tokens: torch.Tensor) -> torch.Tensor:
        hidden, _ = decoder_forward_train(net, cfg, tokens)
        return lm_logits(net, cfg, hidden[:, -1:, :])

    return prefill_step


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config (fp32, 2 narrow layers)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current GPU)")
    args = ap.parse_args(argv)

    cfg = get(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    model = build_model(cfg)
    net = model.init(0, device=args.device)
    device = net.embed.w.device
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len))).to(device)
    step = make_prefill_step(model)
    t0 = time.perf_counter()
    logits = step(net, tokens)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    for i, tok in enumerate(logits[:, -1].argmax(-1).tolist()):
        print(f"[{i}] next token {tok}")
    print(f"prefill {cfg.name} B={args.batch} S={args.prompt_len} on "
          f"{device}: {wall:.4f} s")


if __name__ == "__main__":
    main()
