"""Prefill launcher: the full-sequence forward of a batch of prompts and
the last position's logits, the serving prefill output.

    PYTHONPATH=src python -m repro_torch.launch.prefill --arch hymba-1.5b \
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.prefill --arch whisper-tiny \
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.prefill --arch starcoder2-3b \
        --batch 4 --prompt-len 4096           # the current GPU, full width

Whisper (encdec) also takes the frame embeddings of its stubbed audio
frontend, and the VLM the patch embeddings of its stubbed image frontend;
``main`` draws them from the seed (:func:`stub_inputs`).  It prints each
row's argmax token and the wall time of the call.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..configs import get
from ..distributed import process_group as pg
from ..distributed.sharding import seq_tp
from ..models import Model, build_model
from ..models.encdec import encdec_forward_train
from ..models.layers import dtype_of
from ..models.transformer import decoder_forward_train, lm_logits


def stub_shapes(cfg) -> Dict[str, tuple]:
    """The stubbed frontends' inputs an architecture takes besides its
    tokens, each as (tokens, D) of one batch row: ``frames`` for encdec,
    ``images`` for vlm, none otherwise."""
    if cfg.block_pattern == "encdec":
        return {"frames": (cfg.encoder.n_frames, cfg.d_model)}
    if cfg.block_pattern == "vlm":
        return {"images": (cfg.vision.n_image_tokens, cfg.d_model)}
    return {}


def stub_inputs(cfg, batch: int, *, seed: int = 0,
                device=None) -> Dict[str, torch.Tensor]:
    """The stub inputs of :func:`stub_shapes` for ``batch`` rows, drawn as
    the reference's tests draw them: ``default_rng(seed).standard_normal
    * 0.1``, in the model's type."""
    rng = np.random.default_rng(seed)
    return {name: torch.from_numpy(
                rng.standard_normal((batch,) + shape) * 0.1).to(
                    device=device, dtype=dtype_of(cfg.dtype))
            for name, shape in stub_shapes(cfg).items()}


def make_prefill_step(model: Model):
    """``prefill_step(net, tokens, frames=None, images=None)``: tokens
    (B, S) int, and the stub inputs the architecture takes -> the last
    position's logits (B, 1, V), no gradient kept.  Under a mesh whose
    rules cut the sequence over ``model`` (``seq_sp``) every rank returns
    that position's logits, as without a mesh."""
    cfg = model.cfg
    needs = set(stub_shapes(cfg))

    @torch.inference_mode()
    def prefill_step(net, tokens: torch.Tensor, *,
                     frames: Optional[torch.Tensor] = None,
                     images: Optional[torch.Tensor] = None) -> torch.Tensor:
        batch = {k: v for k, v in (("frames", frames), ("images", images))
                 if v is not None}
        if set(batch) != needs:
            raise ValueError(f"{cfg.name} takes the stub inputs "
                             f"{sorted(needs)}, got {sorted(batch)}")
        if cfg.block_pattern == "encdec":
            hidden, _ = encdec_forward_train(net, cfg, frames, tokens)
        else:
            hidden, _ = decoder_forward_train(
                net, cfg, tokens, memory=model.encode_memory(net, batch))
        last = hidden[:, -1:, :]
        sp = seq_tp(tokens.shape[1])
        if sp is not None:
            # the hidden states are the rank's rows of the sequence: its
            # last position is the last model rank's last row
            last = pg.all_gather(last, sp.group, dim=1)[:, -1:]
        return lm_logits(net, cfg, last)

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
    stubs = stub_inputs(cfg, args.batch, seed=0, device=device)
    step = make_prefill_step(model)
    t0 = time.perf_counter()
    logits = step(net, tokens, **stubs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    for i, tok in enumerate(logits[:, -1].argmax(-1).tolist()):
        print(f"[{i}] next token {tok}")
    print(f"prefill {cfg.name} B={args.batch} S={args.prompt_len} on "
          f"{device}: {wall:.4f} s")


if __name__ == "__main__":
    main()
