"""Batched serving example: initialise a small model and generate
continuations for a batch of prompts through the decode engine — including
a recurrent (xLSTM) architecture whose "KV cache" is O(1) state — then
replay a synthetic request trace through the continuous-batching
scheduler on the simulated clock, comparing FIFO against model-guided
packing.

    PYTHONPATH=src python -m repro_torch.examples.serve_batched \
        [--arch xlstm-350m] [--device cpu]

The weights are drawn from seed 0 (``torch.Generator``) on the device; the
replay is host arithmetic.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..configs import get
from ..models import build_model
from ..serving import (Engine, ServeConfig, TraceConfig, compare_policies,
                       cost_model_for, synthesize_trace)
from . import add_device_argument, device_for


def generate(model, net, prompts: torch.Tensor, new_tokens: int = 16):
    """``prompts`` (B, S) continued by ``new_tokens`` greedy tokens each
    through ``Engine.generate`` over ``net`` (drawn here, or carried
    across from the reference's parameters)."""
    engine = Engine(model, net, ServeConfig(max_new_tokens=new_tokens,
                                            max_cache_len=128))
    return engine.generate(prompts)


def replay_demo():
    """Trace replay: same trace, same cost model, two policies."""
    cfg = get("qwen1.5-4b").reduced()
    trace = synthesize_trace(TraceConfig(n_requests=500, seed=0,
                                         arrival_rate=4.5))
    reports = compare_policies(trace, cost_model_for(cfg),
                               step_budget_s=0.06)
    print(f"trace replay ({len(trace)} requests, simulated clock):")
    for name, rep in reports.items():
        print(f"  {name:>5}: goodput={rep.goodput_rps:.2f} req/s  "
              f"p95 TTFT={rep.ttft_p95_s:.2f}s  "
              f"p95 TPOT={rep.tpot_p95_s * 1e3:.1f}ms  "
              f"SLO met={rep.slo_met_fraction:.0%}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="xlstm-350m")
    ap.add_argument("--new-tokens", type=int, default=16)
    add_device_argument(ap)
    args = ap.parse_args(argv)
    device = device_for(args.device)

    cfg = get(args.arch).reduced(n_layers=4, d_model=128, n_heads=4,
                                 vocab=512)
    model = build_model(cfg)
    net = model.init(seed=0, device=device)

    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(rng.integers(0, 512, size=(4, 8)),
                              dtype=torch.int64, device=device)
    out = generate(model, net, prompts, args.new_tokens)
    print(f"arch={cfg.name} ({cfg.block_pattern}); "
          f"prompts {tuple(prompts.shape)} -> {tuple(out.shape)}")
    for i, row in enumerate(out.cpu().numpy()):
        print(f"  [{i}] prompt={row[:8].tolist()} -> gen={row[8:].tolist()}")
    replay_demo()
    return out


if __name__ == "__main__":
    main()
