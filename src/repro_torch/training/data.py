"""Deterministic, stateless, elastically resumable data pipeline.

The batch at step ``t`` is a pure function of (seed, t), so the data cursor
in a checkpoint is the step integer: a resumed run draws the same batches.

Two sources, as in the reference:
* ``synthetic``: structured pseudo-text (Zipf unigrams and the bigram rule
  ``t -> (31 t + 7) mod V`` at half the positions), so that a model can
  learn something with no files.  The rule is the reference's; the draw is
  the port's own: a CPU ``torch.Generator`` seeded with (seed, step), so the
  same batch on every device (the reference draws with its framework's
  counter-based generator, which the port does not reproduce).
* ``bytes``: byte-level tokens from a repeated corpus buffer, drawn with
  numpy exactly as the reference draws them.

Batches are int32 tensors on the CPU; the trainer moves them to its device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    kind: str = "synthetic"          # synthetic | bytes
    corpus: Optional[bytes] = None


def _generator(seed: int, step: int) -> torch.Generator:
    return torch.Generator().manual_seed((seed << 32) + step)


def _affine_powers(n: int, v: int):
    """(a_k, b_k) for k = 0..n-1 with f^k(t) = (a_k t + b_k) mod v, f the
    bigram rule t -> (31 t + 7) mod v."""
    a, b = np.ones(n, np.int64), np.zeros(n, np.int64)
    for k in range(1, n):
        a[k] = a[k - 1] * 31 % v
        b[k] = (b[k - 1] * 31 + 7) % v
    return torch.from_numpy(a), torch.from_numpy(b)


def synthetic_batch(cfg: DataConfig, step: int) -> Dict[str, torch.Tensor]:
    """With probability 1/2, tokens[t+1] = (31 tokens[t] + 7) mod V (a
    learnable bigram rule on the observable history); otherwise a fresh
    Zipf draw, P(rank r) proportional to 1/r."""
    gen = _generator(cfg.seed, step)
    b, s, v = cfg.global_batch, cfg.seq_len, cfg.vocab_size
    zipf = 1.0 / torch.arange(1, v + 1, dtype=torch.float64)
    fresh = torch.multinomial(zipf, b * (s + 1), replacement=True,
                              generator=gen).reshape(b, s + 1)
    mix = torch.rand((b, s + 1), generator=gen) < 0.5
    # the scan t -> where(mix, f(t), fresh) in closed form: each position
    # is f applied (t - r) times to the fresh draw at the last position r
    # that took a fresh draw (position 0 always does)
    pos = torch.arange(s + 1).expand(b, s + 1)
    reset = ~mix
    reset[:, 0] = True
    last = torch.cummax(torch.where(reset, pos, 0), dim=1).values
    a, c = _affine_powers(s + 1, v)
    k = pos - last
    tokens = (a[k] * torch.gather(fresh, 1, last) + c[k]) % v
    tokens = tokens.to(torch.int32)
    return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


def bytes_batch(cfg: DataConfig, step: int) -> Dict[str, torch.Tensor]:
    corpus = np.frombuffer(cfg.corpus, dtype=np.uint8)
    b, s = cfg.global_batch, cfg.seq_len
    n = corpus.size
    rng = np.random.default_rng(cfg.seed + step)
    starts = rng.integers(0, max(n - s - 1, 1), size=b)
    idx = starts[:, None] + np.arange(s + 1)[None]
    chunk = corpus[idx % n].astype(np.int32)
    return {"tokens": torch.from_numpy(chunk[:, :-1].copy()),
            "labels": torch.from_numpy(chunk[:, 1:].copy())}


class DataPipeline:
    """Step-indexed batch source with a checkpointable cursor."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._fn = {"synthetic": synthetic_batch, "bytes": bytes_batch}[cfg.kind]

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        return self._fn(self.cfg, step)

    def cursor(self, step: int) -> dict:
        return {"step": int(step), "seed": self.cfg.seed, "kind": self.cfg.kind}
