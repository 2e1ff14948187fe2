"""Shared layer primitives as ``nn.Module``s: the parameters of each module
carry the reference's names (``w``, ``b``, ``scale``) and layouts (a linear
weight is ``(d_in, d_out)``), so a reference parameter tree loads without
renaming or transposing (``models/convert.py``).

A module given a ``torch.Generator`` draws its parameters from the
reference's distributions (normal(0, 1/sqrt(d_in)) linear weights, zero
biases, unit norm scales, normal(0, 0.02) embeddings); given none it leaves
them uninitialised, for a state dict to be loaded.  Parameters are
trainable (``requires_grad``, PyTorch's default); the paths that must build
no graph (prefill, serving, decode) run under ``torch.inference_mode()``.

Under a mesh (``distributed/sharding.py``) a parameter may hold only this
rank's block: ``Linear`` and ``Embedding`` gather a ``"gather"`` block where
they use it (an ``Embedding`` that builds no graph for fewer tokens than
its rows looks up its own rows instead, summed over ``model``), and an
``MLP`` whose ``tp`` is set runs tensor-parallel, its ``up`` / ``gate``
cut by columns and ``down`` by rows.  Under a sequence cut over ``model``
(``seq_sp``) a norm takes the rank's rows, and a tensor-parallel MLP
takes and gives them (``seq_enter``, ``seq_exit``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..distributed import process_group as pg
from ..distributed.sharding import (block_enter, block_exit, placed,
                                    vocab_block)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}
#: ``torch.utils.checkpoint`` arguments of the rematerialised blocks: the
#: non-reentrant form, and no RNG state stashed, since the forward draws no
#: random numbers
REMAT = dict(use_reentrant=False, preserve_rng_state=False)


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def _param(shape, dtype, device, generator: Optional[torch.Generator],
           std: float = 0.0, fill: Optional[float] = None) -> nn.Parameter:
    """A parameter drawn as normal(0, std) in fp32 then cast (the
    reference's order), or filled with ``fill``, or left empty when there
    is no generator.  The fp32 draw is scaled in place, so a bank of
    experts holds one fp32 copy at a time on its way to the model's
    type."""
    if fill is not None:
        t = torch.full(shape, fill, dtype=dtype, device=device)
    elif generator is None:
        t = torch.empty(shape, dtype=dtype, device=device)
    else:
        t = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32).mul_(std).to(dtype)
    return nn.Parameter(t)


class Linear(nn.Module):
    """y = x @ w (+ b); w is (d_in, d_out).  Operands of two types are
    promoted to the wider one, as the reference's einsum promotes them."""

    def __init__(self, d_in: int, d_out: int, dtype, *, bias: bool = False,
                 device=None, generator=None):
        super().__init__()
        self.w = _param((d_in, d_out), dtype, device, generator,
                        1.0 / math.sqrt(d_in))
        self.b = (_param((d_out,), dtype, device, generator, fill=0.0)
                  if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = promoted_matmul(x, placed(self.w))
        if self.b is not None:
            y = y + placed(self.b)
        return y


def promoted_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w, operands of two types promoted to the wider one."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return torch.matmul(x, w)


class RMSNorm(nn.Module):
    """x * rsqrt(mean(x^2) + eps) * scale, computed in fp32 and cast back."""

    def __init__(self, d: int, dtype, *, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.scale = _param((d,), dtype, device, None, fill=1.0)

    def forward(self, x: torch.Tensor, rows=None) -> torch.Tensor:
        """``rows``: ``x`` is the rank's rows of a sequence cut over
        ``model`` (``sharding.seq_tp``); the scale's gradient is summed."""
        xf = x.to(torch.float32)
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + self.eps)
        return (y * placed(self.scale, rows).to(torch.float32)).to(x.dtype)


class Embedding(nn.Module):
    """A (vocab, d) table, rows picked by token id."""

    def __init__(self, vocab: int, d: int, dtype, *, device=None,
                 generator=None):
        super().__init__()
        self.w = _param((vocab, d), dtype, device, generator, 0.02)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        vb = vocab_block(self.w)
        if vb is not None and tokens.numel() < self.w.shape[0] * vb[1].size:
            # fewer looked-up rows than the table: each rank looks up the
            # tokens its rows hold (zeros elsewhere) and the ranks add
            w, tp, _ = vb
            n = w.shape[0]
            local = tokens.long() - tp.index * n
            hit = (local >= 0) & (local < n)
            rows = w[local.clamp(0, n - 1)] * hit[..., None].to(w.dtype)
            return pg.all_reduce(rows, tp.group)
        return placed(self.w)[tokens.long()]


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


ACTIVATIONS = {"silu": F.silu, "gelu": gelu, "relu": F.relu}


class MLP(nn.Module):
    """down(act(gate(x)) * up(x)) when gated, else down(act(up(x))).  With
    ``tp`` (a ``sharding.TP``) the rank holds the columns of ``up`` /
    ``gate`` and the rows of ``down`` of its share of ``d_ff``, and the
    partial outputs are summed over the ``model`` ranks."""

    tp = None

    def __init__(self, d: int, d_ff: int, dtype, gated: bool,
                 activation: str = "silu", *, device=None, generator=None):
        super().__init__()
        self.act = ACTIVATIONS[activation]
        kw = dict(device=device, generator=generator)
        self.up = Linear(d, d_ff, dtype, **kw)
        self.down = Linear(d_ff, d, dtype, **kw)
        self.gate = Linear(d, d_ff, dtype, **kw) if gated else None

    def forward(self, x: torch.Tensor, sp=None) -> torch.Tensor:
        """``sp`` (``sharding.seq_tp``, a tensor-parallel MLP's, through
        ``sharding.on_sequence``): ``x`` and the output are the rank's rows
        of a sequence cut over ``model``; the MLP runs on the whole
        sequence, between ``seq_enter`` and ``seq_exit``."""
        x = block_enter(x, self.tp, sp)
        h = self.up(x)
        if self.gate is not None:
            h = h * self.act(self.gate(x))
        else:
            h = self.act(h)
        return block_exit(self.down(h), self.tp, sp)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------


def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S).  The two halves of the head
    dim rotate as pairs (not interleaved), in fp32."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                   # (hd/2,)
    angles = positions[..., None].to(torch.float32) * freqs   # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                     # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
