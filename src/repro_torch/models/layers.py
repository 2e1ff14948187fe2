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
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

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
        w = self.w
        if x.dtype != w.dtype:
            dt = torch.promote_types(x.dtype, w.dtype)
            x, w = x.to(dt), w.to(dt)
        y = torch.matmul(x, w)
        if self.b is not None:
            y = y + self.b
        return y


class RMSNorm(nn.Module):
    """x * rsqrt(mean(x^2) + eps) * scale, computed in fp32 and cast back."""

    def __init__(self, d: int, dtype, *, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.scale = _param((d,), dtype, device, None, fill=1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + self.eps)
        return (y * self.scale.to(torch.float32)).to(x.dtype)


class Embedding(nn.Module):
    """A (vocab, d) table, rows picked by token id."""

    def __init__(self, vocab: int, d: int, dtype, *, device=None,
                 generator=None):
        super().__init__()
        self.w = _param((vocab, d), dtype, device, generator, 0.02)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.w[tokens.long()]


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


ACTIVATIONS = {"silu": F.silu, "gelu": gelu, "relu": F.relu}


class MLP(nn.Module):
    """down(act(gate(x)) * up(x)) when gated, else down(act(up(x)))."""

    def __init__(self, d: int, d_ff: int, dtype, gated: bool,
                 activation: str = "silu", *, device=None, generator=None):
        super().__init__()
        self.act = ACTIVATIONS[activation]
        kw = dict(device=device, generator=generator)
        self.up = Linear(d, d_ff, dtype, **kw)
        self.down = Linear(d_ff, d, dtype, **kw)
        self.gate = Linear(d, d_ff, dtype, **kw) if gated else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.up(x)
        if self.gate is not None:
            h = h * self.act(self.gate(x))
        else:
            h = self.act(h)
        return self.down(h)


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
