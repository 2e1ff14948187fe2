"""The Mamba-style SSD head of hymba: input-dependent decay, the conv stub
folded into the projections, ``cfg.ssm.state_dim`` of state per head.

Its engine is decayed linear attention,

    S_t = a_t S_{t-1} + k_t v_t^T ,   y_t = q_t . S_t ,

which the scan kernel K5 (``kernels/ssm_scan``) computes where the
reference runs its chunked jnp twin of that kernel.  The xLSTM blocks
(mLSTM, sLSTM) and the one-step decode functions belong to later slices of
the port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.ssm_scan import ssm_scan
from .layers import Linear, dtype_of


def _heads(x: torch.Tensor, h: int, hd: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, h, hd).transpose(1, 2)        # (B, h, S, hd) view


class SSD(nn.Module):
    """wB (input -> state, k-like), wC (state -> output, q-like), wx (the
    value path), wdt (the decay gate, fp32) and wo."""

    def __init__(self, cfg, *, device=None, generator=None):
        super().__init__()
        d = cfg.d_model
        h = cfg.ssm.n_ssm_heads or cfg.n_heads
        st = cfg.ssm.state_dim
        hd = cfg.hd
        dt = dtype_of(cfg.dtype)
        kw = dict(device=device, generator=generator)
        self.wB = Linear(d, h * st, dt, **kw)
        self.wC = Linear(d, h * st, dt, **kw)
        self.wx = Linear(d, h * hd, dt, **kw)
        self.wdt = Linear(d, h, torch.float32, **kw)
        self.wo = Linear(h * hd, d, dt, **kw)


def ssd_train(p: SSD, cfg, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence SSD head: x (B, S, D) -> (B, S, D)."""
    h = cfg.ssm.n_ssm_heads or cfg.n_heads
    st, hd = cfg.ssm.state_dim, cfg.hd
    b, s, _ = x.shape
    Bm = _heads(p.wB(x), h, st)
    Cm = _heads(p.wC(x), h, st)
    v = _heads(p.wx(x), h, hd)
    log_a = -F.softplus(p.wdt(x).to(torch.float32)).transpose(1, 2)
    y = ssm_scan(Cm, Bm, v, log_a)
    y = y.transpose(1, 2).reshape(b, s, h * hd)
    return p.wo(y)
