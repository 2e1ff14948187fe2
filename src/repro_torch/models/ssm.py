"""Linear-recurrence blocks: the xLSTM pair (mLSTM, sLSTM) and the
Mamba-style SSD head of hymba (input-dependent decay, the conv stub folded
into the projections, ``cfg.ssm.state_dim`` of state per head).

The mLSTM and the SSD head share one engine, decayed linear attention,

    S_t = a_t S_{t-1} + k_t v_t^T ,   y_t = q_t . S_t ,

which the scan kernel K5 (``kernels/ssm_scan``) computes where the
reference runs its chunked jnp twin of that kernel.  The mLSTM folds its
exponential input gate into k and gets its normaliser from a ones column
appended to v (a state of hd x (hd + 1)).  The sLSTM is a nonlinear
recurrence with a scalar memory per feature; the kernel K6
(``kernels/slstm``) runs its time loop on the device, where the reference
scans ``_slstm_step`` over time.

Where a graph is built (training), their sites go through ``SSMScan`` and
``SLSTMScan``.  K5 has no backward: ``SSMScan`` runs the kernel's forward
and a backward that recomputes the output through the twin the
reference's gradient goes through (``decayed_linear_attention``, the
chunked form, in chunks of ``cfg.ssm.chunk``) and differentiates it.  K6
has one: ``SLSTMScan``'s forward keeps the state after every step, and its
backward is K6's backward kernel (``kernels/slstm``), the reverse of the
reference's scan of ``_slstm_step``.

Decode runs one step of each recurrence in plain tensor code, as the
reference's does: ``decayed_linear_attention_step`` (the SSD head),
``mlstm_decode`` and ``slstm_decode``, whose step is K6's plain version's
(``kernels/slstm/ref.py::slstm_step``).  Neither K5 nor K6 is launched for
one token: a single step has no time loop to keep on the device.  The
states carry one row a request of the batch, with one length a row.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.autograd.function import once_differentiable

from ..kernels.slstm import slstm_scan, slstm_scan_bwd_cuda, slstm_scan_cuda
from ..kernels.slstm.ref import slstm_step
from ..kernels.ssm_scan import ssm_scan
from .layers import Linear, dtype_of


def _heads(x: torch.Tensor, h: int, hd: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, h, hd).transpose(1, 2)        # (B, h, S, hd) view


class SSMState(NamedTuple):
    S: torch.Tensor        # (B, H, DK, DV) fp32 matrix memory
    n: torch.Tensor        # (B, H, DK) fp32 normaliser
    length: torch.Tensor   # (B,) int64: tokens seen, per row


def init_ssm_state(batch: int, heads: int, dk: int, dv: int,
                   device=None) -> SSMState:
    return SSMState(
        torch.zeros((batch, heads, dk, dv), dtype=torch.float32,
                    device=device),
        torch.zeros((batch, heads, dk), dtype=torch.float32, device=device),
        torch.zeros((batch,), dtype=torch.long, device=device))


class SLSTMState(NamedTuple):
    c: torch.Tensor        # (B, H*hd) cell
    n: torch.Tensor        # (B, H*hd) normaliser
    m: torch.Tensor        # (B, H*hd) stabiliser (log-space max), from 0


def init_slstm_state(batch: int, width: int, device=None) -> SLSTMState:
    z = torch.zeros((batch, width), dtype=torch.float32, device=device)
    return SLSTMState(z, z.clone(), z.clone())


def decayed_linear_attention(q, k, v, log_a, *, chunk: int = 256):
    """Chunked decayed linear attention, the reference's twin of K5:
    q, k (B, H, S, DK); v (B, H, S, DV); log_a (B, H, S) <= 0.  Within a
    chunk of ``chunk`` rows (halved until it divides S) the decayed scores
    are a masked (C, C) product; across chunks the fp32 state is carried
    forward one chunk at a time.  Returns (y in q's type, the final state
    (B, H, DK, DV) fp32)."""
    b, h, s, dk = q.shape
    dv = v.shape[-1]
    c = min(chunk, s)
    while s % c != 0:
        c //= 2
    n = s // c
    f32 = torch.float32
    qc = q.reshape(b, h, n, c, dk).to(f32)
    kc = k.reshape(b, h, n, c, dk).to(f32)
    vc = v.reshape(b, h, n, c, dv).to(f32)
    A = torch.cumsum(log_a.reshape(b, h, n, c).to(f32), dim=-1)  # inclusive
    total = A[..., -1]                                           # (B,H,N)
    idx = torch.arange(c, device=q.device)
    tri = idx[:, None] >= idx[None, :]

    # intra-chunk; the mask goes in before the exponential: above the
    # diagonal exp(rel) can overflow, and its gradient (0 * inf) would not
    # vanish where the mask is applied after it
    rel = A[..., :, None] - A[..., None, :]                      # (B,H,N,C,C)
    dec = torch.exp(torch.where(tri, rel, float("-inf")))
    scores = torch.einsum("bhncd,bhnld->bhncl", qc, kc) * dec
    y_intra = torch.einsum("bhncl,bhnlv->bhncv", scores, vc)

    # inter-chunk: each chunk's state contribution, then the states carried
    k_dec = kc * torch.exp(total[..., None, None] - A[..., None])
    chunk_state = torch.einsum("bhncd,bhncv->bhndv", k_dec, vc)
    S = torch.zeros((b, h, dk, dv), dtype=f32, device=q.device)
    prevs = []
    for i in range(n):
        prevs.append(S)                                  # the state *before*
        S = (S * torch.exp(total[..., i])[..., None, None]
             + chunk_state[:, :, i])
    S_prevs = torch.stack(prevs, dim=2)                  # (B,H,N,DK,DV)

    q_dec = qc * torch.exp(A[..., None])
    y_inter = torch.einsum("bhncd,bhndv->bhncv", q_dec, S_prevs)
    y = (y_intra + y_inter).reshape(b, h, s, dv)
    return y.to(q.dtype), S


class SSMScan(torch.autograd.Function):
    """K5 with a gradient: the kernel's forward; a backward that recomputes
    the output through :func:`decayed_linear_attention` in chunks of
    ``chunk`` and differentiates it.  Only the inputs are saved."""

    @staticmethod
    def forward(ctx, q, k, v, log_a, chunk: int):
        ctx.save_for_backward(q, k, v, log_a)
        ctx.chunk = chunk
        return ssm_scan(q, k, v, log_a)

    @staticmethod
    def backward(ctx, grad_y):
        ins = tuple(t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            y, _ = decayed_linear_attention(*ins, chunk=ctx.chunk)
            grads = torch.autograd.grad(y, ins, grad_y)
        return (*grads, None)


class SLSTMScan(torch.autograd.Function):
    """K6 with a gradient: the kernel's forward, which also keeps the state
    (c, n, m) after every step, and K6's backward kernel on those states.
    CPU tensors take the plain versions of both
    (``slstm_scan_states_ref``, ``slstm_scan_bwd_ref``); neither device
    differentiates a loop."""

    @staticmethod
    def forward(ctx, z, i, f, o):
        y, c, n, m = slstm_scan_cuda(z, i, f, o, states=True)
        ctx.save_for_backward(z, i, f, o, c, n, m)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_y):
        return slstm_scan_bwd_cuda(*ctx.saved_tensors, grad_y.contiguous())


def _builds_graph(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def ssm_scan_site(q, k, v, log_a, *, chunk: int):
    """K5 at the model's site: the wrapper as it is where no graph is built,
    else through :class:`SSMScan`."""
    if _builds_graph(q, k, v, log_a):
        return SSMScan.apply(q, k, v, log_a, chunk)
    return ssm_scan(q, k, v, log_a)


def slstm_scan_site(z, i, f, o):
    """K6 at the model's site: the wrapper as it is where no graph is built,
    else through :class:`SLSTMScan`."""
    if _builds_graph(z, i, f, o):
        return SLSTMScan.apply(z, i, f, o)
    return slstm_scan(z, i, f, o)


def _chunk(cfg) -> int:
    """The twin's chunk: ``cfg.ssm.chunk``, as the reference takes it."""
    return cfg.ssm.chunk if cfg.ssm else 256


def decayed_linear_attention_step(q, k, v, log_a, state):
    """One decode step.  q, k: (B, H, DK); v: (B, H, DV); log_a: (B, H);
    state: (B, H, DK, DV) fp32.  Returns (y in q's type, new_state)."""
    a = torch.exp(log_a.to(torch.float32))[..., None, None]
    state = state * a + (k.to(torch.float32)[..., :, None]
                         * v.to(torch.float32)[..., None, :])
    y = torch.einsum("bhd,bhdv->bhv", q.to(torch.float32), state)
    return y.to(q.dtype), state


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
    y = ssm_scan_site(Cm, Bm, v, log_a, chunk=_chunk(cfg))
    y = y.transpose(1, 2).reshape(b, s, h * hd)
    return p.wo(y)


def ssd_decode(p: SSD, cfg, x: torch.Tensor, state: SSMState):
    """One token of the SSD head: x (B, 1, D) -> (out (B, 1, D), state)."""
    h = cfg.ssm.n_ssm_heads or cfg.n_heads
    st, hd = cfg.ssm.state_dim, cfg.hd
    b = x.shape[0]
    Bm = p.wB(x)[:, 0].reshape(b, h, st)
    Cm = p.wC(x)[:, 0].reshape(b, h, st)
    v = p.wx(x)[:, 0].reshape(b, h, hd)
    log_a = -F.softplus(p.wdt(x)[:, 0].to(torch.float32))
    y, S = decayed_linear_attention_step(Cm, Bm, v, log_a, state.S)
    out = p.wo(y.reshape(b, h * hd).to(x.dtype))[:, None, :]
    return out, SSMState(S, state.n, state.length + 1)


# ---------------------------------------------------------------------------
# mLSTM block (xLSTM)
# ---------------------------------------------------------------------------


class MLSTM(nn.Module):
    """wq, wk, wv, wo_gate and wo in the model's type; the forget and input
    gates wf, wi (one a head) in fp32."""

    def __init__(self, cfg, *, device=None, generator=None):
        super().__init__()
        d, h, hd = cfg.d_model, cfg.n_heads, cfg.hd
        dt = dtype_of(cfg.dtype)
        kw = dict(device=device, generator=generator)
        self.wq = Linear(d, h * hd, dt, **kw)
        self.wk = Linear(d, h * hd, dt, **kw)
        self.wv = Linear(d, h * hd, dt, **kw)
        self.wf = Linear(d, h, torch.float32, **kw)
        self.wi = Linear(d, h, torch.float32, **kw)
        self.wo_gate = Linear(d, h * hd, dt, **kw)
        self.wo = Linear(h * hd, d, dt, **kw)


def mlstm_train(p: MLSTM, cfg, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence mLSTM: x (B, S, D) -> (B, S, D).  K5 scans in chunks
    of its own (64 rows) where the reference takes ``cfg.ssm.chunk`` (as
    the backward's twin does): only the order of the sums differs."""
    h, hd = cfg.n_heads, cfg.hd
    b, s, _ = x.shape
    q = _heads(p.wq(x), h, hd) * hd ** -0.5
    k = _heads(p.wk(x), h, hd) * hd ** -0.5
    v = _heads(p.wv(x), h, hd)
    log_f = F.logsigmoid(p.wf(x).to(torch.float32)).transpose(1, 2)
    log_i = F.logsigmoid(p.wi(x).to(torch.float32)).transpose(1, 2)
    k = k * torch.exp(log_i).to(k.dtype)[..., None]   # fold the input gate
    # the normaliser through a ones column: y_aug[..., hd] = q . n
    v_aug = torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)
    y_aug = ssm_scan_site(q, k, v_aug, log_f, chunk=_chunk(cfg))
    y, denom = y_aug[..., :hd], y_aug[..., hd:]
    y = y / torch.clamp(denom.abs(), min=1.0)
    o_gate = torch.sigmoid(p.wo_gate(x))
    y = y.transpose(1, 2).reshape(b, s, h * hd) * o_gate
    return p.wo(y)


def mlstm_decode(p: MLSTM, cfg, x: torch.Tensor, state: SSMState):
    """One token of the mLSTM: x (B, 1, D) -> (out (B, 1, D), state)."""
    h, hd = cfg.n_heads, cfg.hd
    b = x.shape[0]
    q = p.wq(x)[:, 0].reshape(b, h, hd) * hd ** -0.5
    k = p.wk(x)[:, 0].reshape(b, h, hd) * hd ** -0.5
    v = p.wv(x)[:, 0].reshape(b, h, hd)
    log_f = F.logsigmoid(p.wf(x)[:, 0].to(torch.float32))
    log_i = F.logsigmoid(p.wi(x)[:, 0].to(torch.float32))
    k = k * torch.exp(log_i).to(k.dtype)[..., None]
    a = torch.exp(log_f)[..., None, None]
    kf, qf = k.to(torch.float32), q.to(torch.float32)
    S = state.S * a + kf[..., :, None] * v.to(torch.float32)[..., None, :]
    n = state.n * a[..., 0] + kf
    num = torch.einsum("bhd,bhdv->bhv", qf, S)
    den = torch.einsum("bhd,bhd->bh", qf, n)
    y = num / torch.clamp(den.abs(), min=1.0)[..., None]
    o_gate = torch.sigmoid(p.wo_gate(x)[:, 0])
    y = (y.reshape(b, h * hd) * o_gate.to(torch.float32)).to(x.dtype)
    return p.wo(y)[:, None, :], SSMState(S, n, state.length + 1)


# ---------------------------------------------------------------------------
# sLSTM block (xLSTM)
# ---------------------------------------------------------------------------


class SLSTM(nn.Module):
    """wz (the cell input) in the model's type; the gates wi, wf, wog in
    fp32; wo."""

    def __init__(self, cfg, *, device=None, generator=None):
        super().__init__()
        d, width = cfg.d_model, cfg.n_heads * cfg.hd
        dt = dtype_of(cfg.dtype)
        kw = dict(device=device, generator=generator)
        self.wz = Linear(d, width, dt, **kw)
        self.wi = Linear(d, width, torch.float32, **kw)
        self.wf = Linear(d, width, torch.float32, **kw)
        self.wog = Linear(d, width, torch.float32, **kw)
        self.wo = Linear(width, d, dt, **kw)


def slstm_train(p: SLSTM, cfg, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence sLSTM: x (B, S, D) -> (B, S, D).  The four
    pre-activations in fp32 go through K6; its fp32 output is cast to the
    model's type, as the reference casts its scan's output."""
    z = p.wz(x).to(torch.float32)
    i = p.wi(x).to(torch.float32)
    f = p.wf(x).to(torch.float32)
    o = p.wog(x).to(torch.float32)
    y = slstm_scan_site(z, i, f, o)
    return p.wo(y.to(x.dtype))


def slstm_decode(p: SLSTM, cfg, x: torch.Tensor, state: SLSTMState):
    """One token of the sLSTM: x (B, 1, D) -> (out (B, 1, D), state)."""
    z = p.wz(x)[:, 0].to(torch.float32)
    i = p.wi(x)[:, 0].to(torch.float32)
    f = p.wf(x)[:, 0].to(torch.float32)
    o = p.wog(x)[:, 0].to(torch.float32)
    c, n, m, y = slstm_step(state.c, state.n, state.m, z, i, f, o)
    return p.wo(y.to(x.dtype))[:, None, :], SLSTMState(c, n, m)
