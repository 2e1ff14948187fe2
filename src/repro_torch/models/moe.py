"""Mixture-of-experts block: a top-k router with capacity-based dispatch
(the Mesh-TF / GShard formulation) over a bank of experts.

Two flavours, as in the reference:
* arctic-480b:  128 routed experts, top-2, and a parallel *dense residual*
                MLP added to every token;
* qwen2-moe:    60 routed experts, top-4, and always-on shared experts.

The tokens are regrouped into routing groups of ``GROUP_SIZE`` (halved
until it divides the sequence), so the capacity and the dispatch one-hots do
not grow with the sequence.  The routing keeps the reference's order of
operations (softmax, top-k, renormalisation, the running count over the
``(s, k)``-flattened one-hots), so the same tokens are dropped.  The
products are ``torch.einsum`` contractions, which the reference leaves to
XLA outside any Pallas kernel.  The reference's sharding constraints have
no effect on one device and are dropped.  Returns the Switch-style
load-balance loss beside the output.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import ACTIVATIONS, MLP, Linear, _param, dtype_of

#: tokens per routing group: fixes the dispatch tensors' size per token
#: independent of the sequence length
GROUP_SIZE = 2048


class MoE(nn.Module):
    """The router (fp32), the expert banks ``w_up``, ``w_down`` and (gated)
    ``w_gate`` as (E, d_in, d_out) parameters, and the optional ``shared``
    and ``dense`` MLPs."""

    def __init__(self, cfg, *, device=None, generator=None):
        super().__init__()
        m, d = cfg.moe, cfg.d_model
        dt = dtype_of(cfg.dtype)
        kw = dict(device=device, generator=generator)

        def bank(d_in, d_out):
            return _param((m.n_experts, d_in, d_out), dt, device, generator,
                          d_in ** -0.5)

        self.router = Linear(d, m.n_experts, torch.float32, **kw)
        self.w_up = bank(d, m.d_ff_expert)
        self.w_down = bank(m.d_ff_expert, d)
        self.w_gate = bank(d, m.d_ff_expert) if cfg.gated_mlp else None
        self.shared = (MLP(d, m.d_ff_shared, dt, cfg.gated_mlp,
                           cfg.activation, **kw) if m.d_ff_shared else None)
        self.dense = (MLP(d, m.d_ff_dense or cfg.d_ff, dt, cfg.gated_mlp,
                          cfg.activation, **kw) if m.dense_residual else None)


class Routing(NamedTuple):
    """The router's decision for (G, s) groups of tokens."""
    probs: torch.Tensor      # (G, s, E) fp32 softmax of the router logits
    gate_idx: torch.Tensor   # (G, s, K) the top-k experts
    gate_vals: torch.Tensor  # (G, s, K) renormalised gates, 0 where dropped
    keep: torch.Tensor       # (G, s, K) bool: within the expert's capacity
    onehot: torch.Tensor     # (G, s, K, E) fp32 one-hots of gate_idx
    pos: torch.Tensor        # (G, s, K) fp32 slot in the expert's buffer


def group_size(seq: int) -> int:
    """Tokens per routing group for a sequence of ``seq``."""
    gs = min(GROUP_SIZE, seq)
    while seq % gs != 0:
        gs //= 2
    return gs


def capacity(cfg, s: int) -> int:
    """Slots per expert in a group of ``s`` tokens."""
    m = cfg.moe
    return max(1, int(s * m.top_k * m.capacity_factor / m.n_experts))


def route(p: MoE, cfg, x: torch.Tensor) -> Routing:
    """x: (G, s, D) routing groups -> the router's :class:`Routing`."""
    m = cfg.moe
    b, s, _ = x.shape
    e = m.n_experts
    probs = torch.softmax(p.router(x.to(torch.float32)), dim=-1)
    gate_vals, gate_idx = torch.topk(probs, m.top_k, dim=-1)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    # position of each (token, k) within its expert's capacity buffer
    onehot = F.one_hot(gate_idx, e).to(torch.float32)          # (G,s,K,E)
    flat = onehot.reshape(b, s * m.top_k, e)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(b, s, m.top_k, e)
    pos = torch.einsum("bske,bske->bsk", pos, onehot)
    keep = pos < capacity(cfg, s)
    return Routing(probs, gate_idx, gate_vals * keep, keep, onehot, pos)


def moe_block(p: MoE, cfg, x: torch.Tensor):
    """x: (B, S, D) -> (out (B, S, D), aux_loss fp32 scalar)."""
    m = cfg.moe
    act = ACTIVATIONS[cfg.activation]
    bsz, seq, d = x.shape
    gs = group_size(seq)
    x = x.reshape(bsz * (seq // gs), gs, d)
    r = route(p, cfg, x)
    cap = capacity(cfg, gs)

    # dispatch / combine tensors (G, s, E, C); a dropped (token, k) has no
    # slot (pos >= C gives an all-zero one-hot row)
    pos_oh = (r.pos[..., None] == torch.arange(
        cap, device=x.device, dtype=torch.float32)).to(torch.float32)
    dispatch = torch.einsum("bske,bskc->bsec", r.onehot * r.keep[..., None],
                            pos_oh)
    combine = torch.einsum("bske,bskc->bsec",
                           r.onehot * r.gate_vals[..., None], pos_oh)

    xe = torch.einsum("bsec,bsd->becd", dispatch.to(x.dtype), x)  # (G,E,C,D)
    h = torch.einsum("becd,edf->becf", xe, p.w_up)
    if p.w_gate is not None:
        h = h * act(torch.einsum("becd,edf->becf", xe, p.w_gate))
    else:
        h = act(h)
    ye = torch.einsum("becf,efd->becd", h, p.w_down)               # (G,E,C,D)
    y = torch.einsum("bsec,becd->bsd", combine.to(x.dtype), ye)

    if p.shared is not None:
        y = y + p.shared(x)
    if p.dense is not None:
        y = y + p.dense(x)

    # Switch-style load-balance loss: E * sum_e f_e * P_e
    f = torch.mean(r.onehot.sum(2), dim=(0, 1))                 # routed share
    pmean = torch.mean(r.probs, dim=(0, 1))
    aux = m.n_experts * torch.sum(f * pmean) * m.router_aux_weight
    return y.reshape(bsz, seq, d), aux
