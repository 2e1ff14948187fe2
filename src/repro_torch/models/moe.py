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
XLA outside any Pallas kernel.  Returns the Switch-style
load-balance loss beside the output.

Under a mesh (``distributed/sharding.py``) the banks are laid out as the
reference's partitioner lays them out under its ``baseline`` rules, where
every ``model`` rank holds the same tokens (``batch`` is ``("pod",
"data")``).  The routing runs whole on every rank (the router is not cut:
the top-k, the running count and the kept mask are the same everywhere).
Where the experts divide ``model`` (:func:`ep_works`, mode ``"ep"``) the
rank forms the dispatch tensor's slice of its own experts and runs them;
the combine over those experts is a partial sum, added over ``model``.
Where they do not, the banks are cut on the experts' ``ff`` dimension
(mode ``"tp"``, Megatron inside every expert), and the dispatch and
combine one-hots are cut on the routing group's tokens, as the
reference's ``tok_constrain`` asks where that dimension divides
``model``: the rank builds its tokens' rows, the dispatched tokens are
the sum of every rank's rows, and the outputs' rows are gathered back.
No bank is gathered over ``model``.  The load-balance statistics (the
routed share and the mean router probability of each expert) are the
same on every ``model`` rank and averaged over the batch ranks, so that
the loss is the reference's over the whole batch.  No all-to-all arises:
that takes tokens cut over ``model``, which ``baseline`` never does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ..distributed.sharding import (active, batch_mean, placed, tp_enter,
                                    tp_exit, tp_gather)
from .layers import ACTIVATIONS, MLP, Linear, _param, dtype_of

#: tokens per routing group: fixes the dispatch tensors' size per token
#: independent of the sequence length
GROUP_SIZE = 2048


class MoE(nn.Module):
    """The router (fp32), the expert banks ``w_up``, ``w_down`` and (gated)
    ``w_gate`` as (E, d_in, d_out) parameters, and the optional ``shared``
    and ``dense`` MLPs.  Under a mesh ``tp`` (a ``sharding.TP``) and
    ``mode`` (``"ep"``: the rank holds experts ``[i E/m, (i+1) E/m)``;
    ``"tp"``: every expert's ``ff`` columns ``[i F/m, (i+1) F/m)``) are
    set where the banks are cut over ``model``."""

    tp = None
    mode = None

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


def ep_works(cfg) -> bool:
    """The reference's test of the active mesh: the experts divide the mesh
    axis of the ``experts`` rule (True without a mesh)."""
    ctx = active()
    if ctx is None:
        return True
    mesh, rules = ctx
    ax = rules.get("experts")
    return bool(ax) and ax in mesh.shape and cfg.moe.n_experts % mesh.shape[ax] == 0


def _token_cut(cfg, s: int, tp) -> bool:
    """The reference's ``tok_constrain``: where the experts do not divide
    ``model``, the one-hots' token dimension goes over ``model`` (its
    ``kv_seq`` rule), where that divides the group's ``s`` tokens."""
    return not ep_works(cfg) and s % tp.size == 0


def moe_block(p: MoE, cfg, x: torch.Tensor, *, with_aux: bool = True):
    """x: (B, S, D) -> (out (B, S, D), aux_loss fp32 scalar; 0 without
    ``with_aux``, which decode takes)."""
    m = cfg.moe
    act = ACTIVATIONS[cfg.activation]
    bsz, seq, d = x.shape
    gs = group_size(seq)
    x = x.reshape(bsz * (seq // gs), gs, d)
    r = route(p, cfg, x)
    cap = capacity(cfg, gs)
    tp = p.tp

    # dispatch / combine tensors (G, s, E, C); a dropped (token, k) has no
    # slot (pos >= C gives an all-zero one-hot row).  Under a mesh the
    # rank's slice: its experts ("ep") or its tokens (the token cut); the
    # gates' and the tokens' gradients from that slice are partial, and
    # tp_enter adds them over the ranks
    onehot, keep, pos, gates, xin = r.onehot, r.keep, r.pos, r.gate_vals, x
    cut = tp is not None and p.mode == "tp" and _token_cut(cfg, gs, tp)
    if tp is not None:
        gates, xin = tp_enter(gates, tp), tp_enter(x, tp)
    if tp is not None and p.mode == "ep":
        n = m.n_experts // tp.size
        onehot = onehot[..., tp.index * n:(tp.index + 1) * n]
    elif cut:
        n = gs // tp.size
        rows = slice(tp.index * n, (tp.index + 1) * n)
        onehot, keep, pos = onehot[:, rows], keep[:, rows], pos[:, rows]
        gates, xin = gates[:, rows], xin[:, rows]
    pos_oh = (pos[..., None] == torch.arange(
        cap, device=x.device, dtype=torch.float32)).to(torch.float32)
    dispatch = torch.einsum("bske,bskc->bsec", onehot * keep[..., None],
                            pos_oh)
    combine = torch.einsum("bske,bskc->bsec", onehot * gates[..., None],
                           pos_oh)

    xe = torch.einsum("bsec,bsd->becd", dispatch.to(x.dtype), xin)
    if cut:
        # every rank's tokens dispatched: the sum over model, whose
        # gradient (partial over ff) is summed back
        xe = tp_enter(tp_exit(xe, tp), tp)                        # (G,E,C,D)
    h = torch.einsum("becd,edf->becf", xe, placed(p.w_up))
    if p.w_gate is not None:
        h = h * act(torch.einsum("becd,edf->becf", xe, placed(p.w_gate)))
    else:
        h = act(h)
    ye = torch.einsum("becf,efd->becd", h, placed(p.w_down))       # (G,E,C,D)
    if cut:
        # the ff partial sums added; their gradient, partial over the
        # rank's tokens, added back
        ye = tp_enter(tp_exit(ye, tp), tp)
    y = torch.einsum("bsec,becd->bsd", combine.to(x.dtype), ye)
    if cut:
        y = tp_gather(y, tp, 1)
    elif tp is not None:
        y = tp_exit(y, tp)

    if p.shared is not None:
        y = y + p.shared(x)
    if p.dense is not None:
        y = y + p.dense(x)

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if with_aux:
        # Switch-style load-balance loss: E * sum_e f_e * P_e
        f = batch_mean(torch.mean(r.onehot.sum(2), dim=(0, 1)))  # routed
        pmean = batch_mean(torch.mean(r.probs, dim=(0, 1)))
        aux = m.n_experts * torch.sum(f * pmean) * m.router_aux_weight
    return y.reshape(bsz, seq, d), aux
