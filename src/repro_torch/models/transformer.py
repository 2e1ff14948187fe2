"""Decoder-only LM assembly for the full-sequence forward path.

Block kinds (the reference's ``init_layer`` / ``apply_layer_train``):
  dense     — GQA attention + (gated) MLP              [starcoder2, granite,
              qwen1.5-4b/110b]
  moe       — GQA attention + MoE FFN (+ shared / dense residual)
              [arctic, qwen2-moe]
  mlstm, slstm — the alternating xLSTM pair, no FFN    [xlstm]
  hymba     — parallel attention + SSD heads (their mean), then MLP  [hymba]
  vlm_self, cross — dense blocks, and every ``vision.cross_attn_every``-th
              layer a cross-attention block over the image memory
              [llama-vision]

Whisper's encoder-decoder lives in ``encdec.py`` and reuses these blocks.
The layers are one ``nn.ModuleList`` in order and run in a Python loop: no
scan over stacked layers.  With ``cfg.remat``, where a graph is built, each
unit of ``stack_plan`` (the layers the reference's scan steps over at once)
runs under ``torch.utils.checkpoint`` and is recomputed in the backward, as
the reference checkpoints each unit.  The decode caches are a list with one
dict a layer, in the same order (``init_decode_cache``), where the
reference stacks them per layer group.

Under a mesh (``distributed/sharding.py``, ``Model.shard``) the dense
blocks' attention and MLP run tensor-parallel where their leaves are cut on
whole heads or on ``d_ff`` columns; every other leaf cut over ``model`` is
gathered where it is used, inside the remat unit, so the recompute gathers
it again.  Under the ``seq_sp`` rules (``sharding.seq_tp``) the residual
stream between blocks is the rank's rows of the sequence (Megatron-SP):
the norms run on the rows, each block on the whole sequence.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, List

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..distributed import process_group as pg
from ..distributed.sharding import (on_sequence, placed, seq_rows, seq_tp,
                                    vocab_block)
from .attention import (Attention, attention_decode, attention_train,
                        cross_attention, init_kv_cache)
from .layers import (REMAT, MLP, Embedding, Linear, RMSNorm, _param,
                     dtype_of, promoted_matmul)
from .moe import MoE, moe_block
from .ssm import (MLSTM, SLSTM, SSD, init_slstm_state, init_ssm_state,
                  mlstm_decode, mlstm_train, slstm_decode, slstm_train,
                  ssd_decode, ssd_train)

KINDS = ("dense", "vlm_self", "moe", "mlstm", "slstm", "hymba", "cross")


# ---------------------------------------------------------------------------
# per-layer init / apply
# ---------------------------------------------------------------------------


class Layer(nn.Module):
    """One block of ``kind`` (the reference's ``init_layer``): norm1 and
    the mixer (attn, + ssd for hymba; mlstm; slstm; cross), then norm2 and
    the FFN (mlp, or moe) where the kind has one."""

    def __init__(self, cfg, kind: str, *, device=None, generator=None):
        super().__init__()
        if kind not in KINDS:
            raise ValueError(f"unknown block kind {kind!r}")
        dt = dtype_of(cfg.dtype)
        d = cfg.d_model
        kw = dict(device=device, generator=generator)
        self.norm1 = RMSNorm(d, dt, eps=cfg.norm_eps, device=device)
        if kind == "mlstm":
            self.mlstm = MLSTM(cfg, **kw)
            return
        if kind == "slstm":
            self.slstm = SLSTM(cfg, **kw)
            return
        if kind == "cross":
            self.cross = Attention(cfg, **kw)
        else:
            self.attn = Attention(cfg, **kw)
        if kind == "hymba":
            self.ssd = SSD(cfg, **kw)
        self.norm2 = RMSNorm(d, dt, eps=cfg.norm_eps, device=device)
        if kind == "moe":
            self.moe = MoE(cfg, **kw)
        else:
            self.mlp = MLP(d, cfg.d_ff, dt, cfg.gated_mlp, cfg.activation,
                           **kw)


def apply_layer_train(p: Layer, cfg, kind: str, x, positions, memory=None,
                      sp=None):
    """Returns (x, aux_loss).  ``memory`` (B, M, D) is what a cross layer
    attends to.  ``sp`` (``sharding.seq_tp``): ``x`` is the rank's rows of
    a sequence cut over ``model`` (``seq_sp``), ``positions`` the whole
    sequence's; the norms and the residual adds run on the rows, every
    block on the whole sequence (``sharding.on_sequence``)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind in ("dense", "vlm_self", "moe", "hymba"):
        attend = partial(attention_train, p.attn, cfg, positions=positions,
                         causal=True, window=cfg.sliding_window)
    if kind in ("dense", "vlm_self", "moe"):
        x = x + on_sequence(attend, p.norm1(x, sp), sp, p.attn.tp)
        h2 = p.norm2(x, sp)
        if kind == "moe":
            # the routing groups whole: the MoE on the gathered sequence
            y, aux = on_sequence(partial(moe_block, p.moe, cfg), h2, sp)
        else:
            y = on_sequence(p.mlp, h2, sp, p.mlp.tp)
        x = x + y
    elif kind == "mlstm":
        x = x + on_sequence(partial(mlstm_train, p.mlstm, cfg),
                            p.norm1(x, sp), sp, p.mlstm.tp)
    elif kind == "slstm":
        x = x + on_sequence(partial(slstm_train, p.slstm, cfg),
                            p.norm1(x, sp), sp, p.slstm.tp)
    elif kind == "hymba":
        h2 = p.norm1(x, sp)
        attn_out = on_sequence(attend, h2, sp, p.attn.tp)
        ssd_out = on_sequence(partial(ssd_train, p.ssd, cfg), h2, sp,
                              p.ssd.tp)
        x = x + 0.5 * (attn_out + ssd_out)         # hymba head fusion (mean)
        x = x + on_sequence(p.mlp, p.norm2(x, sp), sp, p.mlp.tp)
    elif kind == "cross":
        if memory is None:
            raise ValueError("a cross layer needs the memory it attends to")
        x = x + on_sequence(partial(cross_attention, p.cross, cfg,
                                    memory=memory), p.norm1(x, sp), sp,
                            p.cross.tp)
        x = x + on_sequence(p.mlp, p.norm2(x, sp), sp, p.mlp.tp)
    else:
        raise ValueError(f"unknown block kind {kind!r}")
    return x, aux


def apply_layer_decode(p: Layer, cfg, kind: str, x, cache: Dict,
                       memory=None):
    """x: (B, s1, D) (s1 > 1 only for attention-shaped kinds).  Returns
    (x, new_cache)."""
    if kind in ("dense", "vlm_self", "moe"):
        h, cache_kv = attention_decode(p.attn, cfg, p.norm1(x), cache["kv"])
        x = x + h
        h2 = p.norm2(x)
        if kind == "moe":
            y, _ = moe_block(p.moe, cfg, h2, with_aux=False)
        else:
            y = p.mlp(h2)
        return x + y, {**cache, "kv": cache_kv}
    if kind == "mlstm":
        h, st = mlstm_decode(p.mlstm, cfg, p.norm1(x), cache["ssm"])
        return x + h, {**cache, "ssm": st}
    if kind == "slstm":
        h, st = slstm_decode(p.slstm, cfg, p.norm1(x), cache["sl"])
        return x + h, {**cache, "sl": st}
    if kind == "hymba":
        h2 = p.norm1(x)
        a, cache_kv = attention_decode(p.attn, cfg, h2, cache["kv"])
        s, st = ssd_decode(p.ssd, cfg, h2, cache["ssm"])
        x = x + 0.5 * (a + s)
        x = x + p.mlp(p.norm2(x))
        return x, {**cache, "kv": cache_kv, "ssm": st}
    if kind == "cross":
        if memory is None:
            raise ValueError("a cross layer needs the memory it attends to")
        x = x + cross_attention(p.cross, cfg, p.norm1(x), memory)
        x = x + p.mlp(p.norm2(x))
        return x, cache
    raise ValueError(f"unknown block kind {kind!r}")


# ---------------------------------------------------------------------------
# layer-stack plans
# ---------------------------------------------------------------------------


def stack_plan(cfg):
    """The reference's layer grouping: a list of (name, n_repeats,
    inner_kinds), the unit ``inner_kinds`` repeated ``n_repeats`` times.
    The port runs the units' layers in order (``layer_kinds``)."""
    if cfg.block_pattern == "dense":
        return [("unit", cfg.n_layers, ("dense",))]
    if cfg.block_pattern == "moe":
        return [("unit", cfg.n_layers, ("moe",))]
    if cfg.block_pattern == "mlstm_slstm":
        if cfg.n_layers % 2:
            raise ValueError("mlstm_slstm needs an even layer count")
        return [("unit", cfg.n_layers // 2, ("mlstm", "slstm"))]
    if cfg.block_pattern == "hymba":
        return [("unit", cfg.n_layers, ("hymba",))]
    if cfg.block_pattern == "vlm":
        e = cfg.vision.cross_attn_every
        if cfg.n_layers % e:
            raise ValueError("vlm needs n_layers % cross_attn_every == 0")
        return [("unit", cfg.n_layers // e,
                 tuple(["vlm_self"] * (e - 1) + ["cross"]))]
    raise ValueError(f"no decoder stack plan for block pattern "
                     f"{cfg.block_pattern!r} (encdec: models/encdec.py)")


def layer_kinds(cfg) -> List[str]:
    """The kind of every layer, in the order the port runs them."""
    return [kind for _, n, kinds in stack_plan(cfg) for _ in range(n)
            for kind in kinds]


class Decoder(nn.Module):
    """Embeddings (+ a learned position table when ``cfg.positions`` is
    "learned"), the layers in order, the final norm and the LM head."""

    def __init__(self, cfg, *, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        self.kinds = layer_kinds(cfg)
        dt = dtype_of(cfg.dtype)
        kw = dict(device=device, generator=generator)
        self.embed = Embedding(cfg.vocab_size, cfg.d_model, dt, **kw)
        self.final_norm = RMSNorm(cfg.d_model, dt, eps=cfg.norm_eps,
                                  device=device)
        self.lm_head = (None if cfg.tie_embeddings else
                        Linear(cfg.d_model, cfg.vocab_size, dt, **kw))
        self.pos_table = (_param((cfg.max_position, cfg.d_model), dt, device,
                                 generator, 0.01)
                          if cfg.positions == "learned" else None)
        self.layers = nn.ModuleList(Layer(cfg, kind, **kw)
                                    for kind in self.kinds)


def decoder_forward_train(net: Decoder, cfg, tokens: torch.Tensor, *,
                          memory=None):
    """tokens: (B, S) int; memory: (B, M, D), what the cross layers attend
    to.  Returns (hidden after the final norm, aux), aux the MoE layers'
    load-balance losses summed.  Where the active rules cut the sequence
    over ``model`` (``sharding.seq_tp``), the hidden states are the rank's
    rows of the sequence."""
    x = net.embed(tokens)
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    if net.pos_table is not None:
        x = x + placed(net.pos_table)[:s][None]
    sp = seq_tp(s)
    if sp is not None:
        # embedded whole (the tables' gradients whole on every rank), the
        # residual stream the rank's rows
        x = seq_rows(x, sp)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if not (cfg.remat and torch.is_grad_enabled()):
        # layer by layer: each layer's input is freed as the next one runs
        for kind, layer in zip(net.kinds, net.layers):
            x, a = apply_layer_train(layer, cfg, kind, x, positions, memory,
                                     sp)
            aux = aux + a
        return net.final_norm(x, sp), aux
    start = 0
    for _, n, kinds in stack_plan(cfg):
        for _ in range(n):
            unit = net.layers[start:start + len(kinds)]
            start += len(kinds)
            x, a = checkpoint(_unit_train, unit, cfg, kinds, x, positions,
                              memory, sp, **REMAT)
            aux = aux + a
    return net.final_norm(x, sp), aux


def _unit_train(unit, cfg, kinds, x, positions, memory, sp=None):
    """The layers of one ``stack_plan`` unit in order: (x, their aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for kind, layer in zip(kinds, unit):
        x, a = apply_layer_train(layer, cfg, kind, x, positions, memory, sp)
        aux = aux + a
    return x, aux


def lm_head_weight(net: Decoder, cfg, rows=None) -> torch.Tensor:
    """The weight the logits take: the tied embeddings (V, D) or the LM
    head's (D, V), whole (gathered over ``model`` under a mesh).  ``rows``
    (``sharding.seq_tp``): the logits are taken of the rank's rows, and
    the weight's gradient is summed over ``model``."""
    return placed(net.embed.w if cfg.tie_embeddings else net.lm_head.w,
                  rows)


def lm_logits(net: Decoder, cfg, x: torch.Tensor, weight=None
              ) -> torch.Tensor:
    """The logits of ``x``; ``weight`` is :func:`lm_head_weight`'s, taken
    once for several calls (the loss's chunks).  Where no graph is built
    and the LM head's weight is a vocabulary block of a mesh, each rank
    gives its share of the logits and the ranks gather them, where that
    moves fewer bytes than gathering the weight (fewer rows than
    ``d_model``: a decode step, the prefill's last position)."""
    if weight is None:
        vb = vocab_block(net.embed.w if cfg.tie_embeddings
                         else net.lm_head.w)
        if vb is not None and x.shape[:-1].numel() < cfg.d_model:
            w, tp, _ = vb
            return pg.all_gather(_logits(cfg, x, w), tp.group, dim=-1)
    w = lm_head_weight(net, cfg) if weight is None else weight
    return _logits(cfg, x, w)


def _logits(cfg, x, w):
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x, w)
    return promoted_matmul(x, w)


# ---------------------------------------------------------------------------
# decode path
# ---------------------------------------------------------------------------


def init_decode_cache(cfg, batch: int, max_len: int, device=None
                      ) -> List[Dict]:
    """One cache dict a layer, in ``layer_kinds`` order: "kv" (a KV ring
    of ``min(max_len, window)`` slots with a window, else ``max_len``) for
    the attention kinds, "ssm" for hymba's SSD head and the mLSTM, "sl"
    for the sLSTM; a cross layer keeps nothing."""
    dt = dtype_of(cfg.dtype)
    kv_len = (min(max_len, cfg.sliding_window) if cfg.sliding_window
              else max_len)
    caches = []
    for kind in layer_kinds(cfg):
        c = {}
        if kind in ("dense", "vlm_self", "moe", "hymba"):
            c["kv"] = init_kv_cache(batch, cfg.n_kv_heads, kv_len, cfg.hd,
                                    dt, device)
        if kind == "hymba":
            h = cfg.ssm.n_ssm_heads or cfg.n_heads
            c["ssm"] = init_ssm_state(batch, h, cfg.ssm.state_dim, cfg.hd,
                                      device)
        if kind == "mlstm":
            c["ssm"] = init_ssm_state(batch, cfg.n_heads, cfg.hd, cfg.hd,
                                      device)
        if kind == "slstm":
            c["sl"] = init_slstm_state(batch, cfg.n_heads * cfg.hd, device)
        caches.append(c)
    return caches


def caches_length(caches) -> torch.Tensor:
    """Each row's decode position, (B,), from the first cache that counts
    its tokens (a KV cache or an SSM state); a scalar 0 when none does."""
    for c in caches:
        for key in ("kv", "ssm"):
            if key in c:
                return c[key].length
    return torch.zeros((), dtype=torch.long)


def position_rows(table: torch.Tensor, pos: torch.Tensor, s1: int
                  ) -> torch.Tensor:
    """Rows ``pos .. pos + s1`` of a learned position table, per batch row:
    (B, s1, D).  The start is clamped to ``[0, len(table) - s1]``, as the
    reference's ``dynamic_slice`` clamps it."""
    pos = torch.as_tensor(pos, device=table.device).reshape(-1)
    start = torch.clamp(pos, min=0, max=max(table.shape[0] - s1, 0))
    return table[start[:, None] + torch.arange(s1, device=table.device)]


def decoder_decode_step(net: Decoder, cfg, tokens: torch.Tensor, caches,
                        *, memory=None):
    """tokens: (B, s1), one new token or a chunked-prefill chunk a row.
    Returns (logits (B, s1, V), new_caches)."""
    x = net.embed(tokens)
    if net.pos_table is not None:
        x = x + position_rows(placed(net.pos_table), caches_length(caches),
                              tokens.shape[1])
    new_caches = []
    for kind, layer, c in zip(net.kinds, net.layers, caches):
        x, nc = apply_layer_decode(layer, cfg, kind, x, c, memory)
        new_caches.append(nc)
    return lm_logits(net, cfg, net.final_norm(x)), new_caches
