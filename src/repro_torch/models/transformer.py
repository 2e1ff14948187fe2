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
scan over stacked layers and no remat (the forward half keeps no
activations).
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from .attention import Attention, attention_train, cross_attention
from .layers import MLP, Embedding, Linear, RMSNorm, _param, dtype_of
from .moe import MoE, moe_block
from .ssm import MLSTM, SLSTM, SSD, mlstm_train, slstm_train, ssd_train

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


def apply_layer_train(p: Layer, cfg, kind: str, x, positions, memory=None):
    """Returns (x, aux_loss).  ``memory`` (B, M, D) is what a cross layer
    attends to."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    window = cfg.sliding_window
    if kind in ("dense", "vlm_self", "moe"):
        x = x + attention_train(p.attn, cfg, p.norm1(x), positions,
                                causal=True, window=window)
        h2 = p.norm2(x)
        if kind == "moe":
            y, aux = moe_block(p.moe, cfg, h2)
        else:
            y = p.mlp(h2)
        x = x + y
    elif kind == "mlstm":
        x = x + mlstm_train(p.mlstm, cfg, p.norm1(x))
    elif kind == "slstm":
        x = x + slstm_train(p.slstm, cfg, p.norm1(x))
    elif kind == "hymba":
        h2 = p.norm1(x)
        attn_out = attention_train(p.attn, cfg, h2, positions, causal=True,
                                   window=window)
        ssd_out = ssd_train(p.ssd, cfg, h2)
        x = x + 0.5 * (attn_out + ssd_out)         # hymba head fusion (mean)
        x = x + p.mlp(p.norm2(x))
    elif kind == "cross":
        if memory is None:
            raise ValueError("a cross layer needs the memory it attends to")
        x = x + cross_attention(p.cross, cfg, p.norm1(x), memory)
        x = x + p.mlp(p.norm2(x))
    else:
        raise ValueError(f"unknown block kind {kind!r}")
    return x, aux


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
    load-balance losses summed."""
    x = net.embed(tokens)
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    if net.pos_table is not None:
        x = x + net.pos_table[:s][None]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for kind, layer in zip(net.kinds, net.layers):
        x, a = apply_layer_train(layer, cfg, kind, x, positions, memory)
        aux = aux + a
    return net.final_norm(x), aux


def lm_logits(net: Decoder, cfg, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x, net.embed.w)
    return net.lm_head(x)
