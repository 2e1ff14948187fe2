"""Decoder-only LM assembly for the full-sequence forward path.

Block kinds ported so far:
  dense  — GQA attention + (gated) MLP                 [starcoder2, granite,
           qwen1.5-4b/110b]
  hymba  — parallel attention + SSD heads (their mean), then MLP  [hymba]

The layers are one ``nn.ModuleList`` in order and run in a Python loop: no
scan over stacked layers and no remat (the forward half keeps no
activations).  The other kinds raise ``NotImplementedError`` naming the
slice of the port that brings them.
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from .attention import Attention, attention_train
from .layers import MLP, Embedding, Linear, RMSNorm, dtype_of
from .ssm import SSD, ssd_train

#: the slice of the port that brings each kind not ported yet
LATER = {
    "moe": "the MoE slice (models/moe.py)",
    "mlstm": "the xLSTM slice (mLSTM needs K5 at a 256x257 state)",
    "slstm": "the xLSTM slice (sLSTM)",
    "vlm_self": "the VLM cross-attention slice",
    "cross": "the VLM cross-attention slice",
    "encdec": "the encoder-decoder slice (models/encdec.py)",
}


def _not_ported(kind: str) -> NotImplementedError:
    return NotImplementedError(
        f"block kind {kind!r} is not ported yet; it comes with {LATER[kind]}")


# ---------------------------------------------------------------------------
# per-layer init / apply
# ---------------------------------------------------------------------------


class Layer(nn.Module):
    """One block (the reference's ``init_layer``): norm1 and attn (+ ssd for
    hymba), norm2 and mlp."""

    def __init__(self, cfg, kind: str, *, device=None, generator=None):
        super().__init__()
        if kind not in ("dense", "hymba"):
            raise _not_ported(kind)
        dt = dtype_of(cfg.dtype)
        d = cfg.d_model
        kw = dict(device=device, generator=generator)
        self.norm1 = RMSNorm(d, dt, eps=cfg.norm_eps, device=device)
        self.attn = Attention(cfg, **kw)
        if kind == "hymba":
            self.ssd = SSD(cfg, **kw)
        self.norm2 = RMSNorm(d, dt, eps=cfg.norm_eps, device=device)
        self.mlp = MLP(d, cfg.d_ff, dt, cfg.gated_mlp, cfg.activation, **kw)


def apply_layer_train(p: Layer, cfg, kind: str, x, positions):
    """Returns (x, aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    window = cfg.sliding_window
    if kind == "dense":
        x = x + attention_train(p.attn, cfg, p.norm1(x), positions,
                                causal=True, window=window)
        x = x + p.mlp(p.norm2(x))
    elif kind == "hymba":
        h2 = p.norm1(x)
        attn_out = attention_train(p.attn, cfg, h2, positions, causal=True,
                                   window=window)
        ssd_out = ssd_train(p.ssd, cfg, h2)
        x = x + 0.5 * (attn_out + ssd_out)         # hymba head fusion (mean)
        x = x + p.mlp(p.norm2(x))
    else:
        raise _not_ported(kind)
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
    if cfg.block_pattern == "encdec":
        raise _not_ported("encdec")
    raise ValueError(cfg.block_pattern)


def layer_kinds(cfg) -> List[str]:
    """The kind of every layer, in the order the port runs them."""
    return [kind for _, n, kinds in stack_plan(cfg) for _ in range(n)
            for kind in kinds]


class Decoder(nn.Module):
    """Embeddings, the layers in order, the final norm and the LM head.
    (Learned positions belong to the encoder-decoder, not ported yet.)"""

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
        self.layers = nn.ModuleList(Layer(cfg, kind, **kw)
                                    for kind in self.kinds)


def decoder_forward_train(net: Decoder, cfg, tokens: torch.Tensor):
    """tokens: (B, S) int.  Returns (hidden after the final norm, aux)."""
    x = net.embed(tokens)
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for kind, layer in zip(net.kinds, net.layers):
        x, a = apply_layer_train(layer, cfg, kind, x, positions)
        aux = aux + a
    return net.final_norm(x), aux


def lm_logits(net: Decoder, cfg, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x, net.embed.w)
    return net.lm_head(x)
