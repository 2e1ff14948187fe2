"""Whisper-style encoder-decoder.

The conv audio frontend is a stub, as in the reference: the model consumes
precomputed frame embeddings (B, n_frames, D).  The encoder is a
bidirectional dense transformer over the frames; the decoder a causal one
with cross-attention to the encoder's states in every layer (whisper's
layout), with learned positions on both sides.  The decode cache and the
one-step decode belong to the serving slice of the port.
"""

from __future__ import annotations

import torch
from torch import nn

from .attention import Attention, attention_train, cross_attention
from .layers import MLP, Embedding, Linear, RMSNorm, _param, dtype_of
from .transformer import Layer


class DecoderLayer(nn.Module):
    """norm1 and attn (causal self-attention), norm_x and cross
    (cross-attention to the encoder), norm2 and mlp."""

    def __init__(self, cfg, *, device=None, generator=None):
        super().__init__()
        dt = dtype_of(cfg.dtype)
        d = cfg.d_model
        kw = dict(device=device, generator=generator)
        self.norm1 = RMSNorm(d, dt, eps=cfg.norm_eps, device=device)
        self.attn = Attention(cfg, **kw)
        self.norm_x = RMSNorm(d, dt, eps=cfg.norm_eps, device=device)
        self.cross = Attention(cfg, **kw)
        self.norm2 = RMSNorm(d, dt, eps=cfg.norm_eps, device=device)
        self.mlp = MLP(d, cfg.d_ff, dt, cfg.gated_mlp, cfg.activation, **kw)


class EncDec(nn.Module):
    """Token embeddings, the decoder's and the encoder's learned position
    tables (normal(0, 0.01), as the reference draws them), the encoder's
    dense layers and final norm, the decoder's layers and final norm, and
    the LM head unless the embeddings are tied."""

    def __init__(self, cfg, *, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        dt = dtype_of(cfg.dtype)
        d = cfg.d_model
        kw = dict(device=device, generator=generator)
        self.embed = Embedding(cfg.vocab_size, d, dt, **kw)
        self.final_norm = RMSNorm(d, dt, eps=cfg.norm_eps, device=device)
        self.enc_final_norm = RMSNorm(d, dt, eps=cfg.norm_eps, device=device)
        self.pos_table = _param((cfg.max_position, d), dt, device, generator,
                                0.01)
        self.enc_pos_table = _param((cfg.encoder.n_frames, d), dt, device,
                                    generator, 0.01)
        self.lm_head = (None if cfg.tie_embeddings else
                        Linear(d, cfg.vocab_size, dt, **kw))
        self.enc_layers = nn.ModuleList(
            Layer(cfg, "dense", **kw) for _ in range(cfg.encoder.n_layers))
        self.dec_layers = nn.ModuleList(
            DecoderLayer(cfg, **kw) for _ in range(cfg.n_layers))


def encode(net: EncDec, cfg, frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, n_frames, D) precomputed embeddings (the frontend stub)
    -> the encoder's states (B, n_frames, D)."""
    x = frames + net.enc_pos_table[None, :frames.shape[1]]
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    for p in net.enc_layers:
        x = x + attention_train(p.attn, cfg, p.norm1(x), positions,
                                causal=False)
        x = x + p.mlp(p.norm2(x))
    return net.enc_final_norm(x)


def encdec_forward_train(net: EncDec, cfg, frames: torch.Tensor,
                         tokens: torch.Tensor):
    """Returns (hidden after the decoder's final norm, aux = 0)."""
    memory = encode(net, cfg, frames)
    x = net.embed(tokens)
    b, s = x.shape[:2]
    x = x + net.pos_table[None, :s]
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    for p in net.dec_layers:
        x = x + attention_train(p.attn, cfg, p.norm1(x), positions,
                                causal=True)
        x = x + cross_attention(p.cross, cfg, p.norm_x(x), memory)
        x = x + p.mlp(p.norm2(x))
    return (net.final_norm(x),
            torch.zeros((), dtype=torch.float32, device=x.device))
