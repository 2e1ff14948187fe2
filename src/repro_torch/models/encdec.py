"""Whisper-style encoder-decoder.

The conv audio frontend is a stub, as in the reference: the model consumes
precomputed frame embeddings (B, n_frames, D).  The encoder is a
bidirectional dense transformer over the frames; the decoder a causal one
with cross-attention to the encoder's states in every layer (whisper's
layout), with learned positions on both sides.  The decode cache is one
KV cache a decoder layer; the decode step reads each row's position from
the caches' lengths.
"""

from __future__ import annotations

from functools import partial

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..distributed.sharding import on_sequence, placed, seq_rows, seq_tp
from .attention import (Attention, attention_decode, attention_train,
                        cross_attention, init_kv_cache)
from .layers import REMAT, MLP, Embedding, Linear, RMSNorm, _param, dtype_of
from .transformer import Layer, lm_logits, position_rows


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
    x = frames + placed(net.enc_pos_table)[None, :frames.shape[1]]
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    for p in net.enc_layers:
        x = x + attention_train(p.attn, cfg, p.norm1(x), positions,
                                causal=False)
        x = x + p.mlp(p.norm2(x))
    return net.enc_final_norm(x)


def encdec_forward_train(net: EncDec, cfg, frames: torch.Tensor,
                         tokens: torch.Tensor):
    """Returns (hidden after the decoder's final norm, aux = 0).  With
    ``cfg.remat``, where a graph is built, each decoder layer is
    checkpointed, as the reference checkpoints them (not the encoder's).
    Under the ``seq_sp`` rules the decoder's hidden states are the rank's
    rows of the sequence (``sharding.seq_tp``); the encoder runs whole."""
    memory = encode(net, cfg, frames)
    x = net.embed(tokens)
    b, s = x.shape[:2]
    x = x + placed(net.pos_table)[None, :s]
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    sp = seq_tp(s)
    if sp is not None:
        x = seq_rows(x, sp)
    remat = cfg.remat and torch.is_grad_enabled()
    for p in net.dec_layers:
        if remat:
            x = checkpoint(_dec_layer_train, p, cfg, x, positions, memory,
                           sp, **REMAT)
            continue
        # inline (not through _dec_layer_train), so that the layer's input
        # is freed after its first residual add, as without a graph
        x = x + on_sequence(partial(attention_train, p.attn, cfg,
                                    positions=positions, causal=True),
                            p.norm1(x, sp), sp, p.attn.tp)
        x = x + on_sequence(partial(cross_attention, p.cross, cfg,
                                    memory=memory), p.norm_x(x, sp), sp,
                            p.cross.tp)
        x = x + on_sequence(p.mlp, p.norm2(x, sp), sp, p.mlp.tp)
    return (net.final_norm(x, sp),
            torch.zeros((), dtype=torch.float32, device=x.device))


def _dec_layer_train(p: DecoderLayer, cfg, x, positions, memory, sp=None):
    x = x + on_sequence(partial(attention_train, p.attn, cfg,
                                positions=positions, causal=True),
                        p.norm1(x, sp), sp, p.attn.tp)
    x = x + on_sequence(partial(cross_attention, p.cross, cfg,
                                memory=memory), p.norm_x(x, sp), sp,
                        p.cross.tp)
    return x + on_sequence(p.mlp, p.norm2(x, sp), sp, p.mlp.tp)


def init_encdec_cache(cfg, batch: int, max_len: int, device=None):
    """One ``{"kv": KVCache}`` a decoder layer."""
    dt = dtype_of(cfg.dtype)
    return [{"kv": init_kv_cache(batch, cfg.n_kv_heads, max_len, cfg.hd, dt,
                                 device)} for _ in range(cfg.n_layers)]


def encdec_decode_step(net: EncDec, cfg, tokens: torch.Tensor, caches,
                       memory: torch.Tensor):
    """tokens: (B, s1), one new token or a chunked-prefill chunk a row;
    memory: the encoder's states (B, M, D).  Returns (logits, caches)."""
    x = net.embed(tokens)
    x = x + position_rows(placed(net.pos_table), caches[-1]["kv"].length,
                          tokens.shape[1])
    new_caches = []
    for p, c in zip(net.dec_layers, caches):
        h, kv = attention_decode(p.attn, cfg, p.norm1(x), c["kv"])
        x = x + h
        x = x + cross_attention(p.cross, cfg, p.norm_x(x), memory)
        x = x + p.mlp(p.norm2(x))
        new_caches.append({"kv": kv})
    return lm_logits(net, cfg, net.final_norm(x)), new_caches
