"""GQA attention for the full-sequence forward path (train / prefill).

Three routes, chosen as the reference chooses them:

* ``S <= CHUNKED_ATTN_THRESHOLD``: ``_sdpa``, the whole score matrix in
  fp32 with a boolean mask;
* longer, without a sliding window: the flash attention kernel K4
  (``kernels/flash_attention``), where the reference has its chunked jnp
  twin of that kernel;
* longer, with a window (hymba): ``_sdpa_chunked``, the plain online-softmax
  loop over KV chunks. K4 has no window, as the TPU kernel has none.

Cross-attention (the VLM's image layers, whisper's decoder) takes ``_sdpa``
with no mask at every length, as in the reference.  Decode with a KV cache
and the paged-pool bridge belong to the serving slice of the port.
"""

from __future__ import annotations

import torch
from torch import nn

from ..kernels.flash_attention import flash_attention
from .layers import Linear, apply_rope, dtype_of

NEG_INF = -1e30

#: sequences longer than this take K4 (or the chunked loop) in
#: attention_train
CHUNKED_ATTN_THRESHOLD = 2048
#: KV columns per step of _sdpa_chunked
KV_CHUNK = 1024


class Attention(nn.Module):
    """The projections wq, wk, wv (optional bias) and wo, of a self- or a
    cross-attention block alike."""

    def __init__(self, cfg, *, device=None, generator=None):
        super().__init__()
        d, hd = cfg.d_model, cfg.hd
        h, kv = cfg.n_heads, cfg.n_kv_heads
        dt = dtype_of(cfg.dtype)
        kw = dict(device=device, generator=generator)
        self.wq = Linear(d, h * hd, dt, bias=cfg.qkv_bias, **kw)
        self.wk = Linear(d, kv * hd, dt, bias=cfg.qkv_bias, **kw)
        self.wv = Linear(d, kv * hd, dt, bias=cfg.qkv_bias, **kw)
        self.wo = Linear(h * hd, d, dt, **kw)


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n, hd).transpose(1, 2)       # (B, n, S, hd) view


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, n, s, hd = x.shape
    return x.transpose(1, 2).reshape(b, s, n * hd)


def _sdpa(q, k, v, mask, scale):
    """q: (B,H,Sq,hd); k,v: (B,KV,Skv,hd); GQA via reshape-grouping."""
    b, h, sq, hd = q.shape
    kvh = k.shape[1]
    g = h // kvh
    qg = q.reshape(b, kvh, g, sq, hd)
    s = torch.einsum("bkgqd,bkld->bkgql", qg.to(torch.float32) * scale,
                     k.to(torch.float32))
    if mask is not None:
        s = torch.where(mask[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgql,bkld->bkgqd", p, v.to(torch.float32))
    return o.reshape(b, h, sq, hd).to(q.dtype)


def _sdpa_chunked(q, k, v, *, causal: bool, window: int, scale: float):
    """Online-softmax attention over KV chunks in plain PyTorch: the
    (Sq, Skv) score matrix is never held beyond (Sq, chunk).  The plain
    counterpart of the reference's jnp twin of the flash kernel, with its
    chunking and its -1e30 masking, for the windowed case K4 does not
    take."""
    b, h, sq, hd = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    g = h // kvh
    chunk = KV_CHUNK
    while skv % chunk != 0:
        chunk //= 2
    qg = (q.to(torch.float32) * scale).reshape(b, kvh, g, sq, hd)
    rows = torch.arange(sq, device=q.device)[:, None]  # q index == kv index
    o = torch.zeros((b, kvh, g, sq, hd), dtype=torch.float32, device=q.device)
    m = torch.full((b, kvh, g, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, kvh, g, sq), dtype=torch.float32, device=q.device)
    for c0 in range(0, skv, chunk):
        kb = k[:, :, c0:c0 + chunk].to(torch.float32)
        vb = v[:, :, c0:c0 + chunk].to(torch.float32)
        s = torch.einsum("bkgqd,bkld->bkgql", qg, kb)
        if causal:
            cols = c0 + torch.arange(chunk, device=q.device)[None, :]
            valid = rows >= cols
            if window:
                valid &= cols > rows - window
            s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + torch.einsum("bkgql,bkld->bkgqd", p, vb)
        m = m_new
    o = o / torch.clamp(l, min=1e-30)[..., None]
    return o.reshape(b, h, sq, hd).to(q.dtype)


def causal_mask(sq: int, skv: int, window: int = 0, offset: int = 0,
                device=None) -> torch.Tensor:
    """(1, Sq, Skv) bool; offset = start position of q within kv
    timeline."""
    rows = offset + torch.arange(sq, device=device)[:, None]
    cols = torch.arange(skv, device=device)[None, :]
    m = rows >= cols
    if window:
        m = m & (cols > rows - window)
    return m[None]


def attention_train(p: Attention, cfg, x, positions, *, causal: bool = True,
                    window: int = 0):
    """Full-sequence attention (train / prefill)."""
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = _split_heads(p.wq(x), h, hd)
    k = _split_heads(p.wk(x), kv, hd)
    v = _split_heads(p.wv(x), kv, hd)
    if cfg.positions == "rope":
        q = apply_rope(q.transpose(1, 2), positions,
                       cfg.rope_theta).transpose(1, 2)
        k = apply_rope(k.transpose(1, 2), positions,
                       cfg.rope_theta).transpose(1, 2)
    sq = x.shape[1]
    if sq > CHUNKED_ATTN_THRESHOLD and not window:
        o = flash_attention(q, k, v, causal=causal)
    elif sq > CHUNKED_ATTN_THRESHOLD:
        o = _sdpa_chunked(q, k, v, causal=causal, window=window,
                          scale=hd ** -0.5)
    else:
        mask = causal_mask(sq, sq, window, device=x.device) if causal else None
        o = _sdpa(q, k, v, mask, hd ** -0.5)
    return p.wo(_merge_heads(o))


def cross_attention(p: Attention, cfg, x, memory):
    """x: (B, S, D) attends to memory (B, M, D) (encoder states or image
    patch embeddings), with no positions on q or k and no mask."""
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = _split_heads(p.wq(x), h, hd)
    k = _split_heads(p.wk(memory), kvh, hd)
    v = _split_heads(p.wv(memory), kvh, hd)
    o = _sdpa(q, k, v, None, hd ** -0.5)
    return p.wo(_merge_heads(o))
