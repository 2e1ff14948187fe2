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
with no mask at every length, as in the reference.

Decode (``attention_decode``) runs ``_sdpa`` over the whole KV ring buffer,
as the reference's does: no kernel.  The reference keeps one cache a request
and maps its step over the requests, each with a scalar length; here a cache
carries a batch dim and one length a row, so every row has its own write
index, mask and RoPE positions.  The paged-pool bridge
(``paged_kv_pool`` / ``scatter_block_kv`` / ``gather_block_kv``) is the
reference's.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

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


# ---------------------------------------------------------------------------
# decode with a KV cache
# ---------------------------------------------------------------------------


class KVCache(NamedTuple):
    k: torch.Tensor          # (B, KV, S_max, hd)
    v: torch.Tensor
    length: torch.Tensor     # (B,) int64: tokens already cached, per row


def init_kv_cache(batch: int, kv_heads: int, max_len: int, hd: int, dtype,
                  device=None) -> KVCache:
    """An empty cache: zeroed k and v (two tensors: the decode writes them
    in place) and a length of 0 for each of ``batch`` rows."""
    shape = (batch, kv_heads, max_len, hd)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros((batch,), dtype=torch.long, device=device))


def attention_decode(p: Attention, cfg, x, cache: KVCache):
    """Decode step of ``s1 >= 1`` new tokens against a KV cache.

    The cache is a ring buffer of capacity ``smax``: for full attention
    smax >= the total length, so the write index ``length % smax`` equals
    ``length``; for sliding-window attention smax == window, old entries
    are overwritten, and the validity mask keeps exactly the last
    ``window`` positions (RoPE is applied at write time with absolute
    positions, so attention does not depend on the slots' order).

    ``s1 > 1`` is the chunked-prefill path: the chunk is written
    contiguously and masked causally within itself.  A chunk that would
    run past the buffer's end is written at ``smax - s1`` instead, the
    clamp the reference's ``dynamic_update_slice`` applies to its start;
    the mask still takes the unclamped write index, as the reference's
    does.  The serving backend keeps chunks from wrapping.

    Each row has its own length, write index, mask and positions.  The new
    keys and values are written into ``cache.k`` / ``cache.v`` in place (a
    request owns its cache); the returned cache holds those tensors and the
    lengths plus ``s1``.  x: (B, s1, D).  Returns (out, new_cache)."""
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    b, s1, _ = x.shape
    dev = x.device
    steps = torch.arange(s1, device=dev)
    pos = cache.length[:, None] + steps                       # (B, s1)
    q = _split_heads(p.wq(x), h, hd)
    k_new = _split_heads(p.wk(x), kvh, hd)
    v_new = _split_heads(p.wv(x), kvh, hd)
    if cfg.positions == "rope":
        q = apply_rope(q.transpose(1, 2), pos, cfg.rope_theta).transpose(1, 2)
        k_new = apply_rope(k_new.transpose(1, 2), pos,
                           cfg.rope_theta).transpose(1, 2)
    smax = cache.k.shape[2]
    write_idx = cache.length % smax                           # (B,)
    start = torch.clamp(write_idx, max=max(smax - s1, 0))
    rows = torch.arange(b, device=dev)[:, None]
    slots = start[:, None] + steps                            # (B, s1)
    # advanced indices around a slice: the indexed view is (B, s1, KV, hd)
    cache.k[rows, :, slots] = k_new.transpose(1, 2).to(cache.k.dtype)
    cache.v[rows, :, slots] = v_new.transpose(1, 2).to(cache.v.dtype)
    cols = torch.arange(smax, device=dev)[None, None, :]      # (1, 1, smax)
    # slots < length + s1 hold data; once wrapped, every slot is valid
    valid = cols < torch.clamp(cache.length + s1, max=smax)[:, None, None]
    # within the just-written chunk, query i must not see slots j > i
    off = cols - write_idx[:, None, None]                     # (B, 1, smax)
    future = (off > steps[None, :, None]) & (off < s1)
    mask = valid & ~future                                    # (B, s1, smax)
    o = _sdpa(q, cache.k, cache.v, mask, hd ** -0.5)
    out = p.wo(_merge_heads(o))
    return out, KVCache(cache.k, cache.v, cache.length + s1)


# ---------------------------------------------------------------------------
# paged KV pool bridge (serving)
# ---------------------------------------------------------------------------
# The serving scheduler accounts KV capacity in fixed-size blocks
# (serving/kvblocks.py); physically the pool is one tensor of shape
# (num_blocks, KV, block_size, hd) per k / v.  A paged attention kernel
# would read the block table directly; until then these functions are the
# bridge: scatter a request's contiguous ring cache into its table's
# blocks, and gather a table back into the contiguous cache that
# attention_decode takes.  The round trip is exact.


def paged_kv_pool(num_blocks: int, block_size: int, kv_heads: int, hd: int,
                  dtype=torch.float32, device=None):
    """Zeroed physical pool: (pool_k, pool_v), each
    (num_blocks, KV, block_size, hd)."""
    shape = (num_blocks, kv_heads, block_size, hd)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def scatter_block_kv(pool_k, pool_v, cache: KVCache,
                     block_table: Sequence[int]):
    """Write a single-request contiguous cache into its pool blocks.

    cache.k / v: (1, KV, S, hd) with S <= len(block_table) * block_size
    (a short cache is zero-padded into the last block).  Returns the
    updated (pool_k, pool_v), new tensors: the pools given are not
    written."""
    table = torch.as_tensor(list(block_table), dtype=torch.long,
                            device=pool_k.device)
    nb, bs = table.shape[0], pool_k.shape[2]
    kvh, s, hd = cache.k.shape[1], cache.k.shape[2], cache.k.shape[3]
    if s > nb * bs:
        raise ValueError(f"cache length {s} exceeds table capacity {nb * bs}")

    def to_blocks(x):
        x = torch.nn.functional.pad(x[0], (0, 0, 0, nb * bs - s))
        return x.reshape(kvh, nb, bs, hd).transpose(0, 1)

    out_k, out_v = pool_k.clone(), pool_v.clone()
    out_k[table] = to_blocks(cache.k).to(pool_k.dtype)
    out_v[table] = to_blocks(cache.v).to(pool_v.dtype)
    return out_k, out_v


def gather_block_kv(pool_k, pool_v, block_table: Sequence[int],
                    length) -> KVCache:
    """Assemble the contiguous (1, KV, nb * block_size, hd) cache a block
    table denotes, with ``length`` as its one row's length."""
    table = torch.as_tensor(list(block_table), dtype=torch.long,
                            device=pool_k.device)
    _, kvh, bs, hd = pool_k.shape
    nt = table.shape[0]

    def from_blocks(pool):
        return pool[table].transpose(0, 1).reshape(kvh, nt * bs, hd)[None]

    return KVCache(from_blocks(pool_k), from_blocks(pool_v),
                   torch.as_tensor(length, dtype=torch.long,
                                   device=pool_k.device).reshape(1))
