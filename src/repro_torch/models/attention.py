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
with no mask at every length, as in the reference; under a mesh it runs
tensor-parallel as the self-attention does, against the memory that
every ``model`` rank holds whole.

K4 has no backward.  Where a graph is built (training), the K4 site goes
through ``FlashAttention``: its forward launches K4, its backward recomputes
the output through ``_sdpa_chunked`` (window 0), the twin that the
reference's gradient goes through, and differentiates that.

Under a mesh whose ``model`` axis cuts the projections on whole query
heads, ``attention_train`` runs tensor-parallel (Megatron-style): the rank
holds the columns of ``wq`` (and of ``wk`` / ``wv`` where the KV heads
divide too) and the rows of ``wo`` of its own heads, runs the attention
(K4 included) on them, and the ``model`` ranks sum ``wo``'s partial
outputs.  KV leaves cut within a head are gathered whole
(``sharding.placed``); each rank then takes the KV heads its query heads
read.  Under a sequence cut over ``model`` (``seq_sp``) the tensor-parallel
block takes the ranks' rows whole (``seq_enter``) and gives the rank's rows
of the summed output (``seq_exit``); RoPE takes the whole sequence's
positions.  Any other block runs on the gathered sequence
(``sharding.on_sequence``, at the layers' call sites).

Decode (``attention_decode``) runs ``_sdpa`` over the whole KV ring buffer,
as the reference's does: no kernel.  Under a mesh the cache follows the
reference's rule ``("batch", None, "kv_seq", None)``: the rank holds its
rows and slots ``[i smax/m, (i+1) smax/m)`` of every KV head
(``_sharded_attend``), writes the new keys and values where it owns their
slots, and its partial softmax over its slots is combined with the other
ranks' by the reference's "psum pair" (a max of the row maxima, then a
sum of the rescaled sums and outputs).  The reference keeps one cache a request
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

from ..distributed import process_group as pg
from ..distributed.sharding import (block_enter, block_exit, tp_enter,
                                    tp_exit, tp_gather)
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
    cross-attention block alike.  ``tp`` (a ``sharding.TP``) is set where
    the block runs tensor-parallel; ``kv_tp`` when ``wk`` / ``wv``
    are cut on whole KV heads too."""

    tp = None
    kv_tp = False

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


class FlashAttention(torch.autograd.Function):
    """K4 with a gradient: the kernel's forward; a backward that recomputes
    the output through ``_sdpa_chunked`` and differentiates it.  Only the
    inputs are saved (K4's wrapper pads D; the padded copies are not
    kept)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        return flash_attention(q, k, v, causal=causal)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            o = _sdpa_chunked(q, k, v, causal=ctx.causal, window=0,
                              scale=q.shape[-1] ** -0.5)
            dq, dk, dv = torch.autograd.grad(o, (q, k, v), grad_out)
        return dq, dk, dv, None


def flash_attention_site(q, k, v, *, causal: bool):
    """K4 at the model's site: the wrapper as it is where no graph is built
    (inference mode, ``no_grad``, or no input that takes a gradient), else
    through :class:`FlashAttention`."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal)
    return flash_attention(q, k, v, causal=causal)


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


def _rank_kv(k, v, tp, h: int, kv: int):
    """The KV heads (of all ``kv``) that this rank's ``h // tp.size`` query
    heads read: a slice where they are whole groups (or one head), else one
    KV head per query head."""
    g, hl = h // kv, h // tp.size
    q0 = tp.index * hl
    kv0, kv1 = q0 // g, (q0 + hl - 1) // g + 1
    if kv1 - kv0 == 1 or (q0 % g == 0 and hl % g == 0):
        return k[:, kv0:kv1], v[:, kv0:kv1]
    sel = torch.arange(q0, q0 + hl, device=k.device) // g
    return k[:, sel], v[:, sel]


def attention_train(p: Attention, cfg, x, positions, *, causal: bool = True,
                    window: int = 0, sp=None):
    """Full-sequence attention (train / prefill); tensor-parallel when
    ``p.tp`` is set, and then ``sp`` (``sharding.seq_tp``, through
    ``sharding.on_sequence``): ``x`` and the output are the rank's rows of
    a sequence cut over ``model``, ``positions`` the whole sequence's, and
    the heads attend over the whole sequence."""
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    tp = p.tp
    if tp is None:
        q = _split_heads(p.wq(x), h, hd)
        k = _split_heads(p.wk(x), kv, hd)
        v = _split_heads(p.wv(x), kv, hd)
    else:
        xt = block_enter(x, tp, sp)
        q = _split_heads(p.wq(xt), h // tp.size, hd)
        # without kv_tp under sp, the KV from the whole sequence, its
        # gradient replicated
        k, v = _rank_kv_heads(p, cfg, xt, lambda: (
            x if sp is None else tp_gather(x, sp, 1)))
    if cfg.positions == "rope":
        q = apply_rope(q.transpose(1, 2), positions,
                       cfg.rope_theta).transpose(1, 2)
        k = apply_rope(k.transpose(1, 2), positions,
                       cfg.rope_theta).transpose(1, 2)
    sq = q.shape[2]
    if sq > CHUNKED_ATTN_THRESHOLD and not window:
        o = flash_attention_site(q, k, v, causal=causal)
    elif sq > CHUNKED_ATTN_THRESHOLD:
        o = _sdpa_chunked(q, k, v, causal=causal, window=window,
                          scale=hd ** -0.5)
    else:
        mask = causal_mask(sq, sq, window, device=x.device) if causal else None
        o = _sdpa(q, k, v, mask, hd ** -0.5)
    return block_exit(p.wo(_merge_heads(o)), tp, sp)


def _rank_kv_heads(p: Attention, cfg, xt, whole):
    """The keys and values that this rank's query heads read, in a block
    run tensor-parallel: its own KV heads, projected from ``xt`` (the
    block's entered input), where they divide ``model`` (``p.kv_tp``);
    else every KV head, projected from ``whole()`` (the input as every
    ``model`` rank holds it) alike on every rank, each rank's heads
    feeding only part of their gradient, summed by ``tp_enter``."""
    tp, kv, hd = p.tp, cfg.n_kv_heads, cfg.hd
    if p.kv_tp:
        return (_split_heads(p.wk(xt), kv // tp.size, hd),
                _split_heads(p.wv(xt), kv // tp.size, hd))
    src = whole()
    k = _split_heads(tp_enter(p.wk(src), tp), kv, hd)
    v = _split_heads(tp_enter(p.wv(src), tp), kv, hd)
    return _rank_kv(k, v, tp, cfg.n_heads, kv)


def cross_attention(p: Attention, cfg, x, memory, sp=None):
    """x: (B, S, D) attends to memory (B, M, D) (encoder states or image
    patch embeddings), with no positions on q or k and no mask.  With
    ``p.tp`` tensor-parallel, as ``attention_train``: the rank's query
    heads (and KV heads, with ``kv_tp``, from the memory entered by
    ``tp_enter``: every ``model`` rank holds it whole), ``wo``'s rows; and
    then ``sp``: ``x`` and the output are the rank's rows of the
    sequence."""
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    tp = p.tp
    if tp is None:
        q = _split_heads(p.wq(x), h, hd)
        k = _split_heads(p.wk(memory), kvh, hd)
        v = _split_heads(p.wv(memory), kvh, hd)
    else:
        q = _split_heads(p.wq(block_enter(x, tp, sp)), h // tp.size, hd)
        mt = tp_enter(memory, tp) if p.kv_tp else memory
        k, v = _rank_kv_heads(p, cfg, mt, lambda: memory)
    o = _sdpa(q, k, v, None, hd ** -0.5)
    return block_exit(p.wo(_merge_heads(o)), tp, sp)


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
    lengths plus ``s1``.  Under a mesh the projections are all-gathered
    to every head where the module is cut by heads, a cache cut on its
    slots (``cache.k.placement``) takes :func:`_sharded_attend`, and the
    rank's own heads go through ``wo`` under ``tp_exit``.  x: (B, s1, D).
    Returns (out, new_cache)."""
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    b, s1, _ = x.shape
    dev = x.device
    steps = torch.arange(s1, device=dev)
    pos = cache.length[:, None] + steps                       # (B, s1)
    # every head's projections, all-gathered where the module is cut by
    # heads (tensor-parallel under a mesh)
    tp = p.tp
    kv_tp = tp if p.kv_tp else None
    q = _whole_heads(p.wq(x), tp, h, hd)
    k_new = _whole_heads(p.wk(x), kv_tp, kvh, hd)
    v_new = _whole_heads(p.wv(x), kv_tp, kvh, hd)
    if cfg.positions == "rope":
        q = apply_rope(q.transpose(1, 2), pos, cfg.rope_theta).transpose(1, 2)
        k_new = apply_rope(k_new.transpose(1, 2), pos,
                           cfg.rope_theta).transpose(1, 2)
    where = getattr(cache.k, "placement", None)
    if where is not None:
        o = _sharded_attend(q, k_new, v_new, cache, where, hd)
    else:
        smax = cache.k.shape[2]
        write_idx = cache.length % smax                       # (B,)
        start = torch.clamp(write_idx, max=max(smax - s1, 0))
        rows = torch.arange(b, device=dev)[:, None]
        slots = start[:, None] + steps                        # (B, s1)
        # advanced indices around a slice: the indexed view is
        # (B, s1, KV, hd)
        cache.k[rows, :, slots] = k_new.transpose(1, 2).to(cache.k.dtype)
        cache.v[rows, :, slots] = v_new.transpose(1, 2).to(cache.v.dtype)
        mask = _decode_mask(cache.length, s1,
                            torch.arange(smax, device=dev), smax)
        o = _sdpa(q, cache.k, cache.v, mask, hd ** -0.5)
    if tp is None:
        out = p.wo(_merge_heads(o))
    else:
        # this rank's heads into its rows of wo, the partial sums added
        hl = h // tp.size
        out = tp_exit(p.wo(_merge_heads(
            o[:, tp.index * hl:(tp.index + 1) * hl])), tp)
    return out, KVCache(cache.k, cache.v, cache.length + s1)


def _decode_mask(length, s1: int, cols, smax: int):
    """(B, s1, len(cols)) bool: which of the slots ``cols`` (of a ring of
    ``smax``) each new token of each row sees."""
    steps = torch.arange(s1, device=cols.device)
    cols = cols[None, None, :]
    write_idx = length % smax
    # slots < length + s1 hold data; once wrapped, every slot is valid
    valid = cols < torch.clamp(length + s1, max=smax)[:, None, None]
    # within the just-written chunk, query i must not see slots j > i
    off = cols - write_idx[:, None, None]                     # (B, 1, n)
    future = (off > steps[None, :, None]) & (off < s1)
    return valid & ~future


def _whole_heads(t, tp, n: int, hd: int):
    """(B, s1, n * hd) projections of all ``n`` heads: this rank's heads
    all-gathered over ``model`` where ``tp`` is set."""
    if tp is not None:
        t = pg.all_gather(t, tp.group, dim=2)
    return _split_heads(t, n, hd)


def _sharded_attend(q, k_new, v_new, cache: KVCache, where, hd: int):
    """The attention of ``attention_decode`` on a cache cut on its slots
    over ``model`` (``where``: its ``Placement``, mode ``"kv_seq"``): this
    rank holds slots ``[lo, lo + n)`` of a ring of ``smax = n * m``, and
    every head's ``q`` and new keys and values.

    A rank writes the new keys and values whose slots it owns (the clamp
    and the mask of the unsharded path, on global slot indices), then
    attends over its own slots: the row maxima are all-reduced (max), each
    rank's exponentials are taken against that maximum, and their sums and
    weighted values all-reduced (sum).  A rank with no valid slot holds
    -1e30 scores: against the global maximum (some rank holds the new
    token) they add exactly zero.  Returns (B, H, s1, hd), every head."""
    mesh = where.mesh
    group = mesh.group("model")
    b, h, s1, _ = q.shape
    kvh = cache.k.shape[1]
    dev = q.device
    steps = torch.arange(s1, device=dev)
    n = cache.k.shape[2]
    smax = n * mesh.shape["model"]
    lo = mesh.axis_index("model") * n
    start = torch.clamp(cache.length % smax, max=max(smax - s1, 0))
    local = start[:, None] + steps - lo                       # (B, s1)
    own = (local >= 0) & (local < n)
    # a token this rank does not own writes the value of the row's first
    # owned token to that token's slot (or, with none owned, a slot's own
    # value back to it): no slot takes two different values
    first = own.to(torch.int32).argmax(1, keepdim=True)       # (B, 1)
    src = torch.where(own, steps[None], first)                # (B, s1)
    idx = torch.gather(local, 1, src).clamp(0, n - 1)
    rows = torch.arange(b, device=dev)[:, None]
    hit = own.any(1)[:, None, None, None]
    for new, buf in ((k_new, cache.k), (v_new, cache.v)):
        vals = new.transpose(1, 2)[rows, src].to(buf.dtype)   # (B,s1,KV,hd)
        buf[rows, :, idx] = torch.where(hit, vals, buf[rows, :, idx])
    mask = _decode_mask(cache.length, s1, lo + torch.arange(n, device=dev),
                        smax)                                 # (B, s1, n)
    qg = q.reshape(b, kvh, h // kvh, s1, hd).to(torch.float32) * hd ** -0.5
    sc = torch.einsum("bkgqd,bkld->bkgql", qg, cache.k.to(torch.float32))
    sc = torch.where(mask[:, None, None], sc, NEG_INF)
    top = pg.all_reduce(sc.amax(-1), group, op="max")         # (B,KV,g,s1)
    e = torch.exp(sc - top[..., None])
    part = torch.cat([torch.einsum("bkgql,bkld->bkgqd", e,
                                   cache.v.to(torch.float32)),
                      e.sum(-1)[..., None]], dim=-1)
    part = pg.all_reduce(part, group)
    o = part[..., :hd] / part[..., hd:]
    return o.reshape(b, h, s1, hd).to(q.dtype)


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
