"""Plain PyTorch version of the flash attention kernel (K4): the full
softmax over every key, GQA by repeating each kv head over its group,
masked with -1e30 above the causal diagonal, in fp32, written in q's type.

It is both the wrapper's path for tiny or cross-length causal shapes and
the yardstick the kernel is held to."""

import torch


def flash_attention_ref(q, k, v, *, causal=True):
    """q: (BH, Sq, D); k, v: (BKV, Skv, D) with BH % BKV == 0; scaled by
    D^-0.5."""
    bh, sq, d = q.shape
    bkv, skv, _ = k.shape
    group = bh // bkv
    kf = k.repeat_interleave(group, dim=0).to(torch.float32)
    vf = v.repeat_interleave(group, dim=0).to(torch.float32)
    s = torch.einsum("bqd,bkd->bqk", q.to(torch.float32) * d ** -0.5, kf)
    if causal:
        mask = torch.ones(sq, skv, dtype=torch.bool,
                          device=q.device).tril(skv - sq)
        s = torch.where(mask, s, -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    return torch.einsum("bqk,bkd->bqd", p, vf).to(q.dtype)
