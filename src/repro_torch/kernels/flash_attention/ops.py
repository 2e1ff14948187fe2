"""Public wrapper for the flash attention kernel (K4): the (B, H, S, D) API
with k, v of shape (B, KV, S, D), scale = D^-0.5 of the true head dim, the
plain version for tiny or cross-length causal shapes, the tile plan's
family checked."""

from __future__ import annotations

from typing import Optional

import torch

from .. import _build
from ..common import TilePlan, check_cuda, stream_of, tile_block
from .ref import flash_attention_ref

_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: head dims the kernel is compiled for (csrc/flash_attention.cu)
HEAD_DIMS = (64, 96, 128)


def _ref4(q, k, v, causal):
    """The plain version on (B, H, S, D) operands."""
    b, h, s, d = q.shape
    kv, skv = k.shape[1], k.shape[2]
    return flash_attention_ref(
        q.reshape(b * h, s, d), k.reshape(b * kv, skv, d),
        v.reshape(b * kv, skv, d), causal=causal).reshape(b, h, s, d)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True) -> torch.Tensor:
    """K4 (``csrc/flash_attention.cu``), the counterpart of the reference's
    ``flash_attention_pallas``: q (B, H, Sq, D), k and v (B, KV, Skv, D),
    any strides with unit stride along D, scaled by D^-0.5.  CPU tensors
    take the plain version; CUDA tensors launch the kernel or raise."""
    b, h, sq, d = q.shape
    _, kv, skv, _ = k.shape
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return _ref4(q, k, v, causal)
    check_cuda("flash_attention", tuple(_CODES), q, k, v)
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"flash_attention: dtypes differ ({q.dtype}, "
                        f"{k.dtype}, {v.dtype})")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not supported "
                         f"(kernel takes {HEAD_DIMS})")
    if (k.shape != v.shape or k.shape[0] != b or k.shape[3] != d
            or kv == 0 or h % kv != 0):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not match")
    if causal and sq != skv:
        raise ValueError("flash_attention: causal needs Sq == Skv")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    out = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    if out.numel():
        strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
        with torch.cuda.device(q.device):
            _build.extension().flash_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                _CODES[q.dtype], b, h, kv, sq, skv, d, strides, d ** -0.5,
                bool(causal), stream_of(q))
        flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    tiles: Optional[TilePlan] = None) -> torch.Tensor:
    """q: (B, H, S, D); k, v: (B, KV, S, D).  Returns (B, H, S, D).

    ``tiles`` is a flash_attention :class:`TilePlan` (dims bq/bkv).  Its
    family is checked as the reference checks it, but its blocks are VMEM
    choices of the TPU kernel and set nothing here, and nothing is padded:
    K4's tiles are its own and it masks the ragged edges itself.
    """
    s, skv = q.shape[2], k.shape[2]
    if s < 128 or skv < 128 or (causal and s != skv):
        # tiny shapes, or causal cross-length (decode): the plain version
        return _ref4(q, k, v, causal)
    tile_block(tiles, "flash_attention", "bq", 256)
    return flash_attention_cuda(q, k, v, causal=causal)
