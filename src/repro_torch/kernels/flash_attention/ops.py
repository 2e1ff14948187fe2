"""Public wrapper for the flash attention kernel (K4): the (B, H, S, D) API
with k, v of shape (B, KV, S, D), D zero-padded to a head dim the kernel
has a body for, scale = D^-0.5 of the true head dim, the plain version for
tiny or cross-length causal shapes, the tile plan's family checked."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

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


def pad_head_dim(*ts: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The operands zero-padded along D to the narrowest of ``HEAD_DIMS``
    that holds D (returned as they are when D is one of them).  Zero columns
    leave q k^T unchanged and give zero output columns, so attention over
    the padded operands, scaled by the true D^-0.5, is the unpadded result
    followed by zeros.  Raises for D above the widest head dim."""
    d = ts[0].shape[-1]
    dp = next((x for x in HEAD_DIMS if x >= d), None)
    if dp is None:
        raise ValueError(f"flash_attention: head dim {d} is above "
                         f"{HEAD_DIMS[-1]}, the widest the kernel takes")
    if dp == d:
        return ts
    return tuple(F.pad(t, (0, dp - d)) for t in ts)


def loadable(t: torch.Tensor) -> bool:
    """Whether K4 takes ``t`` as it lies: unit stride along D and, for the
    bf16 body's TMA loads, a 16-byte aligned start and (batch, head, row)
    strides that are multiples of 8 elements wherever the axis is longer
    than 1."""
    if t.stride(-1) != 1:
        return False
    if t.dtype != torch.bfloat16:
        return True
    return t.data_ptr() % 16 == 0 and all(
        st % 8 == 0 for n, st in zip(t.shape[:3], t.stride()[:3]) if n > 1)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True) -> torch.Tensor:
    """K4 (``csrc/flash_attention.cu``), the counterpart of the reference's
    ``flash_attention_pallas``: q (B, H, Sq, D), k and v (B, KV, Skv, D),
    scaled by D^-0.5; D up to 128, zero-padded to the narrowest head dim
    the kernel has a body for (:func:`pad_head_dim`) and the output sliced
    back; operands the kernel cannot take as they lie (see :func:`loadable`)
    are copied first.  CPU tensors take the plain version; CUDA tensors
    launch the kernel (fp32: the FFMA body; bf16: the tensor-core body) or
    raise."""
    b, h, sq, d = q.shape
    _, kv, skv, _ = k.shape
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return _ref4(q, k, v, causal)
    check_cuda("flash_attention", tuple(_CODES), q, k, v)
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"flash_attention: dtypes differ ({q.dtype}, "
                        f"{k.dtype}, {v.dtype})")
    if (k.shape != v.shape or k.shape[0] != b or k.shape[3] != d
            or kv == 0 or h % kv != 0):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not match")
    if causal and sq != skv:
        raise ValueError("flash_attention: causal needs Sq == Skv")
    q, k, v = pad_head_dim(q, k, v)
    dp = q.shape[-1]
    q, k, v = (t if loadable(t) else t.clone(
        memory_format=torch.contiguous_format) for t in (q, k, v))
    out = torch.empty((b, h, sq, dp), dtype=q.dtype, device=q.device)
    if out.numel():
        strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
        with torch.cuda.device(q.device):
            _build.extension().flash_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                _CODES[q.dtype], b, h, kv, sq, skv, dp, strides, d ** -0.5,
                bool(causal), stream_of(q))
        flash_attention_cuda.launches += 1
    return out if dp == d else out[..., :d]


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
