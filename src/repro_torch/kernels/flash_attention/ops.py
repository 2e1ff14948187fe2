"""Public wrapper for the flash attention kernel (K4): the (B, H, S, D) API
with k, v of shape (B, KV, S, D), D zero-padded to a head dim the kernel
has a body for (up to 256) or to a multiple of 128 (above, as the reference
pads), scale = D^-0.5 of the true head dim, the plain version for tiny or
cross-length causal shapes, the tile plan's family checked.

The launch is the operator ``torch.ops.repro_torch.flash_attention``: on
CUDA tensors it launches K4; on ``meta`` tensors (a counted run, see
``core/roofline.py``) it gives the output's shape and type; and a flop
counter reads its work from :func:`flash_attention_flops`, on either
device, since it cannot see inside the launch.  With no dispatch mode
active, CUDA operands skip the operator and launch K4 straight
(``common.launch_directly``).  The padding and the
operand copies happen before the operator, decided from shapes and strides
alone, so a counted run on ``meta`` sees the copies the card makes."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from torch.utils.flop_counter import register_flop_formula

from .. import _build
from ..common import (TilePlan, check_cuda, launch_directly, stream_of,
                      tile_block)
from .ref import flash_attention_ref

_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: head dims the kernel is compiled for (csrc/flash_attention.cu); above
#: the widest, the wide body takes multiples of 128 up to the device's limit
HEAD_DIMS = (64, 96, 128, 256)


def _ref4(q, k, v, causal):
    """The plain version on (B, H, S, D) operands."""
    b, h, s, d = q.shape
    kv, skv = k.shape[1], k.shape[2]
    return flash_attention_ref(
        q.reshape(b * h, s, d), k.reshape(b * kv, skv, d),
        v.reshape(b * kv, skv, d), causal=causal).reshape(b, h, s, d)


def padded_head_dim(d: int) -> int:
    """The head dim K4 runs ``d`` at: the narrowest of ``HEAD_DIMS`` that
    holds it, or above those the next multiple of 128."""
    return next((x for x in HEAD_DIMS if x >= d), -(-d // 128) * 128)


def pad_head_dim(*ts: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The operands zero-padded along D to :func:`padded_head_dim`
    (returned as they are when D is that already).  Zero columns leave
    q k^T unchanged and give zero output columns, so attention over the
    padded operands, scaled by the true D^-0.5, is the unpadded result
    followed by zeros."""
    d = ts[0].shape[-1]
    dp = padded_head_dim(d)
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
    # the start's alignment from the storage offset: the allocator aligns
    # every storage's base, and a meta tensor has no address to read
    return (t.storage_offset() * t.element_size()) % 16 == 0 and all(
        st % 8 == 0 for n, st in zip(t.shape[:3], t.stride()[:3]) if n > 1)


def flash_attention_flops(b: int, h: int, sq: int, skv: int, d: int,
                          causal: bool) -> float:
    """K4's operations: 4 D a kept (query, key) pair, the causal square's
    upper triangle skipped (the bound of ``chip_smoke.py`` and PERF.md)."""
    pairs = sq * (sq + 1) // 2 if causal else sq * skv
    return 4.0 * b * h * d * pairs


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, d: int,
            causal: bool) -> torch.Tensor:
    """K4 on operands the wrapper padded to a head dim it has a body for
    and made loadable: (B, H, Sq, Dp) out, scaled by the true ``d``."""
    check_cuda("flash_attention", tuple(_CODES), q, k, v)
    b, h, sq, dp = q.shape
    kv, skv = k.shape[1], k.shape[2]
    out = torch.empty((b, h, sq, dp), dtype=q.dtype, device=q.device)
    if out.numel():
        strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
        with torch.cuda.device(q.device):
            _build.extension().flash_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                _CODES[q.dtype], b, h, kv, sq, skv, dp, strides, d ** -0.5,
                bool(causal), stream_of(q))
        flash_attention_cuda.launches += 1
    return out


_op = torch.library.custom_op("repro_torch::flash_attention", _launch,
                              mutates_args=())


@_op.register_fake
def _(q, k, v, d, causal):
    return q.new_empty(q.shape)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _(q_shape, k_shape, v_shape, d, causal, *args, out_shape=None,
      **kwargs) -> int:
    b, h, sq, _ = q_shape
    return flash_attention_flops(b, h, sq, k_shape[2], d, causal)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True) -> torch.Tensor:
    """K4 (``csrc/flash_attention.cu``), the counterpart of the reference's
    ``flash_attention_pallas``: q (B, H, Sq, D), k and v (B, KV, Skv, D),
    scaled by D^-0.5; D zero-padded to :func:`padded_head_dim` and the
    output sliced back; operands the kernel cannot take as they lie (see
    :func:`loadable`) are copied first.  CPU tensors take the plain
    version; CUDA tensors launch the kernel (up to D = 256, fp32: the FFMA
    body, bf16: the tensor-core body; above, the wide body in either type)
    and meta tensors take its shape (a counted run), or they raise, also
    (from the launcher, with the limit in the message) for a padded D
    above the widest whose tiles fit the device's shared memory of a
    block."""
    b, h, sq, d = q.shape
    _, kv, skv, _ = k.shape
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return _ref4(q, k, v, causal)
    check_cuda("flash_attention", tuple(_CODES), q, k, v, meta=True)
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
    launch = _launch if launch_directly(q) else _op
    out = launch(q, k, v, d, bool(causal))
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
