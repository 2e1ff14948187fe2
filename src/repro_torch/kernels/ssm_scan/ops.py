"""Public wrapper for the scan kernel (K5): the (B, H, S, D) API, the plain
version for sequences shorter than 128, the tile plan's family checked."""

from __future__ import annotations

from typing import Optional

import torch

from .. import _build
from ..common import TilePlan, check_cuda, stream_of, tile_block
from .ref import ssm_scan_ref

_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _ref4(q, k, v, log_a):
    """The plain version on (B, H, S, D) operands."""
    b, h, s, dk = q.shape
    dv = v.shape[-1]
    return ssm_scan_ref(q.reshape(b * h, s, dk), k.reshape(b * h, s, dk),
                        v.reshape(b * h, s, dv),
                        log_a.reshape(b * h, s)).reshape(b, h, s, dv)


def ssm_scan_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  log_a: torch.Tensor) -> torch.Tensor:
    """K5 (``csrc/ssm_scan.cu``), the counterpart of the reference's
    ``ssm_scan_pallas``: q, k (B, H, S, DK), v (B, H, S, DV), log_a
    (B, H, S) fp32 <= 0, any strides with unit stride along DK and DV.  CPU
    tensors take the plain version; CUDA tensors launch the kernel (three
    CUDA launches through an fp32 workspace allocated here, one count) or
    raise, as the kernel does for a DK above 256, the widest state its
    tiles hold."""
    b, h, s, dk = q.shape
    dv = v.shape[-1]
    if all(t.device.type == "cpu" for t in (q, k, v, log_a)):
        return _ref4(q, k, v, log_a)
    check_cuda("ssm_scan", tuple(_CODES), q, k, v, log_a)
    if not q.dtype == k.dtype == v.dtype or log_a.dtype != torch.float32:
        raise TypeError(f"ssm_scan: q, k, v share one type and log_a is "
                        f"fp32; got {q.dtype}, {k.dtype}, {v.dtype}, "
                        f"{log_a.dtype}")
    if (k.shape != q.shape or v.shape[:3] != q.shape[:3]
            or log_a.shape != q.shape[:3]):
        raise ValueError(f"ssm_scan: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, log_a {tuple(log_a.shape)} "
                         "do not match")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    y = torch.empty((b, h, s, dv), dtype=q.dtype, device=q.device)
    if y.numel():
        strides = [x for t in (q, k, v) for x in t.stride()[:3]]
        strides += list(log_a.stride()) + list(y.stride()[:3])
        with torch.cuda.device(q.device):
            ext = _build.extension()
            work = torch.empty(ext.ssm_scan_workspace(b, h, s, dk, dv),
                               dtype=torch.float32, device=q.device)
            ext.ssm_scan(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         log_a.data_ptr(), y.data_ptr(), work.data_ptr(),
                         work.numel(), _CODES[q.dtype], b, h, s, dk, dv,
                         strides, stream_of(q))
        ssm_scan_cuda.launches += 1
    return y


ssm_scan_cuda.launches = 0


def ssm_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             log_a: torch.Tensor, *,
             tiles: Optional[TilePlan] = None) -> torch.Tensor:
    """q, k: (B, H, S, DK); v: (B, H, S, DV); log_a: (B, H, S).

    ``tiles`` is an ssm_scan :class:`TilePlan` (dim bs).  Its family is
    checked as the reference checks it, but its chunk is a VMEM choice of
    the TPU kernel and sets nothing here.  Nothing is padded: K5 fills the
    tail of its last chunk with zeros (log_a with 0), which is what the
    reference's padding computes.
    """
    if q.shape[2] < 128:
        return _ref4(q, k, v, log_a)
    tile_block(tiles, "ssm_scan", "bs", 256)
    return ssm_scan_cuda(q, k, v, log_a)
