"""Public wrapper for the scan kernel (K5): the (B, H, S, D) API, the plain
version for sequences shorter than 128, the tile plan's family checked.

The launch is the operator ``torch.ops.repro_torch.ssm_scan``: on CUDA
tensors it launches K5, on ``meta`` tensors it gives the output's shape
and type, and a flop counter reads its work from :func:`ssm_scan_flops`.
With no dispatch mode active, CUDA operands skip the operator and launch
K5 straight (``common.launch_directly``).  The operand copies and the fp32
workspace are made before it, so a counted run sees them on either
device."""

from __future__ import annotations

from typing import Optional

import torch

from torch.utils.flop_counter import register_flop_formula

from .. import _build
from ..common import (TilePlan, check_cuda, launch_directly, stream_of,
                      tile_block)
from .ref import ssm_scan_ref

_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _ref4(q, k, v, log_a):
    """The plain version on (B, H, S, D) operands."""
    b, h, s, dk = q.shape
    dv = v.shape[-1]
    return ssm_scan_ref(q.reshape(b * h, s, dk), k.reshape(b * h, s, dk),
                        v.reshape(b * h, s, dv),
                        log_a.reshape(b * h, s)).reshape(b, h, s, dv)


def ssm_scan_flops(bh: int, s: int, dk: int, dv: int) -> float:
    """K5's operations: the recurrence's 4 DK DV a step of each of ``bh``
    sequences (the bound of ``chip_smoke.py`` and PERF.md)."""
    return 4.0 * bh * s * dk * dv


#: rows of a chunk of K5 (``C`` in csrc/ssm_scan.cu)
CHUNK = 64


def ssm_scan_workspace(b: int, h: int, s: int, dk: int, dv: int) -> int:
    """Floats of K5's fp32 workspace, as ``repro_ssm_scan_workspace``
    (csrc/ssm_scan.cu) asks: a DK x DV4 chunk state (DV4 = DV rounded up
    to 4) and one decay a head and chunk."""
    return b * h * -(-s // CHUNK) * (dk * (-(-dv // 4) * 4) + 1)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            log_a: torch.Tensor, work: torch.Tensor) -> torch.Tensor:
    """K5 on operands with unit stride along DK and DV, through the fp32
    workspace ``work``: y (B, H, S, DV)."""
    check_cuda("ssm_scan", tuple(_CODES), q, k, v, log_a)
    if work.dtype != torch.float32 or work.device != q.device:
        raise ValueError(f"ssm_scan: the workspace is {work.dtype} on "
                         f"{work.device}, not fp32 on {q.device}")
    b, h, s, dk = q.shape
    dv = v.shape[-1]
    y = torch.empty((b, h, s, dv), dtype=q.dtype, device=q.device)
    if y.numel():
        strides = [x for t in (q, k, v) for x in t.stride()[:3]]
        strides += list(log_a.stride()) + list(y.stride()[:3])
        with torch.cuda.device(q.device):
            # the launcher refuses a workspace smaller than it asks
            _build.extension().ssm_scan(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), log_a.data_ptr(),
                y.data_ptr(), work.data_ptr(), work.numel(),
                _CODES[q.dtype], b, h, s, dk, dv, strides, stream_of(q))
        ssm_scan_cuda.launches += 1
    return y


_op = torch.library.custom_op("repro_torch::ssm_scan", _launch,
                              mutates_args=("work",))


@_op.register_fake
def _(q, k, v, log_a, work):
    return q.new_empty((*q.shape[:3], v.shape[-1]))


@register_flop_formula(torch.ops.repro_torch.ssm_scan)
def _(q_shape, k_shape, v_shape, a_shape, *args, out_shape=None,
      **kwargs) -> int:
    b, h, s, dk = q_shape
    return ssm_scan_flops(b * h, s, dk, v_shape[-1])


def ssm_scan_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  log_a: torch.Tensor) -> torch.Tensor:
    """K5 (``csrc/ssm_scan.cu``), the counterpart of the reference's
    ``ssm_scan_pallas``: q, k (B, H, S, DK), v (B, H, S, DV), log_a
    (B, H, S) fp32 <= 0, any strides with unit stride along DK and DV.  CPU
    tensors take the plain version; CUDA tensors launch the kernel (three
    CUDA launches through an fp32 workspace allocated here, one count) and
    meta tensors take its shape and its workspace (a counted run), or they
    raise, as the kernel does for a DK above 256, the widest state its
    tiles hold."""
    b, h, s, dk = q.shape
    dv = v.shape[-1]
    if all(t.device.type == "cpu" for t in (q, k, v, log_a)):
        return _ref4(q, k, v, log_a)
    check_cuda("ssm_scan", tuple(_CODES), q, k, v, log_a, meta=True)
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
    work = torch.empty(ssm_scan_workspace(b, h, s, dk, dv),
                       dtype=torch.float32, device=q.device)
    launch = _launch if launch_directly(q) else _op
    return launch(q, k, v, log_a, work)


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
