"""Public wrapper for the matmul kernel (K1): any (..., M, K) x (..., K, N)
with broadcast leading dimensions (the stacked ranks of a process grid run
as one batched launch), the tile plan's family checked, the plain version
for problems where min(M, N, K) < 128."""

from __future__ import annotations

from typing import Optional

import torch

from .. import _build
from ..common import TilePlan, as_batched, check_cuda, stream_of
from .ref import matmul_ref

_CODES = {torch.float32: 0, torch.bfloat16: 1}


def matmul_cuda(a: torch.Tensor, b: torch.Tensor, *,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """K1 (``csrc/matmul.cu``), the counterpart of the reference's
    ``matmul_pallas``: C = A @ B with fp32 accumulation.  CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise."""
    out_dtype = out_dtype or a.dtype
    if a.device.type == "cpu" and b.device.type == "cpu":
        return matmul_ref(a, b, out_dtype=out_dtype)
    check_cuda("matmul", tuple(_CODES), a, b)
    if out_dtype not in _CODES:
        raise TypeError(f"matmul: out_dtype {out_dtype} not supported")
    if a.dtype != b.dtype:
        raise TypeError(f"matmul: operand dtypes differ ({a.dtype}, "
                        f"{b.dtype})")
    m, k = a.shape[-2:]
    k2, n = b.shape[-2:]
    if k != k2:
        raise ValueError(f"matmul: shapes {tuple(a.shape)} x "
                         f"{tuple(b.shape)} do not contract")
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    a3, b3 = as_batched(a, batch), as_batched(b, batch)
    if a3.shape[0] * m * n == 0:
        return torch.empty((*batch, m, n), dtype=out_dtype, device=a.device)
    with torch.cuda.device(a.device):
        out = launch_matmul(a3, b3, out_dtype, stream_of(a))
    return out.reshape(*batch, m, n)


matmul_cuda.launches = 0


def launch_matmul(a3: torch.Tensor, b3: torch.Tensor,
                  out_dtype: torch.dtype, stream: int) -> torch.Tensor:
    """One K1 launch, counted on ``matmul_cuda``, for operands that are
    already checked: (batch, m, k) and (batch, k, n) of one type the kernel
    takes, on the current CUDA device, unit column stride."""
    batch, m, k = a3.shape
    n = b3.shape[-1]
    out = torch.empty((batch, m, n), dtype=out_dtype, device=a3.device)
    _build.extension().matmul(
        a3.data_ptr(), b3.data_ptr(), out.data_ptr(), _CODES[a3.dtype],
        _CODES[out_dtype], batch, m, n, k, a3.stride(0), a3.stride(1),
        b3.stride(0), b3.stride(1), out.stride(0), out.stride(1), stream)
    matmul_cuda.launches += 1
    return out


def matmul(a: torch.Tensor, b: torch.Tensor, *,
           out_dtype: Optional[torch.dtype] = None,
           tiles: Optional[TilePlan] = None) -> torch.Tensor:
    """C = A @ B for any (..., M, K) x (..., K, N).

    ``tiles`` is a matmul :class:`TilePlan` (dims bm/bn/bk).  Its family is
    checked as the reference checks it, but its blocks are VMEM choices of
    the TPU kernel and set nothing here: K1's CTA tile is its own.
    """
    out_dtype = out_dtype or a.dtype
    if tiles is not None and tiles.kernel != "matmul":
        raise ValueError(f"TilePlan for {tiles.kernel!r} passed to matmul")
    m, k = a.shape[-2:]
    n = b.shape[-1]
    if min(m, n, k) < 128:
        return matmul_ref(a, b, out_dtype=out_dtype)
    return matmul_cuda(a, b, out_dtype=out_dtype)
