"""Public wrapper for the matmul kernel (K1): any (..., M, K) x (..., K, N)
with broadcast leading dimensions (the stacked ranks of a process grid run
as one batched launch), the plain version for problems where
min(M, N, K) < 128.

The tile plan picks K1's CTA tile by one rule, :func:`cta_tile`: each edge
of the CTA's tile of C is half the plan's block on that axis, rounded down
to a power of two and clamped to the compiled range (BM in [64, 256], BN in
[64, 128]); ``bk`` has no counterpart, because K1's ring steps through K in
stages of 32 whatever the plan.  No plan, or the heuristic plan (256, 256,
512), gives the default 128 x 128; every plan ``perf/kernel.py::
candidate_tiles("matmul", ...)`` emits gives one of :data:`CTA_TILES`, and
a larger block never gives a smaller edge.  Every tile sums each element's
products in the same order, so the tile changes the time, not the bits.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Optional, Tuple

import torch

from .. import _build
from ..common import TilePlan, as_batched, check_cuda, stream_of
from .ref import matmul_ref

_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: the CTA tiles (BM, BN) of K1's fp32 body that ``csrc/matmul_f32.cuh``
#: lists (``with_tile``), each compiled in ``csrc/matmul_tile_<BM>x<BN>.cu``;
#: bf16 inputs take the default request alone (no plan reaches them)
CTA_TILES = ((64, 64), (64, 128), (128, 64), (128, 128), (256, 64),
             (256, 128))
DEFAULT_CTA_TILE = (128, 128)

#: K1's bodies by the code the launcher reports (``csrc/kernels.h``): fp32
#: inputs' FFMA body; bf16 inputs' tensor-core body (``csrc/
#: matmul_bf16.cu``, wgmma on TMA tiles), which takes every bf16 operand
#: (:func:`tma_staged` copies those TMA cannot load)
BODIES = ("fp32", "bf16_wgmma")


def _edge(block: int, most: int) -> int:
    """Half of ``block``, rounded down to a power of two, in [64, most]."""
    half = max(int(block) // 2, 1)
    return min(max(1 << (half.bit_length() - 1), 64), most)


def cta_tile(tiles: Optional[TilePlan]) -> Tuple[int, int]:
    """K1's CTA tile (BM, BN) for a matmul :class:`TilePlan` (the rule in
    the module docstring); the default for ``None``.  Raises for a plan of
    another kernel family."""
    if tiles is None:
        return DEFAULT_CTA_TILE
    if tiles.kernel != "matmul":
        raise ValueError(f"TilePlan for {tiles.kernel!r} passed to matmul")
    return _edge(tiles["bm"], 256), _edge(tiles["bn"], 128)


def tma_loadable(x: torch.Tensor) -> bool:
    """Whether K1's bf16 body loads the (batch, rows, cols) operand ``x`` as
    it lies: a 16-byte aligned start, and row and batch strides that are
    multiples of 8 elements (16 bytes; a batch stride of 0, one matrix
    shared by the batch, is one).  The launcher's own test, from the
    storage offset: the allocator aligns every storage's base."""
    return ((x.storage_offset() * x.element_size()) % 16 == 0
            and x.stride(0) % 8 == 0 and x.stride(1) % 8 == 0)


def tma_staged(x: torch.Tensor) -> torch.Tensor:
    """``x`` (batch, rows, cols, unit column stride) as K1's bf16 body
    loads it: ``x`` itself where :func:`tma_loadable`, else a copy into a
    fresh buffer whose rows are ``cols`` rounded up to a multiple of 8
    elements, viewed back to (batch, rows, cols), with a batch stride of
    rows times that, or 0 where ``x`` shares one matrix across the batch.
    The padding is never read as data: the tensor map's extents are the
    logical ``cols`` and ``rows``."""
    if tma_loadable(x):
        return x
    batch, rows, cols = x.shape
    ld = -(-cols // 8) * 8
    shared = x.stride(0) == 0
    buf = torch.empty((1 if shared else batch, rows, ld), dtype=x.dtype,
                      device=x.device)[..., :cols]
    buf.copy_(x[:1] if shared else x)
    return buf.expand(batch, rows, cols) if shared else buf


def matmul_cuda(a: torch.Tensor, b: torch.Tensor, *,
                out_dtype: Optional[torch.dtype] = None,
                tile: Tuple[int, int] = DEFAULT_CTA_TILE) -> torch.Tensor:
    """K1 (``csrc/matmul.cu``), the counterpart of the reference's
    ``matmul_pallas``: C = A @ B with fp32 accumulation, fp32 inputs at
    the CTA tile ``tile`` (one of :data:`CTA_TILES`), bf16 inputs on the
    tensor cores (``tile`` the default; ``csrc/matmul_bf16.cu``), each
    operand TMA cannot load staged first (:func:`tma_staged`).  CPU tensors
    take the plain version; CUDA tensors launch the kernel or raise.  K = 0
    gives zeros without a launch (none counted)."""
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
    if k * m * n * math.prod(batch) == 0:
        return torch.zeros((*batch, m, n), dtype=out_dtype, device=a.device)
    a3, b3 = as_batched(a, batch), as_batched(b, batch)
    if a3.dtype == torch.bfloat16:
        a3, b3 = tma_staged(a3), tma_staged(b3)
    with torch.cuda.device(a.device):
        out = launch_matmul(a3, b3, out_dtype, stream_of(a), tile)
    return out.reshape(*batch, m, n)


matmul_cuda.launches = 0
#: launches by body (:data:`BODIES`); their sum is ``launches``
matmul_cuda.launches_by_body = Counter()
#: the fp32 body's launches by CTA tile (BM, BN); their sum is
#: ``launches_by_body["fp32"]``
matmul_cuda.launches_by_tile = Counter()


def launch_matmul(a3: torch.Tensor, b3: torch.Tensor,
                  out_dtype: torch.dtype, stream: int,
                  tile: Tuple[int, int]) -> torch.Tensor:
    """One K1 launch at the CTA tile ``tile``, counted on ``matmul_cuda``
    (also by the body the launcher ran, and the fp32 body's by tile), for
    operands that are already checked: (batch, m, k) and (batch, k, n) of
    one type the kernel takes, on the current CUDA device, unit column
    stride; bf16 operands as :func:`tma_staged` gives them.  The launcher
    refuses a tile it does not compile, a bf16 launch at any tile but the
    default, and bf16 operands TMA cannot load."""
    batch, m, k = a3.shape
    n = b3.shape[-1]
    out = torch.empty((batch, m, n), dtype=out_dtype, device=a3.device)
    body = BODIES[_build.extension().matmul(
        a3.data_ptr(), b3.data_ptr(), out.data_ptr(), _CODES[a3.dtype],
        _CODES[out_dtype], batch, m, n, k, a3.stride(0), a3.stride(1),
        b3.stride(0), b3.stride(1), out.stride(0), out.stride(1), tile[0],
        tile[1], stream)]
    matmul_cuda.launches += 1
    matmul_cuda.launches_by_body[body] += 1
    if body == "fp32":
        matmul_cuda.launches_by_tile[tuple(tile)] += 1
    return out


def matmul(a: torch.Tensor, b: torch.Tensor, *,
           out_dtype: Optional[torch.dtype] = None,
           tiles: Optional[TilePlan] = None) -> torch.Tensor:
    """C = A @ B for any (..., M, K) x (..., K, N).

    ``tiles`` is a matmul :class:`TilePlan` (dims bm/bn/bk); its family is
    checked as the reference checks it, and :func:`cta_tile` maps it onto
    K1's CTA tile (the default when omitted).  bf16 inputs run K1's bf16
    body, which takes no plan, whatever the plan.
    """
    out_dtype = out_dtype or a.dtype
    tile = cta_tile(tiles)
    m, k = a.shape[-2:]
    n = b.shape[-1]
    if min(m, n, k) < 128:
        return matmul_ref(a, b, out_dtype=out_dtype)
    if a.dtype == torch.bfloat16:
        tile = DEFAULT_CTA_TILE
    return matmul_cuda(a, b, out_dtype=out_dtype, tile=tile)
