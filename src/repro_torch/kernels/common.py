"""Shared wrapper plumbing for the kernel families.

The tensor versions of the reference's ``round_up`` / ``pad_axes`` /
``tile_block`` (tile plans come from the port's copy of ``perf/kernel.py``),
and what every CUDA launch wrapper needs: operands flattened to one batch
dimension with unit column stride, and the pointer / stride / stream
integers the plain C launchers take.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import is_in_torch_dispatch_mode

from ..perf.kernel import (MIN_TILE, TilePlan, VMEM_BUDGET,
                           heuristic_matmul_blocks, heuristic_plan)

__all__ = [
    "MIN_TILE", "TilePlan", "VMEM_BUDGET", "heuristic_matmul_blocks",
    "heuristic_plan", "pad_axes", "round_up", "tile_block", "as_batched",
    "check_cuda", "stream_of", "launch_directly",
]


def round_up(x: int, m: int) -> int:
    """Smallest multiple of ``m`` that is >= ``x``."""
    return (x + m - 1) // m * m


def pad_axes(x: torch.Tensor, multiples: Mapping[int, int]) -> torch.Tensor:
    """Zero-pad ``x`` so every listed axis is a multiple of its block.

    ``multiples`` maps axis index -> block size.  Returns ``x`` unchanged
    (no copy at all) when every axis is already aligned.
    """
    width = [0] * (2 * x.ndim)      # F.pad order: last axis first
    for axis, m in multiples.items():
        axis = axis % x.ndim
        pad = round_up(x.shape[axis], m) - x.shape[axis]
        width[2 * (x.ndim - 1 - axis) + 1] = pad
    if not any(width):
        return x
    return F.pad(x, width)


def tile_block(tiles: Optional[TilePlan], kernel: str, dim: str,
               default: Union[int, Tuple[int, ...]]):
    """Block size for ``dim`` out of a plan, or the caller's default.

    Raises if the plan targets a different kernel family — a swapped
    plan would otherwise silently run with nonsense blocks.
    """
    if tiles is None:
        return default
    if tiles.kernel != kernel:
        raise ValueError(f"TilePlan for {tiles.kernel!r} passed to "
                         f"{kernel!r} wrapper")
    return tiles[dim]


def check_cuda(name: str, dtypes: Sequence[torch.dtype],
               *tensors: torch.Tensor, meta: bool = False) -> None:
    """Raise unless every tensor is on one CUDA device (or, with ``meta``,
    every one on the ``meta`` device: a counted run's stand-in for the
    card) in a type the kernel takes."""
    dev = tensors[0].device
    kinds = ("cuda", "meta") if meta else ("cuda",)
    for t in tensors:
        if t.device != dev or t.device.type not in kinds:
            raise ValueError(f"{name}: operands must share one CUDA device, "
                             f"got {[str(x.device) for x in tensors]}")
        if t.dtype not in dtypes:
            raise TypeError(f"{name}: dtype {t.dtype} not supported "
                            f"(kernel takes {list(dtypes)})")


def as_batched(x: torch.Tensor, batch: torch.Size) -> torch.Tensor:
    """``x`` broadcast to ``batch + x.shape[-2:]`` and viewed as one batch
    dimension, with unit column stride (copied only when it must be)."""
    x = x.expand(*batch, *x.shape[-2:]).reshape(-1, *x.shape[-2:])
    if x.stride(-1) != 1:
        x = x.contiguous()
    return x


def stream_of(x: torch.Tensor) -> int:
    """The current CUDA stream of ``x``'s device, as the integer the C
    launchers take."""
    return torch.cuda.current_stream(x.device).cuda_stream


def launch_directly(x: torch.Tensor) -> bool:
    """Whether a wrapper calls its kernel's launch function itself rather
    than through its ``torch.library`` operator: on CUDA operands with no
    dispatch mode active.  A counting mode (``core/roofline.py``), a flop
    counter or a fake-tensor trace sees only the operator, and pays its
    dispatch; a plain run on the card does not."""
    return x.is_cuda and not is_in_torch_dispatch_mode()
