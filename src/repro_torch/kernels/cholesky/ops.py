"""Blocked Cholesky (right-looking) composed from all three kernels:
diagonal factor (K3), panel solve (K2 through ``trsm``: L_ij L_jj^T =
A_ij), trailing syrk update (K1)."""

from __future__ import annotations

from typing import Optional

import torch

from .. import _build
from ..common import TilePlan, as_batched, check_cuda, stream_of, tile_block
from ..matmul.ops import matmul
from ..trsm.ops import trsm
from .ref import cholesky_block_ref, cholesky_ref


def cholesky_block_cuda(a: torch.Tensor) -> torch.Tensor:
    """K3 (``csrc/cholesky.cu``), the counterpart of the reference's
    ``cholesky_block_pallas``: L with L L^T = A for one SPD block
    (..., nb, nb), batched over leading dimensions.  CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise."""
    if a.device.type == "cpu":
        return cholesky_block_ref(a)
    check_cuda("cholesky_block", (torch.float32,), a)
    nb = a.shape[-1]
    if a.shape[-2] != nb:
        raise ValueError(f"cholesky_block: A {tuple(a.shape)} not square")
    batch = a.shape[:-2]
    a3 = as_batched(a, batch)
    out = torch.empty((a3.shape[0], nb, nb), dtype=a.dtype, device=a.device)
    if out.numel():
        with torch.cuda.device(a.device):
            _build.extension().cholesky_block(
                a3.data_ptr(), out.data_ptr(), out.shape[0], nb,
                a3.stride(0), a3.stride(1), out.stride(0), out.stride(1),
                stream_of(a))
        cholesky_block_cuda.launches += 1
    return out.reshape(*batch, nb, nb)


cholesky_block_cuda.launches = 0


def cholesky(a: torch.Tensor, *, block: int = 256,
             tiles: Optional[TilePlan] = None,
             mm_tiles: Optional[TilePlan] = None) -> torch.Tensor:
    """L with L L^T = A (A SPD, (..., n, n)).

    ``tiles`` (a cholesky :class:`TilePlan`, dim ``block``) overrides the
    panel width (the panel trsm necessarily solves at that width);
    ``mm_tiles`` is threaded to the dgemm-shaped trailing updates, which
    are applied in place to a copy of A.
    """
    block = tile_block(tiles, "cholesky", "block", block)
    n = a.shape[-1]
    if n % block != 0 or n <= block:
        if 8 <= n <= block:
            return cholesky_block_cuda(a)
        return cholesky_ref(a)
    acc = a.clone()
    out = torch.zeros_like(a)
    for j0 in range(0, n, block):
        j1 = j0 + block
        ljj = cholesky_block_cuda(acc[..., j0:j1, j0:j1])
        out[..., j0:j1, j0:j1] = ljj
        if j1 < n:
            # panel: L_ij = A_ij (L_jj^T)^{-1}  =>  X U = B with U = L_jj^T
            l_panel = trsm(ljj.mT, acc[..., j1:, j0:j1], block=block,
                           mm_tiles=mm_tiles)
            out[..., j1:, j0:j1] = l_panel
            # trailing syrk: A_trail -= L_panel @ L_panel^T
            acc[..., j1:, j1:] -= matmul(l_panel, l_panel.mT,
                                         out_dtype=acc.dtype, tiles=mm_tiles)
    return out
