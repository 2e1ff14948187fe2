"""Blocked Cholesky (right-looking) composed from all three kernels:
diagonal factor (K3), panel solve (K2: L_ij L_jj^T = A_ij), trailing syrk
update (K1).  The same composition (``blocked_factor``) serves twice: in
``cholesky`` over the whole matrix, and inside ``cholesky_block_cuda`` for
a block wider than one K3 launch holds."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .. import _build
from ..common import TilePlan, as_batched, check_cuda, stream_of, tile_block
from ..matmul.ops import cta_tile, launch_matmul, matmul
from ..trsm.ops import launch_trsm_diag, trsm
from .ref import cholesky_block_ref, cholesky_ref

# the widest block one K3 launch factors (ONE_CTA_MAX in csrc/cholesky.cu:
# its packed triangle fills a CTA's shared memory)
ONE_CTA_MAX = 336
# the diagonal blocks of the composition that factors a wider block
SUB_BLOCK = 256


def blocked_factor(a: torch.Tensor, block: int, factor: Callable,
                   solve: Callable, product: Callable) -> torch.Tensor:
    """L with L L^T = A (..., n, n), right-looking by panels of ``block``
    columns (the last may be narrower): ``factor(A_jj, L_jj)`` writes the
    diagonal block's factor into the view L_jj, ``solve(U, B, X)`` the
    panel X U = B with U = L_jj^T into the view X, and ``product(X, Y)``
    returns the trailing syrk, subtracted in place from a copy of A."""
    n = a.shape[-1]
    acc = a.clone()
    out = torch.zeros_like(a)
    for j0 in range(0, n, block):
        j1 = min(j0 + block, n)
        ljj = out[..., j0:j1, j0:j1]
        factor(acc[..., j0:j1, j0:j1], ljj)
        if j1 < n:
            # panel: L_ij = A_ij (L_jj^T)^{-1}  =>  X U = B with U = L_jj^T
            l_panel = out[..., j1:, j0:j1]
            solve(ljj.mT, acc[..., j1:, j0:j1], l_panel)
            # trailing syrk: A_trail -= L_panel @ L_panel^T
            acc[..., j1:, j1:] -= product(l_panel, l_panel.mT)
    return out


def _launch(a3: torch.Tensor, stream: int,
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One K3 launch on checked (batch, nb, nb) blocks with
    nb <= ONE_CTA_MAX on the current device, into ``out`` (any row stride)
    or a new tensor; not counted (``cholesky_block_cuda`` counts its
    calls)."""
    if out is None:
        out = torch.empty(a3.shape, dtype=a3.dtype, device=a3.device)
    _build.extension().cholesky_block(
        a3.data_ptr(), out.data_ptr(), out.shape[0], out.shape[-1],
        a3.stride(0), a3.stride(1), out.stride(0), out.stride(1), stream)
    return out


def cholesky_block_cuda(a: torch.Tensor) -> torch.Tensor:
    """K3 (``csrc/cholesky.cu``), the counterpart of the reference's
    ``cholesky_block_pallas``: L with L L^T = A for one SPD block
    (..., nb, nb), batched over leading dimensions.  CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise.

    A block wider than ``ONE_CTA_MAX`` is factored by ``blocked_factor``
    from hand-written kernels alone: K3 on diagonal blocks of
    ``SUB_BLOCK``, K2 on each panel, K1 for each trailing update.  Such a
    call counts once here, and its K2 and K1 launches count on their own
    wrappers."""
    if a.device.type == "cpu":
        return cholesky_block_ref(a)
    check_cuda("cholesky_block", (torch.float32,), a)
    nb = a.shape[-1]
    if a.shape[-2] != nb:
        raise ValueError(f"cholesky_block: A {tuple(a.shape)} not square")
    batch = a.shape[:-2]
    a3 = as_batched(a, batch)
    if a3.numel() == 0:
        return torch.empty_like(a)
    stream = stream_of(a)
    with torch.cuda.device(a.device):
        if nb <= ONE_CTA_MAX:
            out = _launch(a3, stream)
        else:
            # the operands below are checked by construction, so the
            # launches skip their wrappers' checks
            out = blocked_factor(
                a3, SUB_BLOCK, lambda x, o: _launch(x, stream, o),
                lambda u, b, o: launch_trsm_diag(u.contiguous(), b, stream,
                                                 o),
                lambda x, y: launch_matmul(x, y.contiguous(), x.dtype,
                                           stream, cta_tile(None)))
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
    return blocked_factor(
        a, block, lambda x, o: o.copy_(cholesky_block_cuda(x)),
        lambda u, b, o: o.copy_(trsm(u, b, block=block, mm_tiles=mm_tiles)),
        lambda x, y: matmul(x, y, out_dtype=a.dtype, tiles=mm_tiles))
