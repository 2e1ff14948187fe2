"""Blocked triangular solve built from the diagonal-block kernel (K2) and
the matmul kernel (K1): all O(n^3) off-diagonal work is dgemm-shaped."""

from __future__ import annotations

from typing import Optional

import torch

from .. import _build
from ..common import TilePlan, as_batched, check_cuda, stream_of, tile_block
from ..matmul.ops import matmul
from .ref import trsm_diag_ref, trsm_ref


def trsm_diag_cuda(u: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K2 (``csrc/trsm.cu``), the counterpart of the reference's
    ``trsm_diag_pallas``: X U = B for one (nb, nb) upper-triangular block U
    and B (..., M, nb), batched over leading dimensions.  CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise."""
    if u.device.type == "cpu" and b.device.type == "cpu":
        return trsm_diag_ref(u, b)
    check_cuda("trsm_diag", (torch.float32,), u, b)
    nb = u.shape[-1]
    m = b.shape[-2]
    if u.shape[-2] != nb or b.shape[-1] != nb:
        raise ValueError(f"trsm_diag: U {tuple(u.shape)} and B "
                         f"{tuple(b.shape)} do not match")
    batch = torch.broadcast_shapes(u.shape[:-2], b.shape[:-2])
    u3, b3 = as_batched(u, batch), as_batched(b, batch)
    x = torch.empty((b3.shape[0], m, nb), dtype=b.dtype, device=b.device)
    if x.numel():
        with torch.cuda.device(b.device):
            _build.extension().trsm_diag(
                u3.data_ptr(), b3.data_ptr(), x.data_ptr(), x.shape[0], m,
                nb, u3.stride(0), u3.stride(1), b3.stride(0), b3.stride(1),
                x.stride(0), x.stride(1), stream_of(b))
        trsm_diag_cuda.launches += 1
    return x.reshape(*batch, m, nb)


trsm_diag_cuda.launches = 0


def trsm(u: torch.Tensor, b: torch.Tensor, *, block: int = 256,
         tiles: Optional[TilePlan] = None,
         mm_tiles: Optional[TilePlan] = None) -> torch.Tensor:
    """Solve X U = B; U (..., n, n) upper-triangular, B (..., m, n).

    ``tiles`` (a trsm :class:`TilePlan`, dim ``block``) overrides the block
    size; ``mm_tiles`` is threaded to the trailing-update products.  The
    trailing updates are applied in place to a copy of B.
    """
    block = tile_block(tiles, "trsm", "block", block)
    n = u.shape[-1]
    m = b.shape[-2]
    if n % block != 0 or m % 128 != 0 or n < block:
        return trsm_ref(u, b)
    b_cur = b.clone()
    x = torch.empty_like(b)
    for j0 in range(0, n, block):
        j1 = j0 + block
        xj = trsm_diag_cuda(u[..., j0:j1, j0:j1], b_cur[..., :, j0:j1])
        x[..., :, j0:j1] = xj
        if j1 < n:
            # trailing update: B_:,k -= X_:,j @ U_j,k  for k > j (one dgemm)
            b_cur[..., :, j1:] -= matmul(xj, u[..., j0:j1, j1:],
                                         out_dtype=b_cur.dtype,
                                         tiles=mm_tiles)
    return x
