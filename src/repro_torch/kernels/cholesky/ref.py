"""Plain PyTorch versions for the Cholesky factor L L^T = A.

``cholesky_block_ref`` is the plain version of K3: nb steps of square-root
pivot, column scale and rank-1 trailing update in fp32, then the upper
triangle zeroed, over any leading batch dimensions.

``cholesky_ref`` is the wrapper's path when the blocked factor does not
apply, the counterpart of the reference's library factorization."""

import torch


def cholesky_block_ref(a):
    x = a.to(torch.float32).clone()
    for k in range(x.shape[-1]):
        d = torch.sqrt(x[..., k:k + 1, k:k + 1])
        x[..., k:, k:k + 1] /= d
        col = x[..., k + 1:, k:k + 1]
        x[..., k + 1:, k + 1:] -= col @ col.mT
    return torch.tril(x).to(a.dtype)


def cholesky_ref(a):
    return torch.linalg.cholesky(a.to(torch.float32)).to(a.dtype)
