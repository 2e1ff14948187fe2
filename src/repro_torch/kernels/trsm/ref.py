"""Plain PyTorch versions for the triangular solve X U = B.

``trsm_diag_ref`` is the plain version of K2: the column recurrence
x_k = (b_k - X[:, :k] U[:k, k]) / U[k, k] in fp32, written as it reads (one
matrix-vector product per column), over any leading batch dimensions.

``trsm_ref`` is the wrapper's path when the blocked solve does not apply,
the counterpart of the reference's library triangular solve."""

import torch


def trsm_diag_ref(u, b):
    uf = u.to(torch.float32)
    bf = b.to(torch.float32)
    x = torch.zeros_like(bf)
    for k in range(uf.shape[-1]):
        s = (x[..., :k] @ uf[..., :k, k:k + 1])[..., 0]
        x[..., k] = (bf[..., k] - s) / uf[..., k:k + 1, k]
    return x.to(b.dtype)


def trsm_ref(u, b):
    return torch.linalg.solve_triangular(u.to(b.dtype), b, upper=True,
                                         left=False)
