"""Plain PyTorch version of the matmul kernel (K1): C = A @ B with fp32
accumulation, written in ``out_dtype``.

It is both the wrapper's path for small problems (the product the
reference leaves to XLA) and the yardstick the kernel is held to.  Callers
that compare on the card keep ``torch.backends.cuda.matmul.allow_tf32``
False (PyTorch's default), so the product runs in IEEE fp32."""

import torch


def matmul_ref(a, b, out_dtype=None):
    out_dtype = out_dtype or a.dtype
    return torch.matmul(a.to(torch.float32),
                        b.to(torch.float32)).to(out_dtype)
