"""Hand-written CUDA kernels (sm_90a) for the linalg hot spots.

Each kernel family keeps the reference's layout: ``ops.py`` holds the
launch wrapper (``*_cuda``, with its launch count on ``.launches``) and the
public blocked wrapper; ``ref.py`` the plain PyTorch versions; the CUDA
source is under ``csrc/``, built at first use by ``_build.py``.  A wrapper
given CPU tensors runs the plain version; given CUDA tensors it launches
the kernel or raises.
"""

from .common import TilePlan, heuristic_plan, pad_axes, round_up
from .matmul import matmul, matmul_cuda, matmul_ref
from .trsm import trsm, trsm_diag_cuda, trsm_diag_ref, trsm_ref
from .cholesky import (cholesky, cholesky_block_cuda, cholesky_block_ref,
                       cholesky_ref)

LAUNCH_COUNTED = (matmul_cuda, trsm_diag_cuda, cholesky_block_cuda)


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for fn in LAUNCH_COUNTED:
        fn.launches = 0


def launches() -> dict:
    """Launch count of each kernel since the last reset."""
    return {fn.__name__: fn.launches for fn in LAUNCH_COUNTED}
