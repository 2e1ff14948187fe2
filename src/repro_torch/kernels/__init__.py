"""Hand-written CUDA kernels (sm_90a): the linalg hot spots (K1-K3), the
LM prefill's attention and scan (K4, K5) and the sLSTM recurrence (K6, a
port-side kernel with no Pallas counterpart).

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
from .flash_attention import (flash_attention, flash_attention_cuda,
                              flash_attention_ref)
from .ssm_scan import ssm_scan, ssm_scan_cuda, ssm_scan_ref
from .slstm import slstm_scan, slstm_scan_cuda, slstm_scan_ref

LAUNCH_COUNTED = (matmul_cuda, trsm_diag_cuda, cholesky_block_cuda,
                  flash_attention_cuda, ssm_scan_cuda, slstm_scan_cuda)


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for fn in LAUNCH_COUNTED:
        fn.launches = 0


def launches() -> dict:
    """Launch count of each kernel since the last reset."""
    return {fn.__name__: fn.launches for fn in LAUNCH_COUNTED}
