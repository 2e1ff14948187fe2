from .ops import cholesky, cholesky_block_cuda
from .ref import cholesky_block_ref, cholesky_ref
