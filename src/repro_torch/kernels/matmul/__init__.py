from .ops import matmul, matmul_cuda
from .ref import matmul_ref
