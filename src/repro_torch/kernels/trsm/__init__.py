from .ops import trsm, trsm_diag_cuda
from .ref import trsm_diag_ref, trsm_ref
