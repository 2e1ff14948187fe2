from .ops import slstm_scan, slstm_scan_cuda
from .ref import slstm_scan_ref
