from .ops import slstm_scan, slstm_scan_bwd_cuda, slstm_scan_cuda
from .ref import slstm_scan_bwd_ref, slstm_scan_ref, slstm_scan_states_ref
