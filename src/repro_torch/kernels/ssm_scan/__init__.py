from .ops import ssm_scan, ssm_scan_cuda
from .ref import ssm_scan_ref
