"""Public wrapper for the sLSTM recurrence kernel (K6), a port-side kernel
with no Pallas counterpart: the reference runs the recurrence as a scan
over time, which the plain PyTorch loop would drive from the host."""

from __future__ import annotations

import torch

from .. import _build
from ..common import stream_of
from .ref import slstm_scan_ref


def slstm_scan_cuda(z: torch.Tensor, i: torch.Tensor, f: torch.Tensor,
                    o: torch.Tensor) -> torch.Tensor:
    """K6 (``csrc/slstm.cu``): z, i, f, o (B, S, W) -> y (B, S, W), fp32.
    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise: the binding refuses inputs that are not fp32, contiguous and of
    one shape on one device, and nothing is copied or converted here."""
    if all(t.device.type == "cpu" for t in (z, i, f, o)):
        return slstm_scan_ref(z, i, f, o)
    y = torch.empty(z.shape, dtype=torch.float32, device=z.device)
    if y.numel():
        with torch.cuda.device(z.device):
            _build.extension().slstm_scan(z, i, f, o, y, stream_of(z))
        slstm_scan_cuda.launches += 1
    return y


slstm_scan_cuda.launches = 0


def slstm_scan(z: torch.Tensor, i: torch.Tensor, f: torch.Tensor,
               o: torch.Tensor) -> torch.Tensor:
    """z, i, f, o: the (B, S, W) fp32 pre-activations of the cell input and
    of the input, forget and output gates.  Returns y (B, S, W) fp32."""
    if z.ndim != 3 or any(t.shape != z.shape for t in (i, f, o)):
        raise ValueError(f"slstm_scan: z, i, f, o must be (B, S, W) alike, "
                         f"got {[tuple(t.shape) for t in (z, i, f, o)]}")
    return slstm_scan_cuda(z, i, f, o)
