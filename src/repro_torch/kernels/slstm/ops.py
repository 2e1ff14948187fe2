"""Public wrappers for the sLSTM recurrence kernel (K6) and its backward, a
port-side kernel with no Pallas counterpart: the reference runs the
recurrence as a scan over time, which the plain PyTorch loop would drive
from the host."""

from __future__ import annotations

import torch

from .. import _build
from ..common import stream_of
from .ref import slstm_scan_bwd_ref, slstm_scan_ref, slstm_scan_states_ref

# steps a chunk of the forward's scan (csrc/slstm.cu): at xlstm-350m's
# train shape (B 1, S 1024, W 1024) too few threads fill the card, so the
# chunk's length bounds the time, and 32 beats 64; at its prefill shape
# (B 4, S 4096) 16 to 128 are within a few per cent (chip_profile.py)
CHUNK = 32


def slstm_scan_cuda(z: torch.Tensor, i: torch.Tensor, f: torch.Tensor,
                    o: torch.Tensor, *, states: bool = False):
    """K6 (``csrc/slstm.cu``): z, i, f, o (B, S, W) -> y (B, S, W), fp32,
    or (y, c, n, m) with the state after every step when ``states`` (what
    the backward reads).  CPU tensors take the plain version; CUDA tensors
    launch the kernel (three CUDA launches in chunks of ``CHUNK`` steps
    through an fp32 workspace allocated here, one count) or raise: the
    binding refuses inputs that are not fp32, contiguous and of one shape
    on one device, and nothing is copied or converted here."""
    if all(t.device.type == "cpu" for t in (z, i, f, o)):
        if states:
            return slstm_scan_states_ref(z, i, f, o)
        return slstm_scan_ref(z, i, f, o)
    y = torch.empty(z.shape, dtype=torch.float32, device=z.device)
    # the binding takes empty c, n, m for "no states"
    saved = tuple(torch.empty(z.shape if states else (0,),
                              dtype=torch.float32, device=z.device)
                  for _ in range(3))
    if y.numel():
        with torch.cuda.device(z.device):
            ext = _build.extension()
            b, s, w = z.shape
            work = torch.empty(ext.slstm_scan_workspace(b, s, w, CHUNK),
                               dtype=torch.float32, device=z.device)
            ext.slstm_scan(z, i, f, o, y, *saved, work, CHUNK, stream_of(z))
        slstm_scan_cuda.launches += 1
    return (y, *saved) if states else y


slstm_scan_cuda.launches = 0


def slstm_scan_bwd_cuda(z, i, f, o, c, n, m, dy):
    """K6's backward (``csrc/slstm.cu``): from the inputs, the per-step
    state (c, n, m) of ``slstm_scan_cuda(..., states=True)`` and dy, all
    (B, S, W) fp32 -> (dz, di, df, do).  CPU tensors take the plain version
    (``slstm_scan_bwd_ref``); CUDA tensors launch the kernel or raise: the
    binding refuses tensors that are not fp32, contiguous and of one shape
    on one device."""
    ins = (z, i, f, o, c, n, m, dy)
    if all(t.device.type == "cpu" for t in ins):
        return slstm_scan_bwd_ref(*ins)
    grads = tuple(torch.empty(z.shape, dtype=torch.float32, device=z.device)
                  for _ in range(4))
    if z.numel():
        with torch.cuda.device(z.device):
            _build.extension().slstm_scan_bwd(*ins, *grads, stream_of(z))
        slstm_scan_bwd_cuda.launches += 1
    return grads


slstm_scan_bwd_cuda.launches = 0


def slstm_scan(z: torch.Tensor, i: torch.Tensor, f: torch.Tensor,
               o: torch.Tensor) -> torch.Tensor:
    """z, i, f, o: the (B, S, W) fp32 pre-activations of the cell input and
    of the input, forget and output gates.  Returns y (B, S, W) fp32."""
    if z.ndim != 3 or any(t.shape != z.shape for t in (i, f, o)):
        raise ValueError(f"slstm_scan: z, i, f, o must be (B, S, W) alike, "
                         f"got {[tuple(t.shape) for t in (z, i, f, o)]}")
    return slstm_scan_cuda(z, i, f, o)
