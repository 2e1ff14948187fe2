"""Public wrappers for the sLSTM recurrence kernel (K6) and its backward, a
port-side kernel with no Pallas counterpart: the reference runs the
recurrence as a scan over time, which the plain PyTorch loop would drive
from the host.

The launches are the operators ``torch.ops.repro_torch.slstm_scan`` and
``slstm_scan_bwd``: on CUDA tensors they launch K6, on ``meta`` tensors
they give the outputs' shapes and types, and a flop counter reads their
work from :func:`slstm_scan_flops`.  With no dispatch mode active, CUDA
operands skip the operators and launch K6 straight
(``common.launch_directly``).  The forward's fp32 workspace is made before
its operator, so a counted run sees it on either device."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from .. import _build
from ..common import launch_directly, stream_of
from .ref import slstm_scan_bwd_ref, slstm_scan_ref, slstm_scan_states_ref

# steps a chunk of the forward's scan (csrc/slstm.cu): at xlstm-350m's
# train shape (B 1, S 1024, W 1024) too few threads fill the card, so the
# chunk's length bounds the time, and 32 beats 64; at its prefill shape
# (B 4, S 4096) 16 to 128 are within a few per cent (chip_profile.py)
CHUNK = 32


#: operations a step and feature of K6's forward and of its backward (each
#: exp, log1p and tanh as one; the bounds of ``chip_smoke.py`` and PERF.md)
FWD_OPS, BWD_OPS = 27.0, 60.0


def slstm_scan_flops(b: int, s: int, w: int, *, backward: bool = False
                     ) -> float:
    return (BWD_OPS if backward else FWD_OPS) * b * s * w


def slstm_scan_workspace(b: int, s: int, w: int, chunk: int = CHUNK) -> int:
    """Floats of K6's fp32 workspace, as ``repro_slstm_scan_workspace``
    (csrc/slstm.cu) asks: a summary of four floats a row, chunk and
    feature."""
    if min(b, s, w, chunk) < 1:
        return 0
    return 4 * b * -(-s // chunk) * w


def _launch(z: torch.Tensor, i: torch.Tensor, f: torch.Tensor,
            o: torch.Tensor, work: torch.Tensor, states: bool
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                       torch.Tensor]:
    """K6 through the fp32 workspace ``work``: (y, c, n, m), the states
    empty (0,) unless ``states``.  The binding checks the inputs' type,
    layout, shapes and device, and the workspace's size."""
    y = torch.empty(z.shape, dtype=torch.float32, device=z.device)
    # the binding takes empty c, n, m for "no states"
    saved = tuple(torch.empty(z.shape if states else (0,),
                              dtype=torch.float32, device=z.device)
                  for _ in range(3))
    if y.numel():
        with torch.cuda.device(z.device):
            _build.extension().slstm_scan(z, i, f, o, y, *saved, work,
                                          CHUNK, stream_of(z))
        slstm_scan_cuda.launches += 1
    return (y, *saved)


_op = torch.library.custom_op("repro_torch::slstm_scan", _launch,
                              mutates_args=("work",))


@_op.register_fake
def _(z, i, f, o, work, states):
    return (torch.empty_like(z, dtype=torch.float32),
            *(z.new_empty(z.shape if states else (0,), dtype=torch.float32)
              for _ in range(3)))


@register_flop_formula(torch.ops.repro_torch.slstm_scan)
def _(z_shape, *args, out_shape=None, **kwargs) -> int:
    return slstm_scan_flops(*z_shape)


def _launch_bwd(z: torch.Tensor, i: torch.Tensor, f: torch.Tensor,
                o: torch.Tensor, c: torch.Tensor, n: torch.Tensor,
                m: torch.Tensor, dy: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """K6's backward: (dz, di, df, do), the inputs checked by the
    binding."""
    ins = (z, i, f, o, c, n, m, dy)
    grads = tuple(torch.empty(z.shape, dtype=torch.float32, device=z.device)
                  for _ in range(4))
    if z.numel():
        with torch.cuda.device(z.device):
            _build.extension().slstm_scan_bwd(*ins, *grads, stream_of(z))
        slstm_scan_bwd_cuda.launches += 1
    return grads


_op_bwd = torch.library.custom_op("repro_torch::slstm_scan_bwd", _launch_bwd,
                                  mutates_args=())


@_op_bwd.register_fake
def _(z, i, f, o, c, n, m, dy):
    return tuple(torch.empty_like(z, dtype=torch.float32) for _ in range(4))


@register_flop_formula(torch.ops.repro_torch.slstm_scan_bwd)
def _(z_shape, *args, out_shape=None, **kwargs) -> int:
    return slstm_scan_flops(*z_shape, backward=True)


def slstm_scan_cuda(z: torch.Tensor, i: torch.Tensor, f: torch.Tensor,
                    o: torch.Tensor, *, states: bool = False):
    """K6 (``csrc/slstm.cu``): z, i, f, o (B, S, W) -> y (B, S, W), fp32,
    or (y, c, n, m) with the state after every step when ``states`` (what
    the backward reads).  CPU tensors take the plain version; CUDA tensors
    launch the kernel (three CUDA launches in chunks of ``CHUNK`` steps
    through an fp32 workspace allocated here, one count) or raise: the
    binding refuses inputs that are not fp32, contiguous and of one shape
    on one device, and nothing is copied or converted here.  Meta tensors
    take the kernel's shapes (a counted run)."""
    if all(t.device.type == "cpu" for t in (z, i, f, o)):
        if states:
            return slstm_scan_states_ref(z, i, f, o)
        return slstm_scan_ref(z, i, f, o)
    work = torch.empty(slstm_scan_workspace(*z.shape), dtype=torch.float32,
                       device=z.device)
    launch = _launch if launch_directly(z) else _op
    y, *saved = launch(z, i, f, o, work, bool(states))
    return (y, *saved) if states else y


slstm_scan_cuda.launches = 0


def slstm_scan_bwd_cuda(z, i, f, o, c, n, m, dy):
    """K6's backward (``csrc/slstm.cu``): from the inputs, the per-step
    state (c, n, m) of ``slstm_scan_cuda(..., states=True)`` and dy, all
    (B, S, W) fp32 -> (dz, di, df, do).  CPU tensors take the plain version
    (``slstm_scan_bwd_ref``); CUDA tensors launch the kernel or raise: the
    binding refuses tensors that are not fp32, contiguous and of one shape
    on one device.  Meta tensors take the kernel's shapes (a counted
    run)."""
    ins = (z, i, f, o, c, n, m, dy)
    if all(t.device.type == "cpu" for t in ins):
        return slstm_scan_bwd_ref(*ins)
    launch = _launch_bwd if launch_directly(z) else _op_bwd
    return tuple(launch(*ins))


slstm_scan_bwd_cuda.launches = 0


def slstm_scan(z: torch.Tensor, i: torch.Tensor, f: torch.Tensor,
               o: torch.Tensor) -> torch.Tensor:
    """z, i, f, o: the (B, S, W) fp32 pre-activations of the cell input and
    of the input, forget and output gates.  Returns y (B, S, W) fp32."""
    if z.ndim != 3 or any(t.shape != z.shape for t in (i, f, o)):
        raise ValueError(f"slstm_scan: z, i, f, o must be (B, S, W) alike, "
                         f"got {[tuple(t.shape) for t in (z, i, f, o)]}")
    return slstm_scan_cuda(z, i, f, o)
