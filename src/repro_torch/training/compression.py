"""Error-feedback int8 gradient compression for the cross-pod axis.

Within a pod, gradients reduce at full precision; across pods the mean is
taken over int8-quantized gradients with one scale a tensor and an
error-feedback buffer that re-injects the quantization residual the next
step (Seide et al. 2014; Karimireddy et al. 2019).  Each pod quantizes its
local mean gradient, all-gathers the int8 payload, dequantizes and averages
locally.

The port runs on one device: with one pod the mean is the input, as in the
reference.  The all-gather across pods needs the multi-device backend,
which is not ported yet.
"""

from __future__ import annotations

from typing import Any, Mapping, Tuple

import torch


def _quantize(x: torch.Tensor, *, dtype=torch.int8):
    amax = torch.max(torch.abs(x)) + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(dtype)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_pod_mean(grads: Any, err: Any, pods: int = 1) -> Tuple[Any, Any]:
    """Mean over ``pods`` pods with int8 and error feedback: (mean grads,
    new error buffers).  One pod returns its inputs unchanged."""
    if pods == 1:
        return grads, err
    raise NotImplementedError(
        f"compress_pod_mean over {pods} pods: the all-gather across pods "
        "needs the multi-device torch.distributed backend, which the port "
        "does not have yet")


def init_error_buffers(grads: Mapping[str, torch.Tensor]
                       ) -> Mapping[str, torch.Tensor]:
    """fp32 zeros shaped like each gradient."""
    return {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for k, g in grads.items()}
