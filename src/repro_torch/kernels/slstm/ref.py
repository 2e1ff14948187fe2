"""Plain PyTorch version of the sLSTM recurrence (K6): the reference's
``_slstm_step`` applied step by step along the sequence, the state
(c, n, m) in fp32 and starting at 0 (``m`` too, as the reference's
``init_slstm_state`` has it).

It is both the wrapper's path for CPU tensors and the yardstick the kernel
is held to; its step (:func:`slstm_step`) is also the one-token sLSTM
decode of ``models/ssm.py``."""

import torch
import torch.nn.functional as F


def slstm_step(c, n, m, z, i, f, o):
    """One step of the stabilised exponential-gating cell, per feature:
    the state (c, n, m) and the step's pre-activations z, i, f, o, all
    (B, W) fp32 -> (c, n, m, y)."""
    log_f = F.logsigmoid(f)
    m_new = torch.maximum(log_f + m, i)
    i_st = torch.exp(i - m_new)
    f_st = torch.exp(log_f + m - m_new)
    c = f_st * c + i_st * torch.tanh(z)
    n = f_st * n + i_st
    y = torch.sigmoid(o) * c / torch.clamp(n, min=1.0)
    return c, n, m_new, y


def slstm_scan_ref(z, i, f, o):
    """z, i, f, o: (B, S, W) fp32 pre-activations -> y (B, S, W) fp32."""
    b, s, w = z.shape
    c = torch.zeros((b, w), dtype=torch.float32, device=z.device)
    n = torch.zeros_like(c)
    m = torch.zeros_like(c)
    y = torch.empty((b, s, w), dtype=torch.float32, device=z.device)
    for t in range(s):
        c, n, m, y[:, t] = slstm_step(c, n, m, z[:, t], i[:, t], f[:, t],
                                      o[:, t])
    return y
