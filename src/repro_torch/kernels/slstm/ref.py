"""Plain PyTorch version of the sLSTM recurrence (K6): the reference's
``_slstm_step`` applied step by step along the sequence, the state
(c, n, m) in fp32 and starting at 0 (``m`` too, as the reference's
``init_slstm_state`` has it).

It is both the wrapper's path for CPU tensors and the yardstick the kernel
is held to."""

import torch
import torch.nn.functional as F


def slstm_scan_ref(z, i, f, o):
    """z, i, f, o: (B, S, W) fp32 pre-activations -> y (B, S, W) fp32."""
    b, s, w = z.shape
    c = torch.zeros((b, w), dtype=torch.float32, device=z.device)
    n = torch.zeros_like(c)
    m = torch.zeros_like(c)
    y = torch.empty((b, s, w), dtype=torch.float32, device=z.device)
    for t in range(s):
        log_f = F.logsigmoid(f[:, t])
        m_new = torch.maximum(log_f + m, i[:, t])
        i_st = torch.exp(i[:, t] - m_new)
        f_st = torch.exp(log_f + m - m_new)
        c = f_st * c + i_st * torch.tanh(z[:, t])
        n = f_st * n + i_st
        y[:, t] = torch.sigmoid(o[:, t]) * c / torch.clamp(n, min=1.0)
        m = m_new
    return y
