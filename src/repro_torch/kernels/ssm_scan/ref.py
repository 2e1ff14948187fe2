"""Plain PyTorch version of the scan kernel (K5): the recurrence
S_t = a_t S_{t-1} + k_t v_t^T, y_t = q_t . S_t step by step, the state in
fp32, written in q's type.

It is both the wrapper's path for short sequences and the yardstick the
kernel is held to."""

import torch


def ssm_scan_ref(q, k, v, log_a):
    """q, k: (BH, S, DK); v: (BH, S, DV); log_a: (BH, S)."""
    qf, kf, vf = (x.to(torch.float32) for x in (q, k, v))
    a = torch.exp(log_a.to(torch.float32))
    state = torch.zeros(q.shape[0], q.shape[-1], v.shape[-1],
                        dtype=torch.float32, device=q.device)
    y = torch.empty(v.shape, dtype=torch.float32, device=q.device)
    for t in range(q.shape[1]):
        state = (a[:, t, None, None] * state
                 + kf[:, t, :, None] * vf[:, t, None, :])
        y[:, t] = torch.einsum("bd,bdv->bv", qf[:, t], state)
    return y.to(q.dtype)
