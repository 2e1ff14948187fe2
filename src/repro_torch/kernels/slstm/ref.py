"""Plain PyTorch versions of the sLSTM recurrence (K6) and of its
backward: the reference's ``_slstm_step`` applied step by step along the
sequence, the state (c, n, m) in fp32 and starting at 0 (``m`` too, as the
reference's ``init_slstm_state`` has it), and the reverse-time loop that
carries its gradient.

They are the wrappers' paths for CPU tensors and the yardsticks the
kernels are held to; the step (:func:`slstm_step`) is also the one-token
sLSTM decode of ``models/ssm.py``.  Neither repeats the kernels' chunks."""

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


def slstm_scan_states_ref(z, i, f, o):
    """z, i, f, o: (B, S, W) fp32 pre-activations -> (y, c, n, m), each
    (B, S, W) fp32: the output and the state after every step, which the
    backward (:func:`slstm_scan_bwd_ref`, the kernel's backward) reads.
    The steps' results are stacked at the end (not written into one tensor
    step by step), so autograd differentiates the loop without a copy of
    the whole output a step."""
    b, s, w = z.shape
    c = torch.zeros((b, w), dtype=torch.float32, device=z.device)
    n = torch.zeros_like(c)
    m = torch.zeros_like(c)
    out = []
    for t in range(s):
        c, n, m, y = slstm_step(c, n, m, z[:, t], i[:, t], f[:, t], o[:, t])
        out.append((y, c, n, m))
    return tuple(torch.stack(ts, dim=1) for ts in zip(*out))


def slstm_scan_ref(z, i, f, o):
    """z, i, f, o: (B, S, W) fp32 pre-activations -> y (B, S, W) fp32."""
    return slstm_scan_states_ref(z, i, f, o)[0]


def _shifted(x):
    """x at t - 1 along the sequence, zeros at t = 0."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def slstm_scan_bwd_ref(z, i, f, o, c, n, m, dy):
    """The gradient of ``sum(y * dy)`` with respect to z, i, f, o, from the
    inputs, the per-step state (c, n, m) of :func:`slstm_scan_states_ref`
    and dy, all (B, S, W) fp32 -> (dz, di, df, do).

    The step-local parts are taken for every step at once; a loop from the
    last step to the first carries (dc, dn, dm) from t + 1.  With c_p, n_p,
    m_p the state at t - 1 (0 at t = 0), th = tanh z, g = sigmoid o,
    d = max(n, 1), a = log_sigmoid(f) + m_p, fs = exp(a - m) and
    is = exp(i - m)::

        dct = dc + dy g / d             dnt = dn - dy g c / d^2 [n >= 1]
        do  = dy (c / d) g (1 - g)
        dfs = dct c_p + dnt n_p         dis = dct th + dnt
        dz  = dct is (1 - th^2)
        dml = dm - (dfs fs + dis is)    wa = [a > i] + 1/2 [a = i]
        da  = dfs fs + dml wa           di = dis is + dml (1 - wa)
        df  = da sigmoid(-f)
        dm <- da,  dc <- dct fs,  dn <- dnt fs

    The tie rules are autograd's: ``torch.maximum`` splits the gradient
    in half at a = i, ``torch.clamp(min=1)`` passes it at n = 1."""
    th = torch.tanh(z)
    g = torch.sigmoid(o)
    d = torch.clamp(n, min=1.0)
    c_p, n_p = _shifted(c), _shifted(n)
    a = F.logsigmoid(f) + _shifted(m)
    fs = torch.exp(a - m)
    is_ = torch.exp(i - m)
    wa = (a > i).float() + 0.5 * (a == i).float()
    y_c = dy * g / d
    y_n = torch.where(n >= 1.0, dy * g * c / (d * d), torch.zeros_like(n))
    d_o = dy * (c / d) * g * (1.0 - g)
    sig_nf = torch.sigmoid(-f)
    dz, di, df = (torch.empty_like(z) for _ in range(3))
    dc = torch.zeros_like(z[:, 0])
    dn = torch.zeros_like(dc)
    dm = torch.zeros_like(dc)
    for t in range(z.shape[1] - 1, -1, -1):
        dct = dc + y_c[:, t]
        dnt = dn - y_n[:, t]
        dfs = dct * c_p[:, t] + dnt * n_p[:, t]
        dis = dct * th[:, t] + dnt
        dml = dm - (dfs * fs[:, t] + dis * is_[:, t])
        da = dfs * fs[:, t] + dml * wa[:, t]
        dz[:, t] = dct * is_[:, t] * (1.0 - th[:, t] * th[:, t])
        di[:, t] = dis * is_[:, t] + dml * (1.0 - wa[:, t])
        df[:, t] = da * sig_nf[:, t]
        dm, dc, dn = da, dct * fs[:, t], dnt * fs[:, t]
    return dz, di, df, d_o
