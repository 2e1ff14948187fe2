"""K6's gradient on the CPU: the plain version of its backward kernel
(``kernels/slstm/ref.py::slstm_scan_bwd_ref``) against autograd through the
plain forward and against ``jax.grad`` of the reference's ``lax.scan`` of
``_slstm_step``; the forward's per-step states against the reference
scan's; and the model's K6 site (``models/ssm.py::SLSTMScan``), whose
backward now runs that plain version on CPU tensors instead of
differentiating the step loop.

Inputs are drawn with numpy from a seed and handed to both packages.
Tolerances, fp32: gradients and states within 1e-5 of each tensor's
largest entry.  Only the order of the sums and the elementary functions'
roundings differ; a row of a gradient can be all rounding residue (where
the forget gate's share cancels exactly in the true gradient), so the
error is taken against the whole tensor.  The cases open the gates that
matter: ``i`` x 30 (the stabiliser m carries the state), ``f`` + 6 (open
forget gates, so the state reaches far back).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models import ssm as ref_ssm
from repro_torch import kernels as tk
from repro_torch.kernels.slstm import ref as slstm_ref
from repro_torch.models import ssm

TOL = 1e-5
# (B, S, W, scale of i, shift of f)
CASES = [(2, 64, 16, 1.0, 0.0), (1, 300, 20, 1.0, 0.0),
         (2, 64, 16, 30.0, 0.0), (2, 128, 16, 1.0, 6.0),
         (1, 300, 20, 30.0, 6.0)]
IDS = ["b2s64", "b1s300w20", "i_x30", "f_plus6", "i_x30_f_plus6"]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _inputs(b, s, w, scale_i, shift_f, seed=0):
    """z, i, f, o and dy, (B, S, W) fp32 numpy."""
    rng = np.random.default_rng(seed)
    z, i, f, o, dy = (rng.standard_normal((b, s, w)).astype(np.float32)
                      for _ in range(5))
    return (z, (i * scale_i).astype(np.float32),
            (f + shift_f).astype(np.float32), o, dy)


def _torch(*xs):
    return [torch.from_numpy(x.copy()) for x in xs]


def _ref_scan(z, i, f, o):
    """The reference's ``lax.scan`` of ``_slstm_step`` from
    ``init_slstm_state`` on (B, S, W) operands -> (y, c, n, m), (B, S, W)."""
    b, _, w = z.shape

    def step(st, inp):
        st, y = ref_ssm._slstm_step(st, *inp)
        return st, (y, st.c, st.n, st.m)

    xs = tuple(jnp.transpose(x, (1, 0, 2)) for x in (z, i, f, o))
    _, outs = jax.lax.scan(step, ref_ssm.init_slstm_state(b, w), xs)
    return tuple(jnp.transpose(t, (1, 0, 2)) for t in outs)


def _ref_grads(z, i, f, o, dy):
    """``jax.grad`` of sum(y * dy) through the reference's scan."""
    def loss(z, i, f, o):
        return jnp.sum(_ref_scan(z, i, f, o)[0] * dy)

    return [np.asarray(g) for g in
            jax.grad(loss, argnums=(0, 1, 2, 3))(
                *(jnp.asarray(x) for x in (z, i, f, o)))]


def _bwd_ref(z, i, f, o, dy):
    """The plain backward on the plain forward's states."""
    _, c, n, m = slstm_ref.slstm_scan_states_ref(z, i, f, o)
    return slstm_ref.slstm_scan_bwd_ref(z, i, f, o, c, n, m, dy)


def _autograd(z, i, f, o, dy):
    ins = [t.clone().requires_grad_() for t in (z, i, f, o)]
    return torch.autograd.grad(slstm_ref.slstm_scan_ref(*ins), ins, dy)


@pytest.mark.parametrize("b,s,w,scale_i,shift_f", CASES, ids=IDS)
def test_bwd_ref_equals_autograd_through_the_plain_loop(b, s, w, scale_i,
                                                        shift_f):
    z, i, f, o, dy = _torch(*_inputs(b, s, w, scale_i, shift_f))
    got = _bwd_ref(z, i, f, o, dy)
    want = _autograd(z, i, f, o, dy)
    for name, g, wt in zip("zifo", got, want):
        assert g.dtype == torch.float32 and g.shape == (b, s, w)
        assert np.isfinite(g.numpy()).all(), name
        assert _rel(g.numpy(), wt.numpy()) < TOL, name


@pytest.mark.parametrize("b,s,w,scale_i,shift_f", CASES, ids=IDS)
def test_bwd_ref_equals_jax_grad_of_the_reference_scan(b, s, w, scale_i,
                                                       shift_f):
    arrays = _inputs(b, s, w, scale_i, shift_f, seed=1)
    got = _bwd_ref(*_torch(*arrays))
    want = _ref_grads(*arrays)
    if scale_i > 1:
        assert np.abs(arrays[1]).max() > 25
    for name, g, wt in zip("zifo", got, want):
        assert _rel(g.numpy(), wt) < TOL, name


@pytest.mark.parametrize("b,s,w,scale_i,shift_f", CASES, ids=IDS)
def test_states_variant_against_the_plain_loop_and_the_reference(
        b, s, w, scale_i, shift_f):
    """y bitwise the plain forward's; c, n, m the reference scan's
    states."""
    arrays = _inputs(b, s, w, scale_i, shift_f, seed=2)[:4]
    ts = _torch(*arrays)
    y, c, n, m = slstm_ref.slstm_scan_states_ref(*ts)
    assert torch.equal(y, slstm_ref.slstm_scan_ref(*ts))
    for name, got, want in zip("ycnm", (y, c, n, m), _ref_scan(*arrays)):
        assert got.shape == (b, s, w)
        assert _rel(got.numpy(), want) < TOL, name


def _tie_inputs(t=7):
    """z, i, f, o, dy (2, 24, 8) with a = i exactly at step t: i set to
    log_sigmoid(f) plus the state's m at step t - 1, as the step computes
    it."""
    z, i, f, o, dy = _torch(*_inputs(2, 24, 8, 1.0, 0.0, seed=3))
    m = slstm_ref.slstm_scan_states_ref(z, i, f, o)[3]
    i[:, t] = F.logsigmoid(f[:, t]) + m[:, t - 1]
    assert torch.equal(slstm_ref.slstm_scan_states_ref(z, i, f, o)[3][:, t],
                       i[:, t])
    return z, i, f, o, dy


def test_gradients_at_an_exact_tie_equal_autograds():
    """a = i exactly at step 7.  Both sides split the max's gradient in
    half there.  After a tie n >= 1 for good, so the output no longer
    depends on the stabiliser m and the max's gradient is rounding
    residue: the split must change no input's gradient."""
    z, i, f, o, dy = _tie_inputs()
    got = _bwd_ref(z, i, f, o, dy)
    want = _autograd(z, i, f, o, dy)
    for name, g, wt in zip("zifo", got, want):
        assert np.isfinite(g.numpy()).all(), name
        assert _rel(g.numpy(), wt.numpy()) < TOL, name


def _count_calls(monkeypatch, module, name, calls):
    orig = getattr(module, name)

    def counted(*args, **kw):
        calls[name] = calls.get(name, 0) + 1
        return orig(*args, **kw)

    monkeypatch.setattr(module, name, counted)


def test_site_backward_runs_the_plain_backward_not_autograd_of_the_loop(
        monkeypatch):
    """``SLSTMScan`` on CPU tensors: the forward keeps the states (the
    step loop runs once, under no graph), the backward calls
    ``slstm_scan_bwd_ref`` once and no step of the forward loop; the
    gradients are autograd's through the plain loop."""
    z, i, f, o, dy = _torch(*_inputs(2, 40, 24, 1.0, 6.0, seed=5))
    want = _autograd(z, i, f, o, dy)
    calls = {}
    for module, name in ((slstm_ref, "slstm_scan_ref"),
                         (slstm_ref, "slstm_step"),
                         (slstm_ref, "slstm_scan_states_ref"),
                         (tk.slstm.ops, "slstm_scan_ref"),
                         (tk.slstm.ops, "slstm_scan_states_ref"),
                         (tk.slstm.ops, "slstm_scan_bwd_ref")):
        _count_calls(monkeypatch, module, name, calls)
    ins = [t.clone().requires_grad_() for t in (z, i, f, o)]
    y = ssm.slstm_scan_site(*ins)
    assert y.grad_fn is not None and y.grad_fn.name() == "SLSTMScanBackward"
    assert calls == {"slstm_scan_states_ref": 1, "slstm_step": 40}
    calls.clear()
    got = torch.autograd.grad(y, ins, dy)
    assert calls == {"slstm_scan_bwd_ref": 1}
    assert not hasattr(ssm, "slstm_scan_ref")
    for name, g, wt in zip("zifo", got, want):
        assert _rel(g.numpy(), wt.numpy()) < TOL, name


def test_cpu_wrappers_run_the_plain_versions_and_count_no_launch():
    z, i, f, o, dy = _torch(*_inputs(2, 40, 8, 1.0, 0.0, seed=7))
    tk.reset_launches()
    y, c, n, m = tk.slstm_scan_cuda(z, i, f, o, states=True)
    want = slstm_ref.slstm_scan_states_ref(z, i, f, o)
    assert all(torch.equal(a, b) for a, b in zip((y, c, n, m), want))
    assert torch.equal(tk.slstm_scan_cuda(z, i, f, o), want[0])
    got = tk.slstm_scan_bwd_cuda(z, i, f, o, c, n, m, dy)
    want_g = slstm_ref.slstm_scan_bwd_ref(z, i, f, o, c, n, m, dy)
    assert all(torch.equal(a, b) for a, b in zip(got, want_g))
    assert tk.launches()["slstm_scan_cuda"] == 0
    assert tk.launches()["slstm_scan_bwd_cuda"] == 0


def test_launch_counters_cover_k6_backward():
    tk.reset_launches()
    counts = tk.launches()
    assert {"slstm_scan_cuda", "slstm_scan_bwd_cuda"} <= set(counts)
    assert counts["slstm_scan_bwd_cuda"] == 0


def _shifted(x):
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def _chunked_bwd(z, i, f, o, c, n, m, dy, chunk):
    """A model of the backward kernel's three phases (csrc/slstm.cu), in
    fp32 on the CPU: (1) each chunk's affine map of the carry (dc, dn, dm),
    composed from its last step to its first as (F, W, Oc, On, Pc, Pn, Om);
    (2) the maps applied from the last chunk to the first, each chunk's
    incoming carry kept; (3) each chunk replayed from its carry, step for
    step as ``slstm_scan_bwd_ref`` does -> (dz, di, df, do)."""
    b, s, w = z.shape
    th, g = torch.tanh(z), torch.sigmoid(o)
    d = torch.clamp(n, min=1.0)
    c_p, n_p = _shifted(c), _shifted(n)
    a = F.logsigmoid(f) + _shifted(m)
    fs, is_ = torch.exp(a - m), torch.exp(i - m)
    wa = (a > i).float() + 0.5 * (a == i).float()
    al = dy * g / d
    be = torch.where(n >= 1.0, -(dy * g * c / (d * d)), torch.zeros_like(n))
    p = (1.0 - wa) * fs * c_p - wa * is_ * th
    q = (1.0 - wa) * fs * n_p - wa * is_
    spans = [range(min(s, k + chunk) - 1, k - 1, -1)
             for k in range(0, s, chunk)]
    maps = []
    for span in spans:
        one, zero = torch.ones(b, w), torch.zeros(b, w)
        fm, wm, oc, on, pc, pn, om = one, one, zero, zero, zero, zero, zero
        for t in span:
            dct, dnt = oc + al[:, t], on + be[:, t]
            om = wa[:, t] * om + p[:, t] * dct + q[:, t] * dnt
            pc = wa[:, t] * pc + p[:, t] * fm
            pn = wa[:, t] * pn + q[:, t] * fm
            wm = wa[:, t] * wm
            oc, on, fm = fs[:, t] * dct, fs[:, t] * dnt, fs[:, t] * fm
        maps.append((fm, wm, oc, on, pc, pn, om))
    carried = [None] * len(spans)
    dc = dn = dm = torch.zeros(b, w)
    for k in range(len(spans) - 1, -1, -1):
        carried[k] = (dc, dn, dm)
        fm, wm, oc, on, pc, pn, om = maps[k]
        dc, dn, dm = (fm * dc + oc, fm * dn + on,
                      wm * dm + pc * dc + pn * dn + om)
    dz, di, df = (torch.empty_like(z) for _ in range(3))
    sig_nf = torch.sigmoid(-f)
    for span, (dc, dn, dm) in zip(spans, carried):
        for t in span:
            dct = dc + al[:, t]
            dnt = dn + be[:, t]
            dfs = dct * c_p[:, t] + dnt * n_p[:, t]
            dis = dct * th[:, t] + dnt
            dml = dm - (dfs * fs[:, t] + dis * is_[:, t])
            da = dfs * fs[:, t] + dml * wa[:, t]
            dz[:, t] = dct * is_[:, t] * (1.0 - th[:, t] * th[:, t])
            di[:, t] = dis * is_[:, t] + dml * (1.0 - wa[:, t])
            df[:, t] = da * sig_nf[:, t]
            dm, dc, dn = da, dct * fs[:, t], dnt * fs[:, t]
    return dz, di, df, dy * (c / d) * g * (1.0 - g)


@pytest.mark.parametrize("case,chunk", [
    ((1, 100, 20, 30.0, 6.0), 32), ((2, 45, 16, 1.0, 6.0), 8),
    ((2, 5, 16, 30.0, 0.0), 8), ("tie", 5)],
    ids=["s100_l32", "s45_l8", "s5_below_l8", "tie_s24_l5"])
def test_chunked_reverse_scan_matches_the_plain_backward(case, chunk):
    """The backward kernel's design on the CPU, before any chip run: the
    chunk maps, the carry and the replay give the plain reverse loop's
    gradients within 1e-6 of each gradient's largest entry (fp32, only the
    carry's rounding differs), at S not a multiple of the chunk (open
    gates, a wide input gate), S below it, and an exact tie a = i at step
    7, inside the second of five chunks of 5 (S 24)."""
    if case == "tie":
        z, i, f, o, dy = _tie_inputs()
    else:
        z, i, f, o, dy = _torch(*_inputs(*case, seed=4))
    _, c, n, m = slstm_ref.slstm_scan_states_ref(z, i, f, o)
    got = _chunked_bwd(z, i, f, o, c, n, m, dy, chunk)
    want = slstm_ref.slstm_scan_bwd_ref(z, i, f, o, c, n, m, dy)
    for name, g, wt in zip("zifo", got, want):
        assert np.isfinite(g.numpy()).all(), name
        assert _rel(g.numpy(), wt.numpy()) < 1e-6, name
