"""The port's attention and scan kernel wrappers (K4, K5) against the
reference's, and the sLSTM recurrence (K6, a port-side kernel) against the
reference's scan of its cell, on the CPU.

The same numpy-seeded inputs go through the reference's Pallas wrappers
(interpret mode, as tests/test_kernels.py runs them) and through the port's
wrappers on CPU tensors, which run the kernels' plain PyTorch versions.
Tolerances: K4 fp32 2e-5 absolute (the reference's own); K5 fp32 1e-4
relative (the chunked scan against the step-by-step recurrence); bf16
3e-2 relative; K6 fp32 1e-5 relative (the same steps in the same order,
elementwise functions of two libraries).  K4's bf16 body is held on the card to 8e-3 of each output
row's largest value; ``TestTensorCoreNumerics`` shows here that its
arithmetic fits that budget.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as ref_flash
from repro.kernels.flash_attention import flash_attention_ref as ref_flash_ref
from repro.kernels.ssm_scan import ssm_scan as ref_scan
from repro.models import ssm as ref_ssm
from repro_torch import kernels as tk
from repro_torch.kernels.common import TilePlan
from repro_torch.kernels.flash_attention.ops import (HEAD_DIMS, _ref4,
                                                     loadable, pad_head_dim,
                                                     padded_head_dim)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _rel(got, ref):
    g = np.asarray(got, np.float32)
    r = np.asarray(ref, np.float32)
    return np.abs(g - r).max() / max(np.abs(r).max(), 1e-6)


def _both(x, dt="float32"):
    """One numpy array as a reference (jnp) and a port (torch) operand."""
    jdt, tdt = DTYPES[dt]
    x = np.asarray(x, np.float32)
    return jnp.asarray(x, jdt), torch.tensor(x).to(tdt)


def _np(t):
    return t.to(torch.float32).numpy()


class TestFlashAttention:
    @pytest.mark.parametrize("b,h,kv,s,d,causal", [
        (2, 4, 2, 256, 64, True), (1, 8, 1, 384, 128, True),
        (2, 4, 4, 300, 64, False), (1, 2, 2, 64, 64, True),
        (1, 6, 3, 256, 96, True),
    ])
    def test_sweep(self, b, h, kv, s, d, causal):
        rng = np.random.default_rng(b * 1000 + h * 100 + s + d)
        jq, tq = _both(rng.standard_normal((b, h, s, d)))
        jk, tk_ = _both(rng.standard_normal((b, kv, s, d)))
        jv, tv = _both(rng.standard_normal((b, kv, s, d)))
        got = tk.flash_attention(tq, tk_, tv, causal=causal)
        want = ref_flash(jq, jk, jv, causal=causal)
        assert got.shape == (b, h, s, d) and got.dtype == torch.float32
        assert np.abs(_np(got) - np.asarray(want)).max() < 2e-5

    def test_bf16(self):
        rng = np.random.default_rng(7)
        b, h, s, d = 1, 4, 256, 64
        jq, tq = _both(rng.standard_normal((b, h, s, d)), "bfloat16")
        jk, tk_ = _both(rng.standard_normal((b, h, s, d)), "bfloat16")
        jv, tv = _both(rng.standard_normal((b, h, s, d)), "bfloat16")
        got = tk.flash_attention(tq, tk_, tv)
        assert got.dtype == torch.bfloat16
        assert _rel(_np(got), ref_flash(jq, jk, jv)) < 3e-2

    def test_identical_values_pass_through(self):
        """Attention over identical values returns that value."""
        rng = np.random.default_rng(8)
        q = torch.tensor(rng.standard_normal((1, 2, 256, 64)),
                         dtype=torch.float32)
        k = torch.tensor(rng.standard_normal((1, 2, 256, 64)),
                         dtype=torch.float32)
        v = torch.full((1, 2, 256, 64), 3.25)
        got = tk.flash_attention(q, k, v, causal=True)
        assert torch.allclose(got, torch.full_like(got, 3.25), atol=1e-4)

    def test_strided_heads_match_contiguous(self):
        """q, k, v split out of a projection are transposed views; the
        result does not depend on the layout."""
        rng = np.random.default_rng(9)
        x = torch.tensor(rng.standard_normal((2, 256, 8, 64)),
                         dtype=torch.float32)
        kv = torch.tensor(rng.standard_normal((2, 256, 2, 64)),
                          dtype=torch.float32)
        q, k = x.transpose(1, 2), kv.transpose(1, 2)
        assert not q.is_contiguous()
        got = tk.flash_attention(q, k, k)
        want = tk.flash_attention(q.contiguous(), k.contiguous(),
                                  k.contiguous())
        assert torch.equal(got, want)

    def test_wrong_family_plan_raises(self):
        q = torch.zeros(1, 1, 128, 64)
        plan = TilePlan.make("matmul", bm=128, bn=128, bk=128)
        with pytest.raises(ValueError, match="matmul"):
            tk.flash_attention(q, q, q, tiles=plan)
        ok = TilePlan.make("flash_attention", bq=128, bkv=128)
        assert tk.flash_attention(q, q, q, tiles=ok).shape == q.shape

    @pytest.mark.parametrize("d", [16, 80, 160])
    def test_padded_head_dim_gives_the_unpadded_result(self, d):
        """K4 takes D <= 256 by zero-padding D to a head dim it has a body
        for and scaling by the true D: the plain attention over the padded
        operands, with the scale d^-0.5 given explicitly (q times
        (dp / d)^0.5 against the plain version's dp^-0.5), is the unpadded
        result followed by zeros."""
        rng = np.random.default_rng(d)
        q, k, v = (torch.tensor(rng.standard_normal((3, 200, d)),
                                dtype=torch.float32) for _ in range(3))
        qp, kp, vp = pad_head_dim(q, k, v)
        dp = qp.shape[-1]
        assert dp == min(x for x in HEAD_DIMS if x >= d) and dp > d
        got = tk.flash_attention_ref(qp * (dp / d) ** 0.5, kp, vp,
                                     causal=True)
        want = tk.flash_attention_ref(q, k, v, causal=True)
        assert torch.allclose(got[..., :d], want, rtol=0, atol=1e-6)
        assert torch.equal(got[..., d:], torch.zeros_like(got[..., d:]))

    def test_padding_leaves_supported_dims_and_refuses_above_128(self):
        # the widest body is 256 since head dims 129-256 were added, and
        # above it D pads to a multiple of 128, as the reference pads (the
        # refusal moved to the launcher: D above what a block's shared
        # memory holds); the name is kept from when the widest was 128
        for d in HEAD_DIMS + (384, 512, 640):
            q = torch.zeros(1, 128, d)
            assert pad_head_dim(q, q, q)[0] is q
        assert pad_head_dim(torch.zeros(1, 128, 129))[0].shape[-1] == 256
        for d, dp in ((257, 384), (320, 384), (385, 512), (700, 768)):
            assert padded_head_dim(d) == dp
            assert pad_head_dim(torch.zeros(1, 128, d))[0].shape[-1] == dp

    @pytest.mark.parametrize("d", [320, 384])
    def test_padded_head_dim_above_256_gives_the_unpadded_result(self, d):
        """Above 256, D pads to a multiple of 128 (320 -> 384; 384 stays):
        the plain attention over the padded operands, scaled by the true
        d^-0.5, is the unpadded result followed by zeros, and the wrapper's
        CPU path gives the unpadded result."""
        rng = np.random.default_rng(d)
        q, k, v = (torch.tensor(rng.standard_normal((1, 2, 160, d)),
                                dtype=torch.float32) for _ in range(3))
        qp, kp, vp = pad_head_dim(q, k, v)
        dp = qp.shape[-1]
        assert dp == 384
        got = _ref4(qp * (dp / d) ** 0.5, kp, vp, True)
        want = _ref4(q, k, v, True)
        assert torch.allclose(got[..., :d], want, rtol=0, atol=1e-6)
        assert torch.equal(got[..., d:], torch.zeros_like(got[..., d:]))
        assert torch.equal(tk.flash_attention_cuda(q, k, v, causal=True),
                           want)

    def test_cpu_runs_the_plain_version_and_counts_no_launch(self):
        rng = np.random.default_rng(10)
        q = torch.tensor(rng.standard_normal((1, 2, 128, 32)),
                         dtype=torch.float32)
        before = tk.flash_attention_cuda.launches
        got = tk.flash_attention_cuda(q, q, q, causal=True)
        want = tk.flash_attention_ref(q[0], q[0], q[0], causal=True)
        assert tk.flash_attention_cuda.launches == before
        assert torch.equal(got[0], want)


def _tensor_core_numerics(q, k, v, causal, bkv=128):
    """K4's bf16 body, its arithmetic in plain PyTorch on (B, H, S, D) bf16
    operands: fp32 products and sums of the bf16 values, key tiles of
    ``bkv`` with a running max and sum, S scaled in fp32 after the product,
    P rounded to bf16 before P V, l summed in fp32 from the unrounded P,
    and the output divided by l and rounded to bf16 once."""
    b, h, s, d = q.shape
    group = h // k.shape[1]
    qf = q.float()
    kf = k.float().repeat_interleave(group, 1)
    vf = v.float().repeat_interleave(group, 1)
    m = torch.full((b, h, s, 1), -1e30)
    l = torch.zeros(b, h, s, 1)
    acc = torch.zeros(b, h, s, d)
    rows = torch.arange(s)[:, None]
    for k0 in range(0, k.shape[2], bkv):
        sc = torch.einsum("bhqd,bhkd->bhqk", qf,
                          kf[:, :, k0:k0 + bkv]) * d ** -0.5
        if causal:
            cols = k0 + torch.arange(sc.shape[-1])[None, :]
            sc = torch.where(rows >= cols, sc, -1e30)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        p = torch.exp(sc - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "bhqk,bhkd->bhqd", p.bfloat16().float(), vf[:, :, k0:k0 + bkv])
        m = m_new
    return (acc / torch.where(l == 0, 1.0, l)).bfloat16()


def _row_err(got, want):
    """Largest error of an output row relative to the row's largest
    value, the measure the card's check takes."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return (np.abs(got - want).max(-1)
            / np.maximum(np.abs(want).max(-1), 1e-30)).max()


class TestTensorCoreNumerics:
    """The bf16 body's error budget on the CPU: one bf16 rounding of the
    output (at most 2^-8 of a value, 3.9e-3) and P's rounding before P V
    (errors of either sign, about 1e-3 of a row's largest value) stay
    within the 8e-3 per row that the card's check allows, against the fp32
    plain version and against the reference's jnp version."""

    @pytest.mark.parametrize("b,h,kv,s,d,causal", [
        (1, 4, 1, 512, 128, True), (2, 4, 4, 300, 64, False),
        (1, 6, 3, 256, 96, True), (1, 8, 1, 384, 128, True),
        (1, 4, 2, 256, 256, True),
    ])
    def test_within_budget(self, b, h, kv, s, d, causal):
        rng = np.random.default_rng(b * 1000 + h * 100 + s + d + 5)
        q, k, v = (torch.tensor(rng.standard_normal((b, n, s, d)),
                                dtype=torch.float32).bfloat16()
                   for n in (h, kv, kv))
        # the D = 256 body walks the keys in tiles of 64
        got = _tensor_core_numerics(q, k, v, causal, bkv=128 if d <= 128
                                    else 64)
        want = _ref4(q.float(), k.float(), v.float(), causal)
        jq, jk, jv = (jnp.asarray(t.float().reshape(-1, s, d).numpy())
                      for t in (q, k, v))
        jax_want = np.asarray(ref_flash_ref(jq, jk, jv, causal=causal))
        assert got.dtype == torch.bfloat16
        assert _row_err(_np(got), _np(want)) < 8e-3
        assert _row_err(_np(got).reshape(-1, s, d), jax_want) < 8e-3
        # the budget is spent: the emulation is not the fp32 result
        assert _row_err(_np(got), _np(want)) > 1e-4

    def test_loadable(self):
        """Operands K4 takes as they lie, and those the wrapper copies
        first: the bf16 body's TMA loads need a 16-byte aligned start and
        strides in multiples of 8 elements."""
        proj = torch.zeros(2, 256, 4 * 64, dtype=torch.bfloat16)
        heads = proj.unflatten(-1, (4, 64)).transpose(1, 2)
        assert loadable(heads) and loadable(heads.contiguous())
        # rows of 4 * 64 + 4 elements: a row stride of 260
        wide = torch.zeros(2, 256, 4 * 64 + 4, dtype=torch.bfloat16)
        odd = wide[..., :256].unflatten(-1, (4, 64)).transpose(1, 2)
        assert not loadable(odd)
        assert loadable(odd.float())          # fp32 takes any row stride
        shifted = proj.flatten()[4:4 + 256 * 64].view(1, 1, 256, 64)
        assert shifted.data_ptr() % 16 == 8 and not loadable(shifted)
        assert not loadable(heads.transpose(-1, -2))


class TestSSMScan:
    @pytest.mark.parametrize("b,h,s,dk,dv", [
        (2, 2, 256, 64, 64), (1, 4, 300, 64, 128), (1, 1, 512, 128, 129),
        (1, 2, 64, 32, 32), (1, 2, 256, 256, 257), (1, 2, 300, 20, 33),
    ])
    def test_sweep(self, b, h, s, dk, dv):
        rng = np.random.default_rng(b * 100 + h * 10 + s + dk + dv)
        jq, tq = _both(rng.standard_normal((b, h, s, dk)) * 0.3)
        jk, tk_ = _both(rng.standard_normal((b, h, s, dk)) * 0.3)
        jv, tv = _both(rng.standard_normal((b, h, s, dv)))
        jla, tla = _both(-np.abs(rng.standard_normal((b, h, s))) * 0.1)
        got = tk.ssm_scan(tq, tk_, tv, tla)
        assert got.shape == (b, h, s, dv)
        assert _rel(_np(got), ref_scan(jq, jk, jv, jla)) < 1e-4

    def test_bf16(self):
        rng = np.random.default_rng(11)
        b, h, s, dk, dv = 1, 2, 256, 16, 64
        jq, tq = _both(rng.standard_normal((b, h, s, dk)) * 0.3, "bfloat16")
        jk, tk_ = _both(rng.standard_normal((b, h, s, dk)) * 0.3, "bfloat16")
        jv, tv = _both(rng.standard_normal((b, h, s, dv)), "bfloat16")
        jla, tla = _both(-np.abs(rng.standard_normal((b, h, s))) * 0.1)
        got = tk.ssm_scan(tq, tk_, tv, tla)
        assert got.dtype == torch.bfloat16
        assert _rel(_np(got), ref_scan(jq, jk, jv, jla)) < 3e-2

    def test_no_decay_equals_cumulative_linear_attention(self):
        """log_a = 0 -> plain (unnormalized) linear attention prefix sums."""
        rng = np.random.default_rng(12)
        q, k = (rng.standard_normal((256, 32)) * 0.2 for _ in range(2))
        v = rng.standard_normal((256, 32))
        t = [torch.tensor(x, dtype=torch.float32)[None, None]
             for x in (q, k, v)]
        got = tk.ssm_scan(*t, torch.zeros(1, 1, 256))[0, 0].numpy()
        want = np.tril(q @ k.T) @ v
        assert np.abs(got - want).max() / np.abs(want).max() < 1e-4

    def test_wrong_family_plan_raises(self):
        q = torch.zeros(1, 1, 128, 16)
        plan = TilePlan.make("flash_attention", bq=128, bkv=128)
        with pytest.raises(ValueError, match="flash_attention"):
            tk.ssm_scan(q, q, q, torch.zeros(1, 1, 128), tiles=plan)

    def test_cpu_runs_the_plain_version_and_counts_no_launch(self):
        rng = np.random.default_rng(13)
        q = torch.tensor(rng.standard_normal((1, 1, 128, 8)),
                         dtype=torch.float32)
        la = -torch.rand(1, 1, 128, generator=torch.Generator().manual_seed(0))
        before = tk.ssm_scan_cuda.launches
        got = tk.ssm_scan_cuda(q, q, q, la)
        assert tk.ssm_scan_cuda.launches == before
        assert torch.equal(got[0], tk.ssm_scan_ref(q[0], q[0], q[0], la[0]))


def test_launch_counters_cover_k4_and_k5():
    tk.reset_launches()
    counts = tk.launches()
    assert {"flash_attention_cuda", "ssm_scan_cuda"} <= set(counts)
    assert all(c == 0 for c in counts.values())


def _ref_slstm(z, i, f, o):
    """The reference's recurrence: ``_slstm_step`` scanned over time from
    ``init_slstm_state``, on (B, S, W) operands."""
    b, _, w = z.shape
    st0 = ref_ssm.init_slstm_state(b, w)

    def step(st, inp):
        return ref_ssm._slstm_step(st, *inp)

    xs = tuple(jnp.asarray(x.transpose(1, 0, 2)) for x in (z, i, f, o))
    _, ys = jax.lax.scan(step, st0, xs)
    return np.asarray(ys).transpose(1, 0, 2)


class TestSLSTMScan:
    @pytest.mark.parametrize("b,s,w,scale_i", [
        (2, 64, 16, 1.0), (1, 300, 20, 1.0), (2, 128, 32, 30.0),
        (1, 257, 8, 30.0)])
    def test_plain_version_matches_the_reference_scan(self, b, s, w,
                                                      scale_i):
        """scale_i = 30 gives input gates of |i| near 30, where exp(i)
        overflows unless the stabiliser m holds it: both must agree."""
        rng = np.random.default_rng(b * 100 + s + w)
        z, f, o = (rng.standard_normal((b, s, w)).astype(np.float32)
                   for _ in range(3))
        i = (rng.standard_normal((b, s, w)) * scale_i).astype(np.float32)
        want = _ref_slstm(z, i, f, o)
        got = tk.slstm_scan(*(torch.from_numpy(x) for x in (z, i, f, o)))
        assert got.dtype == torch.float32 and got.shape == (b, s, w)
        assert np.isfinite(_np(got)).all()
        if scale_i > 1:
            assert np.abs(i).max() > 25
        assert _rel(_np(got), want) < 1e-5

    def test_state_starts_at_zero_with_m_at_zero(self):
        """At t = 0, m' = max(log_sigmoid(f), i): with i = -50 the first
        step takes exp(-50 - m') of tanh(z) into c (m starts at 0, not at
        -inf, so the gate does not open fully)."""
        one = torch.ones(1, 1, 1)
        y = tk.slstm_scan(one, -50.0 * one, 10.0 * one, 10.0 * one)
        want = _ref_slstm(*(np.ones((1, 1, 1), np.float32) * v
                            for v in (1.0, -50.0, 10.0, 10.0)))
        assert _rel(_np(y), want) < 1e-6
        assert abs(float(y)) < 1e-20

    def test_cpu_runs_the_plain_version_and_counts_no_launch(self):
        g = torch.Generator().manual_seed(0)
        z, i, f, o = (torch.randn(2, 40, 8, generator=g) for _ in range(4))
        before = tk.slstm_scan_cuda.launches
        got = tk.slstm_scan_cuda(z, i, f, o)
        assert tk.slstm_scan_cuda.launches == before
        assert torch.equal(got, tk.slstm_scan_ref(z, i, f, o))

    def test_mismatched_shapes_raise(self):
        z = torch.zeros(1, 8, 4)
        with pytest.raises(ValueError, match="alike"):
            tk.slstm_scan(z, z, z, torch.zeros(1, 8, 5))
        with pytest.raises(ValueError, match="alike"):
            tk.slstm_scan(z[0], z[0], z[0], z[0])


def test_launch_counters_cover_k6():
    tk.reset_launches()
    assert tk.launches()["slstm_scan_cuda"] == 0
