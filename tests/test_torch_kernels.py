"""The port's kernel wrappers against the reference's, on the CPU.

The same numpy-seeded inputs go through the reference's Pallas wrappers
(interpret mode, as tests/test_kernels.py runs them) and through the port's
wrappers on CPU tensors, which run the kernels' plain PyTorch versions.
Tolerances: fp32 matmul 1e-5 relative; trsm / Cholesky 1e-4 (another
summation order); bf16 2e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import cholesky as ref_cholesky
from repro.kernels import cholesky_block_pallas, trsm_diag_pallas
from repro.kernels import matmul as ref_matmul
from repro.kernels import pad_axes as ref_pad_axes
from repro.kernels import trsm as ref_trsm
from repro_torch import kernels as tk
from repro_torch.kernels.common import TilePlan, pad_axes, round_up, tile_block

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


def _upper(rng, n):
    return np.triu(rng.standard_normal((n, n))) + 2 * np.sqrt(n) * np.eye(n)


def _spd(rng, n):
    m = rng.standard_normal((n, n))
    return m @ m.T + n * np.eye(n)


class TestMatmul:
    @pytest.mark.parametrize("m,k,n", [(128, 128, 128), (256, 512, 256),
                                       (300, 700, 260), (512, 1024, 384),
                                       (64, 64, 64)])
    @pytest.mark.parametrize("dt", ["float32", "bfloat16"])
    def test_sweep(self, m, k, n, dt):
        rng = np.random.default_rng(m * 7 + k + n)
        ja, ta = _both(rng.standard_normal((m, k)), dt)
        jb, tb = _both(rng.standard_normal((k, n)), dt)
        tol = 2e-2 if dt == "bfloat16" else 1e-5
        got = tk.matmul(ta, tb)
        assert got.dtype == DTYPES[dt][1]
        assert _rel(_np(got), ref_matmul(ja, jb)) < tol

    def test_out_dtype(self):
        rng = np.random.default_rng(1)
        ja, ta = _both(rng.standard_normal((256, 256)), "bfloat16")
        got = tk.matmul(ta, ta, out_dtype=torch.float32)
        assert got.dtype == torch.float32
        want = ref_matmul(ja, ja, out_dtype=jnp.float32)
        assert _rel(got.numpy(), want) < 1e-5

    def test_batched_launch_matches_per_rank_products(self):
        rng = np.random.default_rng(2)
        a = torch.tensor(rng.standard_normal((2, 3, 160, 192)),
                         dtype=torch.float32)
        b = torch.tensor(rng.standard_normal((3, 192, 144)),
                         dtype=torch.float32)
        got = tk.matmul(a, b)
        assert got.shape == (2, 3, 160, 144)
        for i in range(2):
            for j in range(3):
                want = ref_matmul(jnp.asarray(a[i, j].numpy()),
                                  jnp.asarray(b[j].numpy()))
                assert _rel(got[i, j].numpy(), want) < 1e-5

    def test_tile_family_is_checked(self):
        a = torch.zeros(128, 128)
        with pytest.raises(ValueError, match="TilePlan"):
            tk.matmul(a, a, tiles=TilePlan.make("trsm", block=256))

    def test_cpu_launcher_runs_the_plain_version_uncounted(self):
        rng = np.random.default_rng(3)
        a = torch.tensor(rng.standard_normal((200, 130)), dtype=torch.float32)
        before = tk.matmul_cuda.launches
        got = tk.matmul_cuda(a, a.T)
        assert tk.matmul_cuda.launches == before
        assert torch.equal(got, tk.matmul_ref(a, a.T))


class TestTrsm:
    @pytest.mark.parametrize("n,m", [(256, 256), (512, 384), (768, 256),
                                     (64, 32)])
    def test_sweep(self, n, m):
        rng = np.random.default_rng(n + m)
        ju, tu = _both(_upper(rng, n))
        jb, tb = _both(rng.standard_normal((m, n)))
        assert _rel(_np(tk.trsm(tu, tb)), ref_trsm(ju, jb)) < 1e-4

    def test_solves_the_system(self):
        rng = np.random.default_rng(4)
        n = 256
        u = torch.tensor(np.triu(rng.standard_normal((n, n))) + 40 * np.eye(n),
                         dtype=torch.float32)
        b = torch.tensor(rng.standard_normal((n, n)), dtype=torch.float32)
        x = tk.trsm(u, b)
        assert _rel((x @ u).numpy(), b.numpy()) < 1e-4

    @pytest.mark.parametrize("nb,m", [(256, 256), (128, 384)])
    def test_diag_plain_version_matches_pallas(self, nb, m):
        rng = np.random.default_rng(nb + m + 1)
        ju, tu = _both(_upper(rng, nb))
        jb, tb = _both(rng.standard_normal((m, nb)))
        want = trsm_diag_pallas(ju, jb, interpret=True)
        assert _rel(_np(tk.trsm_diag_cuda(tu, tb)), want) < 1e-4
        assert _rel(_np(tk.trsm_diag_ref(tu, tb)), want) < 1e-4

    def test_diag_batched_over_ranks(self):
        rng = np.random.default_rng(5)
        us = [_both(_upper(rng, 128)) for _ in range(3)]
        bs = [_both(rng.standard_normal((256, 128))) for _ in range(3)]
        got = tk.trsm_diag_cuda(torch.stack([u for _, u in us]),
                                torch.stack([b for _, b in bs]))
        for i in range(3):
            want = trsm_diag_pallas(us[i][0], bs[i][0], interpret=True)
            assert _rel(_np(got[i]), want) < 1e-4

    def test_block_must_divide(self):
        # n % block != 0 takes the library path, as in the reference
        rng = np.random.default_rng(6)
        ju, tu = _both(_upper(rng, 320))
        jb, tb = _both(rng.standard_normal((128, 320)))
        assert _rel(_np(tk.trsm(tu, tb)), ref_trsm(ju, jb)) < 1e-4


class TestCholesky:
    @pytest.mark.parametrize("n", [64, 256, 512, 768])
    def test_sweep(self, n):
        rng = np.random.default_rng(n)
        a = _spd(rng, n)
        ja, ta = _both(a)
        got = _np(tk.cholesky(ta))
        assert _rel(got, ref_cholesky(ja)) < 1e-4
        assert _rel(got @ got.T, np.asarray(ja)) < 1e-4
        assert np.allclose(np.triu(got, 1), 0)

    @pytest.mark.parametrize("n", [200, 256])
    def test_block_plain_version_matches_pallas(self, n):
        rng = np.random.default_rng(n + 1)
        ja, ta = _both(_spd(rng, n))
        want = cholesky_block_pallas(ja, interpret=True)
        assert _rel(_np(tk.cholesky_block_cuda(ta)), want) < 1e-4
        assert _rel(_np(tk.cholesky_block_ref(ta)), want) < 1e-4

    def test_block_batched_over_ranks(self):
        rng = np.random.default_rng(7)
        blocks = [_both(_spd(rng, 96)) for _ in range(4)]
        got = tk.cholesky_block_cuda(torch.stack([t for _, t in blocks]))
        for i, (ja, _) in enumerate(blocks):
            want = cholesky_block_pallas(ja, interpret=True)
            assert _rel(_np(got[i]), want) < 1e-4


class TestCommon:
    @pytest.mark.parametrize("x,m", [(0, 128), (1, 128), (128, 128),
                                     (300, 256)])
    def test_round_up(self, x, m):
        assert round_up(x, m) == -(-x // m) * m

    @pytest.mark.parametrize("shape,mult", [((300, 260), {0: 128, 1: 64}),
                                            ((256, 128), {0: 128, 1: 128}),
                                            ((5, 7, 9), {-1: 4})])
    def test_pad_axes(self, shape, mult):
        x = np.random.default_rng(8).standard_normal(shape).astype(np.float32)
        want = np.asarray(ref_pad_axes(jnp.asarray(x),
                                       {a % len(shape): m
                                        for a, m in mult.items()}))
        got = pad_axes(torch.tensor(x), mult).numpy()
        assert got.shape == want.shape
        assert np.array_equal(got, want)

    def test_tile_block(self):
        plan = TilePlan.make("trsm", block=128)
        assert tile_block(None, "trsm", "block", 256) == 256
        assert tile_block(plan, "trsm", "block", 256) == 128
        with pytest.raises(ValueError):
            tile_block(plan, "cholesky", "block", 256)
