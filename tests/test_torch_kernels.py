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
from repro_torch.kernels.cholesky.ops import (ONE_CTA_MAX, SUB_BLOCK,
                                              blocked_factor)
from repro_torch.kernels.common import (TilePlan, as_batched, pad_axes,
                                        round_up, tile_block)

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

    # The operand forms of the main path's products, each held to the
    # reference's matmul_pallas (interpret mode) within 1e-5 (fp32).

    def test_trailing_update_operand_form(self):
        # kernels/trsm/ops.py: X_j (an A whose rows are longer than k) times
        # the strided view U[j0:j1, j1:] (row stride > n); the view reaches
        # the launcher as it is, not copied
        rng = np.random.default_rng(17)
        u = torch.tensor(rng.standard_normal((640, 640)), dtype=torch.float32)
        x = torch.tensor(rng.standard_normal((384, 200)), dtype=torch.float32)
        a, b = x[:, 8:136], u[128:256, 256:]
        assert a.stride(0) == 200 and b.stride(0) == 640
        b3 = as_batched(b, torch.Size([]))
        assert b3.data_ptr() == b.data_ptr() and b3.stride(1) == 640
        want = ref_matmul(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()))
        assert _rel(tk.matmul(a, b).numpy(), want) < 1e-5
        assert _rel(tk.matmul_cuda(a, b).numpy(), want) < 1e-5

    @pytest.mark.parametrize("offset", [0, 1])
    def test_unaligned_width(self, offset):
        # 130 columns: rows that are not 16-byte aligned (the 4-byte copy
        # path), also as a view at a column offset of 1
        rng = np.random.default_rng(18 + offset)
        a = torch.tensor(rng.standard_normal((130, 130 + offset)),
                         dtype=torch.float32)[:, offset:]
        b = torch.tensor(rng.standard_normal((130, 130)), dtype=torch.float32)
        want = ref_matmul(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()))
        assert _rel(tk.matmul(a, b).numpy(), want) < 1e-5
        assert _rel(tk.matmul_cuda(a, b).numpy(), want) < 1e-5

    def test_transposed_b(self):
        # blocked_factor's syrk: L_panel times L_panel.mT, whose columns are
        # strided; the launch takes a contiguous copy
        rng = np.random.default_rng(20)
        p = torch.tensor(rng.standard_normal((384, 256)), dtype=torch.float32)
        assert as_batched(p.mT, torch.Size([])).stride() == (256 * 384, 384,
                                                            1)
        jp = jnp.asarray(p.numpy())
        want = ref_matmul(jp, jp.T)
        assert _rel(tk.matmul(p, p.mT).numpy(), want) < 1e-5
        assert _rel(tk.matmul_cuda(p, p.mT).numpy(), want) < 1e-5

    def test_linalg_matmul_on_bf16_reaches_k1_in_bf16(self, tmp_path,
                                                       monkeypatch):
        # repro_torch.linalg.matmul on bf16 operands hands every local
        # product to K1 in bf16 (its tensor-core body on the card, the plain
        # version here): n 256 on 4 CPU ranks, local blocks of 128 (R2),
        # against the reference's linalg.matmul on the same bf16 inputs
        # (its own local routine on one device; its Pallas path fails inside
        # shard_map, R1); both return bf16
        import importlib
        from repro import linalg as ref_linalg
        from repro.tuner import PlanCache as RefPlanCache
        from repro.tuner import Tuner as RefTuner
        from repro_torch import linalg
        from repro_torch.tuner import PlanCache, Tuner
        ops = importlib.import_module("repro_torch.kernels.matmul.ops")
        local = []

        def counted(a, b, **kw):
            local.append((tuple(a.shape[-2:]), a.dtype, kw["out_dtype"]))
            return k1(a, b, **kw)

        k1 = ops.matmul_cuda
        monkeypatch.setattr(ops, "matmul_cuda", counted)
        rng = np.random.default_rng(21)
        ja, ta = _both(rng.standard_normal((256, 256)), "bfloat16")
        jb, tb = _both(rng.standard_normal((256, 256)), "bfloat16")
        got = linalg.matmul(ta, tb, devices=[torch.device("cpu")] * 4,
                            local_kernel="pallas",
                            tuner=Tuner(cache=PlanCache(str(tmp_path))))
        want = ref_linalg.matmul(ja, jb, tuner=RefTuner(
            cache=RefPlanCache(str(tmp_path / "reference"))))
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        assert local and all(x == ((128, 128), torch.bfloat16,
                                   torch.bfloat16) for x in local)
        assert _rel(_np(got), want) < 2e-2

    @pytest.mark.parametrize("case", ["300x700", "700x260",
                                      "column offset 1", "odd batch stride",
                                      "shared B", "aligned"])
    def test_bf16_staging_for_tma(self, case):
        # K1's bf16 body loads operands by TMA: a 16-byte aligned start and
        # row and batch strides in multiples of 8 elements; the wrapper
        # stages any other operand into such a buffer (the values equal,
        # the logical shape kept) and passes a loadable one as it is
        from repro_torch.kernels.matmul.ops import tma_loadable, tma_staged
        rng = np.random.default_rng(22)

        def bf16(*shape):
            return torch.tensor(rng.standard_normal(shape),
                                dtype=torch.float32).bfloat16()

        x = {"300x700": lambda: bf16(1, 300, 700),
             "700x260": lambda: bf16(1, 700, 260),
             "column offset 1": lambda: bf16(1, 256, 257)[..., 1:],
             "odd batch stride": lambda: bf16(3 * 21761).as_strided(
                 (3, 160, 136), (21761, 136, 1)),
             "shared B": lambda: bf16(256, 130).expand(4, 256, 130),
             "aligned": lambda: bf16(2, 128, 64)}[case]()
        assert tma_loadable(x) == (case == "aligned")
        if case == "odd batch stride":
            assert x.stride(0) % 2 == 1 and x.stride(1) % 8 == 0
        got = tma_staged(x)
        if case == "aligned":
            assert got is x
        assert got.shape == x.shape and torch.equal(got, x)
        assert got.data_ptr() % 16 == 0 and tma_loadable(got)
        assert got.stride(0) % 8 == 0 and got.stride(1) % 8 == 0
        assert got.stride(-1) == 1
        assert (got.stride(0) == 0) == (case == "shared B")

    def test_two_ctas_fit_an_sm(self):
        # each compiled CTA tile's ring fits the CTAs an SM its launch
        # bounds ask for (227 KB a CTA at most, 228 KB an SM with 1 KB
        # reserved for each CTA): two for the default 128x128, the tile of
        # every path without a plan; A's rows of BK floats fill one
        # 128-byte swizzle span; the tiles are the wrapper's CTA_TILES, each
        # compiled in a translation unit of its own
        import os
        import re
        from repro_torch.kernels import _build
        from repro_torch.kernels.matmul import CTA_TILES, DEFAULT_CTA_TILE
        src = open(f"{_build.CSRC}/matmul_f32.cuh").read()
        body = src[src.index("namespace f32 {"):]
        c = {k: int(v) for k, v in
             re.findall(r"constexpr int (\w+) = (\d+);", body)}
        assert c["BK"] * 4 == 128
        tiles = {}
        for bm, bn, tn, stages, ctas in re.findall(
                r"using Tile\d+x\d+ = Tile<(\d+), (\d+), (\d+), (\d+), "
                r"(\d+)>;", body):
            bm, bn, tn, stages, ctas = map(int, (bm, bn, tn, stages, ctas))
            stage = bm * (c["BK"] + 4) * 4 + c["BK"] * bn * 4
            smem = stages * stage + 8 * stages + 1024
            assert smem <= 227 * 1024
            assert ctas * (smem + 1024) <= 228 * 1024
            threads = bm * bn // (8 * tn)
            assert threads * ctas <= 2048
            tiles[(bm, bn)] = ctas
        assert sorted(tiles) == sorted(CTA_TILES)
        for bm, bn in CTA_TILES:
            unit = f"{_build.CSRC}/matmul_tile_{bm}x{bn}.cu"
            assert os.path.exists(unit)
            assert f"REPRO_K1_TILE(Tile{bm}x{bn})" in open(unit).read()
            assert f"Cta<{bm}, {bn}>" in src
        assert tiles[DEFAULT_CTA_TILE] == 2
        assert "__launch_bounds__(T::THREADS, T::CTAS)" in body


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


# -- the kernels' blocked orders, emulated on the CPU -------------------------
#
# K2 and K3 run only on the card.  These emulations repeat their algorithms
# in fp32 PyTorch ops, in the kernels' order of summation, and are held to
# the reference's Pallas kernels (interpret mode) and to the float64 numpy
# oracle within 1e-5 relative to the output's largest value: in fp32 only
# the summation order (and the kernels' fused multiply-adds and reciprocal
# pivots) differ, which moves results by a few ulp of the largest entry.

PANEL = 32  # the kernels' panel width


def k3_blocked(a):
    """K3's order (csrc/cholesky.cu), right-looking by panels of 32:
    1. the diagonal tile factored column by column (one warp's chain; the
       kernel's reciprocal square root of the pivot is 1 / sqrt here);
    2. the rows below solved against the tile, the terms of each entry
       taken in ascending column order;
    3. the trailing lower triangle given the panel's rank-1 terms in
       ascending order (the register tiles change which thread applies a
       term, not the order in which an entry receives it)."""
    x = a.to(torch.float32).clone()
    n = x.shape[-1]
    for c0 in range(0, n, PANEL):
        c1 = min(c0 + PANEL, n)
        rinv = []
        for k in range(c0, c1):
            inv = 1.0 / torch.sqrt(x[..., k:k + 1, k:k + 1])
            rinv.append(inv)
            x[..., k:c1, k:k + 1] *= inv
            col = x[..., k + 1:c1, k:k + 1]
            x[..., k + 1:c1, k + 1:c1] -= col * col.mT
        if c1 == n:
            break
        for k in range(c0, c1):
            x[..., c1:, k:k + 1] *= rinv[k - c0]
            x[..., c1:, k + 1:c1] -= (x[..., c1:, k:k + 1]
                                      * x[..., k + 1:c1, k:k + 1].mT)
        for k in range(c0, c1):
            col = x[..., c1:, k:k + 1]
            x[..., c1:, c1:] -= col * col.mT
    return torch.tril(x)


def k2_blocked(u, b):
    """K2's order (csrc/trsm.cu), left-looking by panels of 32: the panel's
    columns of B less the solved columns' terms in ascending order (the
    kernel's chunks of 32, one multiply-add a term), then the panel solved
    against U's diagonal tile column by column with the reciprocal
    diagonal.  Rows are independent, so the kernel's strips of 64 rows do
    not enter."""
    uf = u.to(torch.float32)
    x = torch.zeros(b.shape, dtype=torch.float32)
    nb = uf.shape[-1]
    for c0 in range(0, nb, PANEL):
        c1 = min(c0 + PANEL, nb)
        acc = b[..., c0:c1].to(torch.float32).clone()
        for j in range(c0):
            acc -= x[..., j:j + 1] * uf[..., j:j + 1, c0:c1]
        rinv = 1.0 / torch.diagonal(uf, dim1=-2, dim2=-1)[..., c0:c1]
        for k in range(c1 - c0):
            acc[..., k:k + 1] *= rinv[..., k:k + 1]
            acc[..., k + 1:] -= (acc[..., k:k + 1]
                                 * uf[..., c0 + k:c0 + k + 1, c0 + k + 1:c1])
        x[..., c0:c1] = acc
    return x


def _oracle_cholesky(a):
    return np.linalg.cholesky(np.asarray(a, np.float64))


def _oracle_trsm(u, b):
    u64, b64 = np.asarray(u, np.float64), np.asarray(b, np.float64)
    return np.linalg.solve(u64.T, b64.T).T


class TestBlockedOrders:
    @pytest.mark.parametrize("nb", [64, 200, 256])
    def test_k3_order_matches_pallas_and_oracle(self, nb):
        rng = np.random.default_rng(nb + 11)
        a = _spd(rng, nb)
        ja, ta = _both(a)
        got = k3_blocked(ta).numpy()
        assert _rel(got, cholesky_block_pallas(ja, interpret=True)) < 1e-5
        assert _rel(got, _oracle_cholesky(np.asarray(ja))) < 1e-5

    @pytest.mark.parametrize("parts", ["emulated", "plain"])
    def test_k3_composition_above_one_cta(self, parts):
        # nb > ONE_CTA_MAX: K3 on 256-wide diagonal blocks, K2 on the
        # panels, K1 for the trailing updates (the reference's interpret
        # mode is too slow at this size, so the oracle alone)
        rng = np.random.default_rng(13)
        nb = 512
        ja, ta = _both(_spd(rng, nb))
        factor, solve = ((k3_blocked, k2_blocked) if parts == "emulated"
                         else (tk.cholesky_block_ref, tk.trsm_diag_ref))
        got = blocked_factor(ta, SUB_BLOCK,
                             lambda x, o: o.copy_(factor(x)),
                             lambda u, b, o: o.copy_(solve(u, b)),
                             tk.matmul_ref).numpy()
        assert _rel(got, _oracle_cholesky(np.asarray(ja))) < 1e-5
        assert np.array_equal(np.triu(got, 1), np.zeros_like(got))

    def test_k3_composition_ragged_last_block(self):
        rng = np.random.default_rng(14)
        ja, ta = _both(_spd(rng, 400))
        got = blocked_factor(ta, SUB_BLOCK,
                             lambda x, o: o.copy_(k3_blocked(x)),
                             lambda u, b, o: o.copy_(k2_blocked(u, b)),
                             tk.matmul_ref).numpy()
        assert _rel(got, _oracle_cholesky(np.asarray(ja))) < 1e-5

    @pytest.mark.parametrize("nb,m", [(256, 256), (128, 384), (200, 130)])
    def test_k2_order_matches_pallas_and_oracle(self, nb, m):
        rng = np.random.default_rng(nb * 3 + m)
        ju, tu = _both(_upper(rng, nb))
        jb, tb = _both(rng.standard_normal((m, nb)))
        got = k2_blocked(tu, tb).numpy()
        assert _rel(got, trsm_diag_pallas(ju, jb, interpret=True)) < 1e-5
        assert _rel(got, _oracle_trsm(np.asarray(ju), np.asarray(jb))) < 1e-5

    def test_k2_strided_b(self):
        # the trsm wrapper hands K2 a column slice of its working copy of B
        rng = np.random.default_rng(15)
        ju, tu = _both(_upper(rng, 128))
        full = torch.tensor(rng.standard_normal((256, 512)),
                            dtype=torch.float32)
        b = full[:, 128:256]
        assert b.stride(0) == 512
        got = k2_blocked(tu, b).numpy()
        assert _rel(got, _oracle_trsm(np.asarray(ju), b.numpy())) < 1e-5
        assert torch.equal(tk.trsm_diag_cuda(tu, b), tk.trsm_diag_ref(tu, b))

    def test_one_cta_limit_matches_the_kernel(self):
        import re
        from repro_torch.kernels import _build
        src = open(f"{_build.CSRC}/cholesky.cu").read()
        limit = int(re.search(r"constexpr int ONE_CTA_MAX = (\d+);",
                              src).group(1))
        assert limit == ONE_CTA_MAX
        assert SUB_BLOCK <= ONE_CTA_MAX

    def test_cpu_wide_block_takes_the_plain_version_uncounted(self):
        rng = np.random.default_rng(16)
        ta = torch.tensor(_spd(rng, 400), dtype=torch.float32)
        before = (tk.cholesky_block_cuda.launches, tk.trsm_diag_cuda.launches,
                  tk.matmul_cuda.launches)
        got = tk.cholesky_block_cuda(ta)
        assert torch.equal(got, tk.cholesky_block_ref(ta))
        assert before == (tk.cholesky_block_cuda.launches,
                          tk.trsm_diag_cuda.launches, tk.matmul_cuda.launches)


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
