"""K1's CTA tile from the tile plan (``kernels/matmul/ops.py::cta_tile``).

The rule's three properties over the model's whole candidate grid, the
wrapper against the reference's ``matmul(..., tiles=)`` (interpret mode)
on the CPU, the heuristic plan against no plan, the dispatch handing a
forced plan's tile to K1's wrapper, and the card's dispatch keeping the
heuristic plan.  fp32 tolerance 1e-5 relative, as in test_torch_kernels.
"""

import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import matmul as ref_matmul
from repro.perf.kernel import TilePlan as RefTilePlan
from repro_torch import kernels as tk
from repro_torch.core.machine import H100_SXM
from repro_torch.kernels.matmul import CTA_TILES, DEFAULT_CTA_TILE, cta_tile
from repro_torch.perf.kernel import (TilePlan, candidate_tiles,
                                     heuristic_plan, tiles_for_plan)
from repro_torch.tuner import PlanCache, Tuner
from repro_torch.tuner import dispatch

EDGES = [128, 300, 512, 1000, 4096, 16384]


def _plans(edge):
    cands = candidate_tiles("matmul", (edge, edge, edge))
    return [TilePlan.make("matmul", bm=int(m), bn=int(n), bk=int(k))
            for m, n, k in zip(cands["bm"], cands["bn"], cands["bk"])]


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("edge", EDGES)
def test_no_plan_and_the_heuristic_plan_take_the_default_tile(edge,
                                                              itemsize):
    assert cta_tile(None) == DEFAULT_CTA_TILE == (128, 128)
    plan = heuristic_plan("matmul", (edge, edge, edge), itemsize)
    assert plan.sizes() == (256, 256, 512)
    assert cta_tile(plan) == DEFAULT_CTA_TILE


@pytest.mark.parametrize("edge", EDGES)
def test_every_candidate_plan_maps_to_a_compiled_tile(edge):
    plans = _plans(edge)
    assert plans
    for plan in plans:
        assert cta_tile(plan) in CTA_TILES, plan


@pytest.mark.parametrize("edge", EDGES)
def test_a_larger_block_never_gives_a_smaller_edge(edge):
    plans = _plans(edge)
    for p, q in itertools.product(plans, plans):
        if p["bm"] <= q["bm"] and p["bn"] <= q["bn"]:
            (pm, pn), (qm, qn) = cta_tile(p), cta_tile(q)
            assert pm <= qm and pn <= qn, (p, q)


def test_the_sweep_reaches_every_compiled_tile():
    # 128 .. 1024 on each axis (candidate_tiles at 4096) covers them all,
    # and bk changes nothing
    reached = {cta_tile(p) for p in _plans(4096)}
    assert reached == set(CTA_TILES)
    assert cta_tile(TilePlan.make("matmul", bm=256, bn=256, bk=128)) == \
        cta_tile(TilePlan.make("matmul", bm=256, bn=256, bk=1024))


def test_the_rule_at_its_edges():
    def tile(bm, bn):
        return cta_tile(TilePlan.make("matmul", bm=bm, bn=bn, bk=512))
    assert tile(128, 128) == (64, 64)
    assert tile(384, 384) == (128, 128)     # half 192, rounded down
    assert tile(512, 512) == (256, 128)
    assert tile(1024, 128) == (256, 64)
    assert tile(128, 1024) == (64, 128)
    with pytest.raises(ValueError, match="TilePlan"):
        cta_tile(TilePlan.make("trsm", block=256))


def test_plan_tiles_against_the_reference():
    rng = np.random.default_rng(28)
    a = rng.standard_normal((256, 384)).astype(np.float32)
    b = rng.standard_normal((384, 256)).astype(np.float32)
    plan = TilePlan.make("matmul", bm=128, bn=128, bk=128)
    want = ref_matmul(jnp.asarray(a), jnp.asarray(b),
                      tiles=RefTilePlan.make("matmul", bm=128, bn=128,
                                             bk=128))
    got = tk.matmul(torch.tensor(a), torch.tensor(b), tiles=plan)
    assert _rel(got.numpy(), want) < 1e-5


@pytest.mark.parametrize("shape", [(256, 384, 256), (300, 700, 260)])
def test_heuristic_plan_output_equals_no_plan(shape):
    m, k, n = shape
    rng = np.random.default_rng(m + k + n)
    a = torch.tensor(rng.standard_normal((m, k)), dtype=torch.float32)
    b = torch.tensor(rng.standard_normal((k, n)), dtype=torch.float32)
    plan = heuristic_plan("matmul", shape, 4)
    assert torch.equal(tk.matmul(a, b), tk.matmul(a, b, tiles=plan))


@pytest.mark.parametrize("op", ["matmul", "trsm", "cholesky"])
def test_execute_hands_a_forced_plan_tile_to_k1(op, tmp_path, monkeypatch):
    """A plan whose matmul tile is forced reaches K1's wrapper as that
    TilePlan in every local product of the stacked grid."""
    n, p = 512, 4
    cpu = torch.device("cpu")
    tuner = Tuner(cache=PlanCache(str(tmp_path)))
    plan = tuner.plan(op, n, devices=[cpu] * p, local_kernel="pallas")
    forced = {"bm": 128, "bn": 256, "bk": 512}
    plan = dataclasses.replace(plan, tiles={**plan.tiles, "matmul": forced})
    seen = []
    real = dispatch._kmm

    def spy(a, b, **kw):
        seen.append(kw.get("tiles"))
        return real(a, b, **kw)

    monkeypatch.setattr(dispatch, "_kmm", spy)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((n, n))
    if op == "matmul":
        args, want = (x, x.T), x @ x.T
    elif op == "trsm":
        u = np.triu(x) + 3 * np.eye(n)
        args, want = (u, x), x @ np.linalg.inv(u)
    else:
        s = x @ x.T + n * np.eye(n)
        args, want = (s,), np.linalg.cholesky(s)
    got = dispatch.execute(plan, *(torch.tensor(a, dtype=torch.float32)
                                   for a in args), devices=[cpu] * p)
    assert np.abs(got.numpy() - want).max() / np.abs(want).max() < 1e-4
    assert seen and all(t == TilePlan.make("matmul", source="plan", **forced)
                        for t in seen)
    assert cta_tile(seen[0]) == (64, 128)


@pytest.mark.parametrize("op", ["cannon", "summa", "trsm", "cholesky"])
@pytest.mark.parametrize("n,g", [(4096, 1), (16384, 1), (4096, 2)])
def test_the_card_keeps_the_heuristic_plan(op, n, g):
    assert H100_SXM.kernel_constants is None
    nb = -(-n // g)
    got = tiles_for_plan(H100_SXM, op, n, g, "float32")
    assert got["matmul"] == heuristic_plan("matmul", (nb, nb, nb),
                                           4).block_dict()
    assert cta_tile(TilePlan.from_blocks("matmul", got["matmul"])) == \
        DEFAULT_CTA_TILE
