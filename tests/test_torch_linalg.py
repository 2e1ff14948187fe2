"""The 16 stacked-rank variants and the model-guided entry points of the
port against the reference's shard_map variants and numpy.

The reference runs once per module in a subprocess with 9 forced host
devices (3x3 and 2x2x2 meshes, its default local routines) and saves its
outputs as .npy; the port runs the same numpy-seeded inputs on stacked CPU
ranks with both of its local-kernel choices.  Tolerance: 1e-4 relative,
the reference's own dispatch gate.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.core.machine import CPU_HOST
from repro_torch.linalg import (ALGORITHMS, BLOCK, ROWS_OVER_LAYERS, collect,
                                distribute, make_grid_mesh)
from repro_torch.perf.kernel import tiles_for_plan
from repro_torch.tuner import PlanCache, Tuner, dispatch

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
SIZES = (48, 96)
CPU = torch.device("cpu")

REFERENCE = textwrap.dedent("""
    import os, sys
    import numpy as np
    sys.path.insert(0, sys.argv[1])
    from jax.sharding import PartitionSpec as P
    from repro.linalg import ALGORITHMS, distribute
    from repro.linalg.grid import make_grid_mesh
    d = sys.argv[2]
    mesh2, mesh3 = make_grid_mesh(3, 3), make_grid_mesh(2, 2, layers=2)
    for n in (48, 96):
        A, B, U, S = (np.load(os.path.join(d, f"{k}{n}.npy"))
                      for k in "ABUS")
        for (algo, variant), fn in ALGORITHMS.items():
            mesh = mesh3 if variant.startswith("2.5d") else mesh2
            if algo in ("cannon", "summa"):
                args = (distribute(A, mesh, P("row", "col")),
                        distribute(B, mesh, P("row", "col")))
            elif algo == "trsm":
                spec = (P(("lyr", "row"), "col")
                        if variant.startswith("2.5d") else P("row", "col"))
                args = (distribute(U, mesh, P("row", "col")),
                        distribute(B, mesh, spec))
            else:
                args = (distribute(S, mesh, P("row", "col")),)
            out = np.asarray(fn(*args, mesh=mesh))
            np.save(os.path.join(d, f"{algo}_{variant}_{n}.npy"), out)
""")


def _inputs(n):
    rng = np.random.default_rng(n)
    a = rng.standard_normal((n, n)).astype(np.float32)
    b = rng.standard_normal((n, n)).astype(np.float32)
    u = (np.triu(rng.standard_normal((n, n))) + 3 * np.eye(n)).astype(
        np.float32)
    m = rng.standard_normal((n, n))
    s = (m @ m.T + n * np.eye(n)).astype(np.float32)
    return {"A": a, "B": b, "U": u, "S": s}


def _oracle(algo, x):
    a, b, u, s = (x[k].astype(np.float64) for k in "ABUS")
    if algo in ("cannon", "summa"):
        return a @ b
    if algo == "trsm":
        return b @ np.linalg.inv(u)
    return np.linalg.cholesky(s)


def _rel(got, want):
    return np.abs(np.asarray(got, np.float64) - want).max() / \
        np.abs(want).max()


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("reference")
    for n in SIZES:
        for k, v in _inputs(n).items():
            np.save(d / f"{k}{n}.npy", v)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=9"
    out = subprocess.run([sys.executable, "-c", REFERENCE, SRC, str(d)],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return d


@pytest.mark.parametrize("local_kernel", ["jnp", "pallas"])
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("algo,variant", sorted(ALGORITHMS))
def test_variant_matches_reference(reference, algo, variant, n,
                                   local_kernel):
    x = _inputs(n)
    c, g = (2, 2) if variant.startswith("2.5d") else (1, 3)
    grid = make_grid_mesh(g, g, layers=c, devices=[CPU] * (c * g * g))
    hooks = dispatch._local_hooks(algo, local_kernel,
                                  tiles_for_plan(CPU_HOST, algo, n, g,
                                                 "float32"))
    t = {k: torch.tensor(v) for k, v in x.items()}
    out_spec = BLOCK
    if algo in ("cannon", "summa"):
        args = (distribute(t["A"], grid), distribute(t["B"], grid))
    elif algo == "trsm":
        out_spec = ROWS_OVER_LAYERS if c > 1 else BLOCK
        args = (distribute(t["U"], grid), distribute(t["B"], grid, out_spec))
    else:
        args = (distribute(t["S"], grid),)
    got = collect(ALGORITHMS[(algo, variant)](*args, grid=grid, **hooks),
                  grid, out_spec).numpy()
    want = np.load(reference / f"{algo}_{variant}_{n}.npy")
    assert _rel(got, want.astype(np.float64)) < 1e-4
    assert _rel(got, _oracle(algo, x)) < 1e-4


@pytest.mark.parametrize("local_kernel", ["jnp", "pallas"])
@pytest.mark.parametrize("p", [1, 4, 8, 9])
@pytest.mark.parametrize("op", ["matmul", "trsm", "cholesky"])
def test_entry_point_on_cpu_ranks(op, p, local_kernel, tmp_path):
    """Model-guided dispatch end to end; n = 100 is padded to every grid."""
    n = 100
    x = _inputs(n)
    args = {"matmul": ("A", "B"), "trsm": ("U", "B"), "cholesky": ("S",)}[op]
    tuner = Tuner(cache=PlanCache(str(tmp_path)))
    from repro_torch import linalg
    got = getattr(linalg, op)(*(torch.tensor(x[k]) for k in args),
                              devices=[CPU] * p, tuner=tuner,
                              local_kernel=local_kernel)
    algo = "cannon" if op == "matmul" else op
    assert got.shape == (n, n)
    assert _rel(got.numpy(), _oracle(algo, x)) < 1e-4


@pytest.mark.parametrize("op", ["matmul", "trsm", "cholesky"])
def test_blocked_kernels_engage_on_cpu_ranks(op, tmp_path):
    """Local blocks of 256 pass every wrapper threshold, so the blocked
    kernel wrappers (their plain versions here) run under dispatch."""
    n = 512
    x = _inputs(n)
    args = {"matmul": ("A", "B"), "trsm": ("U", "B"), "cholesky": ("S",)}[op]
    tuner = Tuner(cache=PlanCache(str(tmp_path)))
    plan = tuner.plan(op, n, devices=[CPU] * 4, local_kernel="pallas")
    assert plan.g == 2
    got = dispatch.execute(plan, *(torch.tensor(x[k]) for k in args),
                           devices=[CPU] * 4)
    algo = "cannon" if op == "matmul" else op
    assert _rel(got.numpy(), _oracle(algo, x)) < 1e-4


def test_distribute_collect_round_trip():
    x = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    grid = make_grid_mesh(2, 2, layers=2, devices=[CPU] * 8)
    blocks = distribute(x, grid)
    assert blocks.shape == (2, 2, 2, 4, 6)
    assert torch.equal(blocks[1, 1, 0], x[4:, :6])
    assert torch.equal(collect(blocks, grid), x)
    rows = distribute(x, grid, ROWS_OVER_LAYERS)
    assert rows.shape == (2, 2, 2, 2, 6)
    assert torch.equal(rows[1, 0, 1], x[4:6, 6:])
    assert torch.equal(collect(rows, grid, ROWS_OVER_LAYERS), x)


def test_ranks_on_several_devices_need_a_later_backend():
    with pytest.raises(NotImplementedError):
        make_grid_mesh(1, 2, devices=[CPU, torch.device("meta")])
