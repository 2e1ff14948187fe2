"""The linalg path's group backend: ranks as processes of a gloo group on
the CPU (``repro_torch.distributed``, ``linalg.collectives.GroupComm``).

Each world is spawned once per module (file store under ``tmp_path``, no
TCP port, one thread a rank): P 9 runs the 2D variants on a 3x3 grid (a
shift by -1 and by +1 differ only for g > 2), P 8 the 2.5D variants on
2x2x2, both local-kernel choices at n = 48 and 96 on the inputs of
``tests/test_torch_linalg.py``.  Rank 0's outputs are held to the
reference's ``shard_map`` variants (its subprocess with 9 forced host
devices) within 1e-4, the reference's dispatch gate, and to the stacked
backend within 1e-6 (the ranks' sums may add in another order; Cannon 2D
has no sum and is held bitwise).  The worlds also run the model-guided
entry points, the round trips of ``distribute`` / ``collect``, the
overlap check (the next step's operations are still pending when a
product starts) and the link benchmarks.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core import calibration as cal
from repro_torch.core.machine import CPU_HOST
from repro_torch.distributed import spawn
from repro_torch.linalg import (ALGORITHMS, BLOCK, ROWS_OVER_LAYERS, collect,
                                distribute, make_grid_mesh)
from repro_torch.perf.kernel import tiles_for_plan
from repro_torch.tuner import PlanCache, Tuner, dispatch
from test_torch_linalg import REFERENCE, SIZES, _inputs, _oracle, _rel

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
CPU = torch.device("cpu")
KERNELS = ("jnp", "pallas")
#: (layers, g) of each kind's grid, and the world that runs it
GRIDS = {"2d": (1, 3), "2.5d": (2, 2)}
WORLDS = {"2d": 9, "2.5d": 8}
ENTRY_N = 100
OPERANDS = {"matmul": ("A", "B"), "trsm": ("U", "B"), "cholesky": ("S",)}


def _args(algo, x, grid, c):
    """The distributed operands of one variant, and its output spec."""
    if algo in ("cannon", "summa"):
        return (distribute(x["A"], grid), distribute(x["B"], grid)), BLOCK
    if algo == "trsm":
        spec = ROWS_OVER_LAYERS if c > 1 else BLOCK
        return (distribute(x["U"], grid),
                distribute(x["B"], grid, spec)), spec
    return (distribute(x["S"], grid),), BLOCK


def _hooks(algo, local_kernel, n, g, log, comm):
    """The dispatch hooks, with ``local_mm`` logging how many operations
    the rank has started and not waited for when each product starts."""
    hooks = dispatch._local_hooks(algo, local_kernel,
                                  tiles_for_plan(CPU_HOST, algo, n, g,
                                                 "float32"))
    mm = hooks.get("local_mm", torch.matmul)

    def local_mm(a, b):
        log.append(comm.pending)
        return mm(a, b)
    return {**hooks, "local_mm": local_mm}


# -- the ranks' bodies (module-level: spawn pickles them by name) ------------

def _variants_rank(rank, world, device, plan_dir, kind):
    torch.set_num_threads(1)
    group = dist.group.WORLD
    c, g = GRIDS[kind]
    grid = make_grid_mesh(g, g, layers=c, devices=[device] * world,
                          group=group)
    outputs, pending = {}, {}
    for n in SIZES:
        x = {k: torch.tensor(v) for k, v in _inputs(n).items()}
        for local_kernel in KERNELS:
            for (algo, variant), fn in sorted(ALGORITHMS.items()):
                if variant.startswith("2.5d") != (kind == "2.5d"):
                    continue
                log = []
                args, spec = _args(algo, x, grid, c)
                hooks = _hooks(algo, local_kernel, n, g, log, grid.comm)
                out = collect(fn(*args, grid=grid, **hooks), grid, spec)
                key = (algo, variant, n, local_kernel)
                pending[key] = (log, grid.comm.pending)
                if rank == 0:
                    outputs[key] = out.numpy()
    # distribute / collect round trips under both partitions
    m = torch.arange(12 * 6, dtype=torch.float32).reshape(12, 6)
    trips = {}
    for spec in (BLOCK, ROWS_OVER_LAYERS):
        block = distribute(m, grid, spec)
        trips[str(spec)] = (tuple(block.shape), block.numpy(),
                            bool(torch.equal(collect(block, grid, spec), m)))
    return {"outputs": outputs, "pending": pending, "trips": trips,
            "coords": grid.coords,
            "entry": _entry_points(rank, world, device, plan_dir)}


def _entry_points(rank, world, device, plan_dir, observe=False):
    """The model-guided entry points on the world, each rank with a plan
    cache of its own: the results and what each rank's tuner did."""
    from repro_torch import linalg, telemetry
    x = {k: torch.tensor(v) for k, v in _inputs(ENTRY_N).items()}
    out = {}
    store = telemetry.RunStore(os.path.join(plan_dir, f"store{rank}"))
    for local_kernel in KERNELS:
        for op, names in OPERANDS.items():
            tuner = Tuner(cache=PlanCache(os.path.join(
                plan_dir, f"{op}{local_kernel}{rank}")), store=store)
            got = getattr(linalg, op)(*(x[k] for k in names),
                                      devices=[device] * world, tuner=tuner,
                                      local_kernel=local_kernel,
                                      group=dist.group.WORLD,
                                      observe=observe)
            out[(op, local_kernel)] = (got.numpy(), dict(tuner.stats))
    records = [(r.op, r.kind, sorted(r.phases), dict(r.meta))
               for r in store.load()]
    return out, records


def _round_trip_rank(rank, world, device, plan_dir):
    torch.set_num_threads(1)
    return _entry_points(rank, world, device, plan_dir)


def _links_rank(rank, world, device, plan_dir):
    torch.set_num_threads(1)
    group = dist.group.WORLD
    ping = cal.bench_ping(sizes_words=(256, 4096, 65536), reps=2,
                          group=group, device=device)
    contention = {d: cal.bench_contention(world, d, words=1 << 14, reps=2,
                                          group=group, device=device)
                  for d in (1, 2)}
    entry = _entry_points(rank, world, device, plan_dir, observe=True)
    return {"ping": ping, "contention": contention, "entry": entry}


def _failing_rank(rank, world, device):
    if rank == 1:
        raise ValueError("rank 1 gives up")
    dist.barrier()
    return rank


def _hanging_rank(rank, world, device):
    import time
    if rank == 1:
        time.sleep(600)
    return rank


# -- fixtures ----------------------------------------------------------------

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


def _world(tmp_path_factory, name, fn, world, *args):
    d = tmp_path_factory.mktemp(name)
    return spawn(fn, world, init_dir=str(d / "init"), timeout_s=180,
                 args=(str(d / "plans"), *args))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The P 9 (2D) and P 8 (2.5D) worlds' results, by kind."""
    return {kind: _world(tmp_path_factory, f"world{world}", _variants_rank,
                         world, kind)
            for kind, world in WORLDS.items()}


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _world(tmp_path_factory, "world4", _links_rank, 4)


@pytest.fixture(scope="module")
def world5(tmp_path_factory):
    return _world(tmp_path_factory, "world5", _round_trip_rank, 5)


def _stacked(algo, variant, n, local_kernel):
    kind = "2.5d" if variant.startswith("2.5d") else "2d"
    c, g = GRIDS[kind]
    grid = make_grid_mesh(g, g, layers=c, devices=[CPU] * (c * g * g))
    x = {k: torch.tensor(v) for k, v in _inputs(n).items()}
    args, spec = _args(algo, x, grid, c)
    hooks = dispatch._local_hooks(algo, local_kernel,
                                  tiles_for_plan(CPU_HOST, algo, n, g,
                                                 "float32"))
    return collect(ALGORITHMS[(algo, variant)](*args, grid=grid, **hooks),
                   grid, spec).numpy()


def _kind(variant):
    return "2.5d" if variant.startswith("2.5d") else "2d"


# -- the 16 variants ---------------------------------------------------------

@pytest.mark.parametrize("local_kernel", KERNELS)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("algo,variant", sorted(ALGORITHMS))
def test_group_variant_matches_reference(worlds, reference, algo, variant,
                                         n, local_kernel):
    got = worlds[_kind(variant)][0]["outputs"][(algo, variant, n,
                                                local_kernel)]
    want = np.load(reference / f"{algo}_{variant}_{n}.npy")
    assert _rel(got, want.astype(np.float64)) < 1e-4
    assert _rel(got, _oracle(algo, _inputs(n))) < 1e-4


@pytest.mark.parametrize("local_kernel", KERNELS)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("algo,variant", sorted(ALGORITHMS))
def test_group_variant_matches_stacked(worlds, algo, variant, n,
                                       local_kernel):
    got = worlds[_kind(variant)][0]["outputs"][(algo, variant, n,
                                                local_kernel)]
    want = _stacked(algo, variant, n, local_kernel)
    if algo == "cannon" and variant in ("2d", "2d_ovlp"):
        assert np.array_equal(got, want)
    assert _rel(got, want.astype(np.float64)) < 1e-6


@pytest.mark.parametrize("algo,variant", sorted(ALGORITHMS))
def test_overlap_starts_the_next_step_before_the_product(worlds, algo,
                                                         variant):
    """The overlap variants' products start while the next step's
    operations are in flight (started, not yet waited for) on the group;
    the serialized variants' products never do.  Nothing is left pending
    after a call."""
    ranks = worlds[_kind(variant)]
    c, g = GRIDS[_kind(variant)]
    for n in SIZES:
        for local_kernel in KERNELS:
            logs = [r["pending"][(algo, variant, n, local_kernel)]
                    for r in ranks]
            assert all(left == 0 for _log, left in logs)
            seen = [log for log, _left in logs]
            if not variant.endswith("ovlp"):
                assert all(k == 0 for log in seen for k in log)
            elif algo == "cholesky":
                # look-ahead: at step j < g - 1, every rank outside
                # column j + 1 has the next pivot's collective in flight
                for r, log in zip(ranks, seen):
                    col = r["coords"][2]
                    assert [k > 0 for k in log] == [
                        col != j + 1 for j in range(g - 1)] + [False]
            else:
                # every step but the last prefetches the next one's blocks
                assert all(all(k > 0 for k in log[:-1]) and log[-1] == 0
                           for log in seen)


@pytest.mark.parametrize("kind", sorted(WORLDS))
@pytest.mark.parametrize("spec", [BLOCK, ROWS_OVER_LAYERS], ids=str)
def test_distribute_collect_round_trip_on_a_group(worlds, kind, spec):
    c, g = GRIDS[kind]
    m = np.arange(12 * 6, dtype=np.float32).reshape(12, 6)
    split = c * g if spec == ROWS_OVER_LAYERS else g
    rb, cb = 12 // split, 6 // g
    for r in worlds[kind]:
        shape, block, round_trip = r["trips"][str(spec)]
        l, i, j = r["coords"]
        bi = l * g + i if spec == ROWS_OVER_LAYERS else i
        assert shape == (1, 1, 1, rb, cb)
        assert np.array_equal(block[0, 0, 0],
                              m[bi * rb:(bi + 1) * rb, j * cb:(j + 1) * cb])
        assert round_trip


# -- the model-guided entry points --------------------------------------------

def _entry_results(ranks, op, local_kernel):
    return [r[0][(op, local_kernel)] if isinstance(r, tuple)
            else r["entry"][0][(op, local_kernel)] for r in ranks]


@pytest.mark.parametrize("local_kernel", KERNELS)
@pytest.mark.parametrize("world", [4, 9])
@pytest.mark.parametrize("op", sorted(OPERANDS))
def test_entry_point_on_a_group(worlds, world4, op, world, local_kernel):
    """Every rank gets the result; only rank 0 planned, so every rank ran
    its plan whatever its own plan cache holds."""
    ranks = worlds["2d"] if world == 9 else world4
    results = _entry_results(ranks, op, local_kernel)
    algo = "cannon" if op == "matmul" else op
    want = _oracle(algo, _inputs(ENTRY_N))
    first = results[0][0]
    assert first.shape == (ENTRY_N, ENTRY_N)
    assert _rel(first, want) < 1e-4
    for got, stats in results[1:]:
        assert np.array_equal(got, first)
        assert stats["model_evals"] == stats["cache_hits"] == 0
    assert results[0][1]["model_evals"] == 1


@pytest.mark.parametrize("op", sorted(OPERANDS))
def test_rank_beyond_the_plan_gets_the_result(world5, op):
    """On 5 ranks the plan takes a 2x2 grid; rank 4 is not on it and still
    receives the result."""
    results = _entry_results([r for r in world5], op, "pallas")
    algo = "cannon" if op == "matmul" else op
    assert _rel(results[4][0], _oracle(algo, _inputs(ENTRY_N))) < 1e-4
    assert all(np.array_equal(got, results[0][0]) for got, _s in results)


def test_observed_call_on_a_group_emits_one_record_from_rank_0(world4):
    """``observe=True``: rank 0 records each plan and each dispatch, with
    the slowest rank's phases and the transport; the other ranks record
    nothing."""
    records = [r["entry"][1] for r in world4]
    assert all(not rec for rec in records[1:])
    dispatched = [r for r in records[0] if r[1] == "dispatch"]
    assert len(dispatched) == 2 * len(OPERANDS)
    for _op, _kind, phases, meta in dispatched:
        assert {"plan", "distribute", "execute"} <= set(phases)
        assert meta["world"] == 4 and meta["comm_s"] > 0.0
        assert meta["transport"] == "gloo, cpu tensors"


# -- the link benchmarks ------------------------------------------------------

def test_bench_ping_over_a_group(world4):
    pings = [r["ping"] for r in world4]
    assert set(pings[0]) == {256, 4096, 65536}
    assert all(0.0 < t < 1.0 and np.isfinite(t) for t in pings[0].values())
    assert all(p == pings[0] for p in pings)
    L, beta = cal.fit_alpha_beta(pings[0])
    assert L > 0.0 and beta > 0.0


@pytest.mark.parametrize("distance", [1, 2])
def test_bench_contention_over_a_group(world4, distance):
    walls = [r["contention"][distance] for r in world4]
    assert 0.0 < walls[0] < 1.0 and np.isfinite(walls[0])
    assert all(w == walls[0] for w in walls)


# the reference's JSON keys (benchmarks/fig2_alpha_beta.py,
# benchmarks/fig34_calibration.py) and the port's additions
FIG_KEYS = {"fig2_alpha_beta": {"latency_s", "beta_s_per_word",
                                "bandwidth_GBps", "ping"},
            "fig34_calibration": {"measured_factor_vs_distance", "ideal_s",
                                  "simulated"}}
ADDED_KEYS = {"transport", "world", "device"}


@pytest.mark.parametrize("module,world", [("fig2_alpha_beta", 2),
                                          ("fig34_calibration", 4)])
def test_link_benchmark_entry_point_on_the_cpu(tmp_path, monkeypatch,
                                                module, world):
    import importlib
    import json
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    bench = importlib.import_module(f"repro_torch.benchmarks.{module}")
    out = bench.main(world=world, device="cpu")
    assert set(out) == FIG_KEYS[module] | ADDED_KEYS
    assert out["transport"] == "gloo, cpu tensors"
    assert out["world"] == world and out["device"] == "cpu"
    json.dumps(out)
    if module == "fig2_alpha_beta":
        assert [int(w) for w in out["ping"]] == list(bench.SIZES)
        assert all(0.0 < t < 10.0 for t in out["ping"].values())
        assert out["latency_s"] > 0.0 and out["beta_s_per_word"] > 0.0
        assert out["bandwidth_GBps"] == pytest.approx(
            bench.WORD_BYTES / out["beta_s_per_word"] / 1e9)
    else:
        assert set(out["measured_factor_vs_distance"]) == {"1", "2"}
        assert all(f > 0.0 and np.isfinite(f)
                   for f in out["measured_factor_vs_distance"].values())
        assert out["ideal_s"] > 0.0
        assert set(out["simulated"]) == {"hopper3d", "v5e2d"}
        assert len(out["simulated"]["hopper3d"]) == 12


# -- spawn ---------------------------------------------------------------------

def test_a_failing_rank_fails_the_world_with_its_traceback(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1 gives up") as err:
        spawn(_failing_rank, 3, init_dir=str(tmp_path), timeout_s=60)
    assert "rank 1 of 3 failed" in str(err.value)


def test_a_hanging_rank_fails_the_world_with_its_stack(tmp_path):
    with pytest.raises(RuntimeError, match="_hanging_rank") as err:
        spawn(_hanging_rank, 2, init_dir=str(tmp_path), timeout_s=5)
    assert "rank 1 of 2 exited" in str(err.value)
