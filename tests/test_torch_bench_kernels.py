"""The port's kernel-tier bench (``repro_torch.benchmarks.bench_kernels``)
against the reference's ``benchmarks/bench_kernels.py`` on the CPU.

The choice (the refit, the fitted times, the shortlist, the chosen plan and
its ratio) is held to the reference's arithmetic on one seeded synthetic
sweep; ``main`` on the CPU keeps the reference's keys and meets its CI
gates; the H100's kernel-tier seed stays off ``H100_SXM``.  Timing numbers
are not asserted: under ``pytest-xdist`` they are noise.
"""

import dataclasses
import json

import numpy as np
import pytest

from repro_torch.benchmarks import bench_kernels, run
from repro_torch.core.machine import H100_KERNEL_SEED, H100_SXM
from repro_torch.kernels.matmul import CTA_TILES, cta_tile
from repro_torch.perf.kernel import KernelModel, TilePlan
from repro_torch.tuner.registry import build_default_registry

#: the reference's JSON keys (benchmarks/bench_kernels.py, main)
REF_KEYS = {"machine", "n", "itemsize", "sweep", "default_tile",
            "chosen_tile", "shortlist_size", "tuned_over_default", "refit",
            "family_interpret_us"}
REF_ROW_KEYS = {"tile", "measured_us", "fitted_us", "in_shortlist"}
REF_REFIT_KEYS = {"compute_scale", "loop_scale", "n_rows", "revision",
                  "overhead_factor", "loop_overhead"}


def _sweep(seed, n, machine="cpu-host"):
    """Measured seconds a plan: the seed model's time, scaled by a seeded
    factor per plan."""
    rng = np.random.default_rng(seed)
    model = KernelModel(build_default_registry().machine(machine).machine)
    return {t: model.time("matmul", (n, n, n), TilePlan.make(
                "matmul", bm=t[0], bn=t[1], bk=t[2]), 4)
            * float(rng.uniform(0.4, 2.5))
            for t in bench_kernels.SWEEP_TILES}


def _reference_choice(measured, n):
    """The reference's stages 2 and 3 on ``measured`` (its main, past the
    sweep)."""
    from repro.perf.kernel import KernelModel as RefModel
    from repro.perf.kernel import TilePlan as RefPlan
    from repro.perf.kernel import heuristic_plan
    from repro.telemetry import kernel_timer, refit_kernels
    from repro.tuner.registry import build_default_registry as ref_registry
    registry = ref_registry()
    model0 = RefModel(registry.machine("cpu-host").machine)
    records = []
    for t, secs in measured.items():
        tp = RefPlan.make("matmul", bm=t[0], bn=t[1], bk=t[2])
        pt = kernel_timer("matmul", (n, n, n), tp, dtype="float32",
                          machine="cpu-host", itemsize=4,
                          predicted={"total": model0.time(
                              "matmul", (n, n, n), tp, 4)})
        pt.add("execute", secs)
        records.append(pt.record())
    refit = refit_kernels(records, registry, "cpu-host")
    machine1 = refit.apply(registry)
    model1 = RefModel(machine1)
    fitted = {t: model1.time("matmul", (n, n, n), RefPlan.make(
                  "matmul", bm=t[0], bn=t[1], bk=t[2]), 4)
              for t in measured}
    default = heuristic_plan("matmul", (n, n, n), 4)
    default_t = (default["bm"], default["bn"], default["bk"])
    best = min(fitted.values())
    shortlist = sorted(t for t, s in fitted.items()
                       if s <= bench_kernels.SHORTLIST_SLACK * best)
    if default_t not in shortlist:
        shortlist.append(default_t)
    chosen = min(shortlist, key=lambda t: measured[t])
    return {"refit": refit, "machine1": machine1, "fitted": fitted,
            "shortlist": shortlist, "chosen": chosen,
            "ratio": measured[default_t] / measured[chosen]}


@pytest.mark.parametrize("seed,n", [(0, 512), (1, 512), (2, 256),
                                    (3, 4096)])
def test_choice_equals_the_reference(seed, n):
    measured = _sweep(seed, n)
    want = _reference_choice(measured, n)
    got = bench_kernels.choose_tile(measured, build_default_registry(),
                                    "cpu-host", n, 4)
    assert got["shortlist"] == want["shortlist"]
    assert got["chosen"] == want["chosen"]
    assert got["ratio"] == pytest.approx(want["ratio"], rel=1e-12)
    assert got["refit"].n_rows == want["refit"].n_rows == len(measured)
    for key in ("compute_scale", "loop_scale", "h2d_scale", "d2h_scale"):
        assert getattr(got["refit"], key) == pytest.approx(
            getattr(want["refit"], key), rel=1e-12)
    got_kc = dataclasses.asdict(got["machine1"].kernel_constants)
    want_kc = dataclasses.asdict(want["machine1"].kernel_constants)
    assert got_kc == pytest.approx(want_kc, rel=1e-12)
    assert got["machine1"].revision == want["machine1"].revision == 1
    for t in measured:
        assert got["fitted"][t] == pytest.approx(want["fitted"][t],
                                                 rel=1e-12)


def test_the_sweep_covers_k1s_tiles():
    tiles = [cta_tile(TilePlan.make("matmul", bm=m, bn=n, bk=k))
             for m, n, k in bench_kernels.SWEEP_TILES]
    assert sorted(tiles) == sorted(CTA_TILES)
    assert (256, 256, 512) in bench_kernels.SWEEP_TILES


def test_main_on_the_cpu_meets_the_reference_gates(tmp_path, monkeypatch):
    monkeypatch.setattr(run, "OUT", str(tmp_path))
    res = run.run_bench("kernels", "cpu")
    with open(tmp_path / "BENCH_kernels.json") as f:
        saved = json.load(f)
    assert "_meta" in saved and saved["n"] == bench_kernels.N_CPU
    out = bench_kernels.main(device="cpu", n=256)
    for doc in (res, out):
        assert set(doc) - {"_meta"} == (REF_KEYS - {"family_interpret_us"}
                                        | {"family_us", "device"})
        assert doc["device"] == "cpu" and doc["machine"] == "cpu-host"
        assert set(doc["family_us"]) == {"matmul", "trsm", "cholesky"}
        assert set(doc["refit"]) == REF_REFIT_KEYS
        for row in doc["sweep"]:
            assert set(row) == REF_ROW_KEYS | {"cta_tile"}
        # the reference CI's gates (.github/workflows/ci.yml)
        assert doc["tuned_over_default"] >= 1.0
        r = doc["refit"]
        assert r["revision"] >= 1
        assert (r["overhead_factor"][0] != r["overhead_factor"][1]
                or r["loop_overhead"][0] != r["loop_overhead"][1])
        assert len({tuple(row["cta_tile"]) for row in doc["sweep"]}) >= 4
    assert out["n"] == 256


def test_the_h100_seed_stays_off_the_profile():
    assert H100_SXM.kernel_constants is None
    assert "kernel_constants" not in {k for k, v in dataclasses.asdict(
        H100_SXM).items() if v is not None}
    assert build_default_registry().machine(
        "h100-sxm").machine.kernel_constants is None
    seeded = bench_kernels._registry("cuda").machine("h100-sxm").machine
    assert seeded.kernel_constants == H100_KERNEL_SEED
    assert seeded.fingerprint() != H100_SXM.fingerprint()
    assert dataclasses.replace(seeded, kernel_constants=None) == H100_SXM
    # the data sheet's rates, as the profile states them
    assert H100_KERNEL_SEED.fma_rate == H100_SXM.peak_flops_per_unit
    assert H100_KERNEL_SEED.bw_h2d == H100_SXM.hbm_bandwidth
    # every plan of the sweep is feasible on the seed
    model = KernelModel(seeded)
    for bm, bn, bk in bench_kernels.SWEEP_TILES:
        tiles = {"bm": np.asarray(float(bm)), "bn": np.asarray(float(bn)),
                 "bk": np.asarray(float(bk))}
        assert bool(model.feasible("matmul", (4096, 4096, 4096), tiles, 4))
