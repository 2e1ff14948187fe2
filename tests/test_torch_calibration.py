"""The port's measuring half against the reference's: the paper's tables,
the paper-fit loss functions at fixed parameters (the >100 s fits
themselves are not run), the closed-form fits on the same seeded inputs,
the routine benchmark on the CPU, and the measured profile's new
fingerprint."""

import dataclasses
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import calibration as ref_cal
from repro.core import paper_data as ref_paper
from repro.core.perfmodel import ParametricCalibration as RefCalibration
from repro_torch import kernels
from repro_torch.benchmarks import fig1_blas_efficiency as fig1
from repro_torch.core import calibration as cal
from repro_torch.core import paper_data
from repro_torch.core.machine import H100_SXM
from repro_torch.core.perfmodel import ParametricCalibration, ROUTINE_FLOPS
from repro_torch.tuner import PlanCache, Tuner, build_default_registry

ALGOS = list(paper_data.PAPER_TABLES)
# the joint fit's starting point: 5 calibration parameters, then
# (eff_max, n0) for dgemm, dtrsm, dpotrf (fit_hopper_joint's x0)
THETA0 = cal.THETA0


def _perturbed(x0, seed):
    """x0 scaled elementwise by a seeded factor in [0.8, 1.25]."""
    rng = np.random.default_rng(seed)
    return x0 * np.exp(rng.uniform(np.log(0.8), np.log(1.25), x0.shape))


# -- paper data ---------------------------------------------------------------

def test_paper_tables_equal_the_reference():
    assert paper_data.CORE_COUNTS == ref_paper.CORE_COUNTS
    assert paper_data.VARIANTS == ref_paper.VARIANTS
    assert paper_data.PAPER_TABLES == ref_paper.PAPER_TABLES
    assert paper_data.CLAIMED_CROSSOVER == ref_paper.CLAIMED_CROSSOVER


@pytest.mark.parametrize("algo", ALGOS)
def test_table_best_variant_equals_the_reference(algo):
    for size in paper_data.PAPER_TABLES[algo]:
        for cores in paper_data.CORE_COUNTS:
            assert (paper_data.table_best_variant(algo, size, cores)
                    == ref_paper.table_best_variant(algo, size, cores))


# -- the paper-fit losses at fixed parameters --------------------------------

@pytest.mark.parametrize("seed", [None, 1, 2])
@pytest.mark.parametrize("algos", [["cannon"], ALGOS], ids=["cannon", "all"])
def test_table_residuals_equal_the_reference(algos, seed):
    x0 = ParametricCalibration().params()
    theta = x0 if seed is None else _perturbed(x0, seed)
    got = cal._table_residuals(ParametricCalibration.from_params(theta),
                               algos)
    want = ref_cal._table_residuals(RefCalibration.from_params(theta), algos)
    assert got.shape == want.shape and got.size > 0
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("seed", [None, 1, 2])
@pytest.mark.parametrize("core_idx", [None, (0, 2, 4)])
def test_joint_residuals_equal_the_reference(core_idx, seed):
    theta = THETA0 if seed is None else _perturbed(THETA0, seed)
    got = cal._residuals_ctx(cal._ctx_from_theta(theta), ALGOS, core_idx)
    want = ref_cal._residuals_ctx(ref_cal._ctx_from_theta(theta), ALGOS,
                                  core_idx)
    assert got.shape == want.shape and got.size > 0
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def test_ctx_from_theta_clips_like_the_reference():
    theta = THETA0.copy()
    theta[5:] = [1.5, 20.0, -0.3, 5000.0, 0.1, 90.0]
    got = cal._ctx_from_theta(theta).comp.efficiency
    want = ref_cal._ctx_from_theta(theta).comp.efficiency
    assert ({k: dataclasses.asdict(v) for k, v in got.items()}
            == {k: dataclasses.asdict(v) for k, v in want.items()})


def test_validation_reports_equal_the_reference():
    calib = ParametricCalibration()
    got = cal.validation_report(calib)
    want = ref_cal.validation_report(RefCalibration())
    assert got == pytest.approx(want, rel=1e-12)
    got = cal.joint_validation_report(cal._ctx_from_theta(THETA0))
    want = ref_cal.joint_validation_report(ref_cal._ctx_from_theta(THETA0))
    assert got.keys() == want.keys()
    for algo in got:
        assert got[algo] == pytest.approx(want[algo], rel=1e-12)


# -- the closed-form fits ------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fit_efficiency_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    sizes = (128, 256, 512, 1024, 2048, 4096)
    em, n0 = rng.uniform(0.5, 0.95), rng.uniform(100.0, 2000.0)
    peak = 5e10
    rates = {n: peak * em * (1 - np.exp(-n / n0)) * rng.uniform(0.9, 1.1)
             for n in sizes}
    got = cal.fit_efficiency(rates, peak)
    want = ref_cal.fit_efficiency(rates, peak)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("seed", [0, 1])
def test_fit_alpha_beta_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    ping = {int(w): 2e-6 + 4e-10 * w * rng.uniform(0.9, 1.1)
            for w in (256, 1024, 4096, 16384, 65536, 262144)}
    assert cal.fit_alpha_beta(ping) == ref_cal.fit_alpha_beta(ping)


# -- the routine benchmark on the CPU ---------------------------------------

@pytest.mark.parametrize("route", ["kernels", "library"])
def test_bench_routines_on_the_cpu(route):
    entries = cal.time_routines((128, 256), device="cpu", route=route,
                                reps=1)
    assert [(e["routine"], e["n"]) for e in entries] == [
        (r, n) for n in (128, 256) for r in ROUTINE_FLOPS]
    for e in entries:
        assert np.isfinite(e["flops_per_s"]) and e["flops_per_s"] > 0
        assert e["seconds"] > 0
        # CPU tensors run the kernels' plain versions: nothing launches
        assert set(e["launches"]) == set(kernels.launches())
        assert not any(e["launches"].values())
    rates = cal.rates(entries)
    assert set(rates) == set(ROUTINE_FLOPS)
    assert all(set(v) == {128, 256} for v in rates.values())


def test_bench_routines_refuses_an_unknown_route():
    with pytest.raises(ValueError, match="route"):
        cal.bench_routines((128,), device="cpu", route="cublas")


def test_bench_routines_needs_a_device_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cal.bench_routines((128,))


def test_link_benchmarks_refuse_without_a_group():
    """Stacked ranks have no link: ping and contention name ``group=``
    (tests/test_torch_distributed.py runs them over one)."""
    with pytest.raises(ValueError, match="group="):
        cal.bench_ping()
    with pytest.raises(ValueError, match="group="):
        cal.bench_contention(4, 1)


# -- the measured profile -----------------------------------------------------

def _synthetic_bench(seed):
    rng = np.random.default_rng(seed)
    return {r: {n: 4e13 * rng.uniform(0.2, 0.9) * (1 - np.exp(-n / 900.0))
                for n in (256, 1024, 4096, 16384)} for r in ROUTINE_FLOPS}


def test_measured_compute_model_keeps_the_reference_semantics():
    bench = _synthetic_bench(3)
    model = cal.measured_compute_model(bench=bench)
    peak = max(bench["dgemm"].values())
    assert model.machine.peak_flops_per_unit == peak
    assert dataclasses.replace(model.machine, peak_flops_per_unit=67e12) \
        == H100_SXM
    for rout, vals in bench.items():
        want = ref_cal.fit_efficiency(vals, peak)
        assert dataclasses.asdict(model.efficiency[rout]) \
            == dataclasses.asdict(want)


def test_registered_profile_rekeys_the_plan_cache(tmp_path):
    registry = build_default_registry()
    seed_fp = registry.machine("h100-sxm").machine.fingerprint()
    model = cal.measured_compute_model(bench=_synthetic_bench(4))
    machine = cal.register_measured_profile(registry, model)
    assert machine.revision == H100_SXM.revision + 1
    assert machine.notes.startswith("measured")
    assert machine.peak_flops_per_unit == model.machine.peak_flops_per_unit
    surface = registry.machine("h100-sxm")
    assert surface.machine == machine
    assert machine.fingerprint() != seed_fp
    assert dict(surface.efficiency) == dict(model.efficiency)
    # the process default registry is untouched
    assert build_default_registry().machine("h100-sxm").machine == H100_SXM
    kw = dict(device_count=1, platform="cuda", device_kind="NVIDIA H100")
    seed_plan = Tuner(cache=PlanCache(str(tmp_path))).plan("matmul", 16384,
                                                           **kw)
    tuner = Tuner(registry=registry, cache=PlanCache(str(tmp_path)))
    plan = tuner.plan("matmul", 16384, **kw)
    assert plan.fingerprint != seed_plan.fingerprint
    assert tuner.stats["model_evals"] == 1     # no hit on the seed's plan
    assert plan.predicted["total"] != seed_plan.predicted["total"]


# -- the Fig. 1 entry point ----------------------------------------------------

def test_fig1_prints_the_reference_shape():
    out = fig1.main((128, 256), device="cpu", route="library", reps=1)
    assert out["device"] == "cpu" and out["route"] == "library"
    assert set(out["routines"]) == set(ROUTINE_FLOPS)
    peak = out["peak_gflops"]
    assert peak == max(out["routines"]["dgemm"]["gflops"].values())
    for row in out["routines"].values():
        assert set(row) == {"gflops", "launches", "eff_max", "n0"}
        assert set(row["gflops"]) == {"128", "256"}
        assert all(v > 0 for v in row["gflops"].values())
    json.dumps(out)


def test_fig1_module_runs_on_the_cpu():
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.benchmarks.fig1_blas_efficiency",
         "--device", "cpu", "--route", "kernels", "--sizes", "128",
         "--reps", "1"], capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["routines"]["dgemm"]["launches"] == {"128": {}}
