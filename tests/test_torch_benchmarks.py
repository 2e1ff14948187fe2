"""The port's benchmark harness (``repro_torch.benchmarks``) against the
reference's (the repository's ``benchmarks/``) on the CPU.

The host-side emitters (tables, the LM-step model, the simulator, faults,
serving's replay and re-key) equal the reference's on the same inputs.
Fig. 5-8 runs on 4 gloo ranks at n = 512: every residual against the
library, and every estimate rebuilt by the reference's ``evaluate`` from
the parameters the JSON carries.  The tuner bench runs on 8 stacked CPU
ranks against the reference's 8 forced host devices (a subprocess).
Timing numbers are not asserted: under ``pytest-xdist`` they are noise.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.benchmarks import (bench_faults, bench_obs, bench_serving,
                                    bench_sim, bench_sim_scale, bench_tuner,
                                    common, fig5to8_validation, run,
                                    tables_2to5_predictions)
from repro_torch.core import calibration as cal

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SRC = os.path.join(ROOT, "src")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: the joint fit's starting point: the tables run on it without the
#: two-minute Hopper fit
THETA0 = cal.THETA0
ALGOS = ("cannon", "summa", "trsm", "cholesky")
VARIANTS_2D = [f"{a}_{v}" for a in ALGOS for v in ("2d", "2d_ovlp")]


@pytest.fixture
def artifacts(tmp_path, monkeypatch):
    """Both packages' artifacts (traces, dashboards) under ``tmp_path``:
    the reference's root and the port's (``REPRO_TORCH_ARTIFACTS``, read
    at each call, the harness's included)."""
    from repro.core import calibration as ref_cal
    monkeypatch.setattr(ref_cal, "ARTIFACTS_DIR", str(tmp_path))
    monkeypatch.setenv("REPRO_TORCH_ARTIFACTS", str(tmp_path))
    return tmp_path


# -- tables II-V -------------------------------------------------------------

@pytest.fixture(scope="module")
def tables():
    """The port's tables on THETA0, and the reference's context on it."""
    from repro.core import calibration as ref_cal
    return (tables_2to5_predictions.main(cal._ctx_from_theta(THETA0)),
            ref_cal._ctx_from_theta(THETA0))


def _rounded(tbl):
    return {str(n): {str(c): {v: round(p, 2) for v, p in row.items()}
                     for c, row in by.items()}
            for n, by in tbl.items()}


@pytest.mark.parametrize("algo", ALGOS)
def test_tables_equal_the_reference(tables, algo):
    from repro.core.paper_data import CORE_COUNTS, PAPER_TABLES
    from repro.core.predictor import prediction_table
    got, ref_ctx = tables
    want = prediction_table(ref_ctx, algo, list(PAPER_TABLES[algo]),
                            CORE_COUNTS)
    assert got["hopper"][algo] == _rounded(want)


@pytest.mark.parametrize("algo", ALGOS)
def test_v5e_tables_equal_the_reference(tables, algo):
    from repro.core import AlgoContext, CommModel, ComputeModel, TPU_V5E
    from repro.core.perfmodel import TPU_EFFICIENCY
    from repro.core.predictor import prediction_table
    from repro.sim import derive_calibration, v5e_pod_topology
    got, _ = tables
    ref = AlgoContext(CommModel(TPU_V5E, derive_calibration(
        v5e_pod_topology(), ps=[16, 64, 256], distances=[1, 2, 4, 8, 16])),
        ComputeModel(TPU_V5E, TPU_EFFICIENCY))
    want = prediction_table(ref, algo, [65536, 131072], [64, 256, 1024])
    assert got["tpu_v5e"][algo] == _rounded(want)


def test_table_claims_and_validation_equal_the_reference(tables):
    from repro.core import calibration as ref_cal
    from repro.core.machine import HOPPER
    from repro.core.paper_data import (CLAIMED_CROSSOVER, CORE_COUNTS,
                                       PAPER_TABLES, table_best_variant)
    from repro.core.predictor import best_variant, crossover_core_count
    got, ref_ctx = tables
    match = total = 0
    for algo in ALGOS:
        for size in PAPER_TABLES[algo]:
            for cores in CORE_COUNTS:
                ours = best_variant(ref_ctx, algo, size,
                                    cores // HOPPER.threads_per_unit)
                best = min(ours, key=lambda v: ours[v].result.total)
                total += 1
                match += best == table_best_variant(algo, size, cores)
    assert got["claims"]["best_variant_agreement"] == match / total
    for algo in ALGOS:
        size = max(PAPER_TABLES[algo])
        assert got["claims"][f"crossover_{algo}"] == crossover_core_count(
            ref_ctx, algo, size, CORE_COUNTS)
        assert (got["claims"][f"crossover_{algo}_expected"]
                == CLAIMED_CROSSOVER[algo])
    want = ref_cal.joint_validation_report(ref_ctx)
    assert got["validation"].keys() == want.keys()
    for algo in want:
        assert got["validation"][algo] == pytest.approx(want[algo],
                                                        rel=1e-12)


# -- the LM-step model --------------------------------------------------------

@pytest.fixture(scope="module")
def lm_rows():
    return run.lm_model_rows()


@pytest.mark.parametrize("arch", ["qwen1.5-110b", "arctic-480b",
                                  "granite-20b"])
def test_lm_model_equals_the_reference(lm_rows, arch):
    from repro.configs import SHAPES, get
    from repro.core.lm_model import predict_train_step
    cfg = get(arch)
    want = predict_train_step(cfg, SHAPES["train_4k"],
                              {"data": 16, "model": 16},
                              fsdp=cfg.param_count() * 2 / 16 > 4e9).to_dict()
    assert lm_rows[arch] == pytest.approx(want, rel=1e-12)


# -- the simulator benches ----------------------------------------------------

def test_bench_sim_equals_the_reference(artifacts):
    import benchmarks.bench_sim as ref
    got, want = bench_sim.main(), ref.main()
    assert got["events"] == want["events"]
    assert got["sim_over_nocal"] == pytest.approx(want["sim_over_nocal"],
                                                  rel=1e-12)
    assert got["max_rel_err_nocal"] <= 1e-6
    assert want["max_rel_err_nocal"] <= 1e-6
    assert got["agreement_nocal"] == pytest.approx(want["agreement_nocal"],
                                                   abs=1e-12)
    assert os.path.dirname(got["trace"]) == str(artifacts / "traces_torch")


def test_bench_sim_scale_equals_the_reference():
    import benchmarks.bench_sim_scale as ref
    got, want = bench_sim_scale.main(), ref.main()
    assert got["max_rel_err_vs_reference"] <= 1e-6
    assert got["p256"]["events"] == want["p256"]["events"]
    assert got["events_p24576"] == want["events_p24576"]
    assert got["sim_total_p24576_s"] == pytest.approx(
        want["sim_total_p24576_s"], rel=1e-12)


def test_bench_faults_equals_the_reference():
    import benchmarks.bench_faults as ref
    got, want = bench_faults.main(), ref.main()
    assert got["agreement"]["max_rel_err_vs_reference"] <= 1e-6
    assert got["agreement"]["per_program"] == pytest.approx(
        want["agreement"]["per_program"], abs=1e-12)
    for key in ("localized_correct", "plan_flipped", "healthy_plan",
                "degraded_plan"):
        assert got["replan"][key] == want["replan"][key], key
    assert got["replan"]["localized_correct"]
    assert got["replan"]["makespan_improvement"] == pytest.approx(
        want["replan"]["makespan_improvement"], rel=1e-12)
    for key in ("n_shed", "n_deadline_missed", "n_finished"):
        assert got["serving"][key] == want["serving"][key], key
    assert got["recovery_decisions"] == want["recovery_decisions"]


# -- serving ------------------------------------------------------------------

@pytest.fixture
def fresh_cost_caches(monkeypatch):
    """Each package's serving cost-model cache empty for the test and put
    back after it (``_rekey`` installs scales into it)."""
    from repro.serving import cost as ref_cost
    from repro_torch.serving import cost
    monkeypatch.setattr(ref_cost, "_CACHE", {})
    monkeypatch.setattr(cost, "_CACHE", {})


def test_serving_replay_equals_the_reference(fresh_cost_caches):
    import benchmarks.bench_serving as ref
    from repro.serving.cost import ServeScales as RefScales
    from repro_torch.serving.cost import ServeScales
    pinned = dict(prefill_scale=0.357, decode_scale=2.497, overhead_s=7.5e-4)
    got = bench_serving._replay(ServeScales(**pinned), n_requests=1000)
    want = ref._replay(RefScales(**pinned), n_requests=1000)
    got.pop("replay_wall_s")
    want.pop("replay_wall_s")
    assert got == want


def test_serving_rekey(fresh_cost_caches):
    out = bench_serving._rekey()
    assert out == {"calibrated_scale": 2.0, "post_bump_scale": 1.0,
                   "rekey_ok": True}


def test_serving_calibration_on_the_cpu(fresh_cost_caches):
    """Phase A on the CPU: measured serve steps, their records, a refit."""
    out = bench_serving._calibrate(n_requests=4, device="cpu")
    assert out["requests"] == 4 and out["steps"] > 0
    assert out["serve_step_records"] == out["steps"]
    assert out["residual_rows"] > 0
    assert np.isfinite(out["mean_rel_err_after_refit"])
    assert set(out["scales"]) == {"prefill_scale", "decode_scale",
                                  "overhead_s"}


# -- obs ----------------------------------------------------------------------

def test_bench_obs_writes_the_paired_trace_under_art(artifacts):
    out = bench_obs.main(device="cpu")
    assert out["serving_trace_flow_events"] > 0
    path = artifacts / "traces_torch" / "serving_paired_trace.json"
    with open(path) as f:
        doc = json.load(f)
    assert {ev["pid"] for ev in doc["traceEvents"] if "pid" in ev} == {0, 1}
    assert sum(ev.get("ph") == "s" for ev in doc["traceEvents"]) \
        == out["serving_trace_flow_events"]
    assert (artifacts / "traces_torch" / "obs_bench_trace.json").exists()
    assert (artifacts / "obs_torch" / "dashboard_bench.html").exists()


# -- the tuner ----------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_tuner():
    """The reference's bench_tuner on 8 forced host devices."""
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + ROOT,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-m", "benchmarks.bench_tuner"],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_bench_tuner_matches_the_reference(ref_tuner):
    got = bench_tuner.main(device="cpu")
    assert got["n"] == ref_tuner["n"] == 256
    assert got["devices"] == ref_tuner["devices"] == 8
    assert got["auto"] == ref_tuner["auto"]
    assert got["worst"] == ref_tuner["worst"]
    assert got["predicted_speedup_auto_vs_worst"] == pytest.approx(
        ref_tuner["predicted_speedup_auto_vs_worst"], rel=1e-12)
    assert got["model_eval"]["scenarios"] >= 200
    assert got["model_eval"]["scenarios"] == \
        ref_tuner["model_eval"]["scenarios"]
    assert set(got["model_eval"]["models"]) == \
        set(ref_tuner["model_eval"]["models"])


# -- Figs. 5-8 ----------------------------------------------------------------

@pytest.fixture(scope="module")
def fig5to8():
    return fig5to8_validation.main(world=4, n=512, device="cpu")


def _ref_context(out):
    """The reference's context rebuilt from the JSON alone."""
    from repro.core import (AlgoContext, CalibrationTable, CommModel,
                            ComputeModel, EfficiencyCurve)
    from repro.core.machine import CPU_HOST
    machine = dataclasses.replace(
        CPU_HOST, peak_flops_per_unit=out["machine_peak_per_unit"],
        threads_per_unit=1, latency=out["latency_s"],
        inv_bandwidth=out["beta"])
    curves = {r: EfficiencyCurve(c["eff_max"], c["n0"])
              for r, c in out["compute_curves"].items()}
    avg = {float(d): f for d, f in out["measured_factors"].items()}
    mx = {(float(out["p"]), d): f for d, f in avg.items()}
    return AlgoContext(CommModel(machine, CalibrationTable(
        avg=avg, mx=mx, extrapolation_degree=1)),
        ComputeModel(machine, curves))


def test_fig5to8_keys(fig5to8):
    assert set(fig5to8) == {
        "n", "p", "machine_peak_per_unit", "latency_s", "beta",
        "measured_factors", "results", "geomean_rel_err_cal",
        "geomean_rel_err_nocal",
        # the port's additions
        "compute_curves", "calibration_launches", "transport", "device",
        "world"}
    assert (fig5to8["n"], fig5to8["p"], fig5to8["world"]) == (512, 4, 4)
    assert fig5to8["transport"] == "gloo, cpu tensors"
    assert fig5to8["device"] == "cpu"
    assert sorted(fig5to8["results"]) == sorted(VARIANTS_2D)
    assert set(fig5to8["measured_factors"]) == {"1.0", "2.0"}
    assert set(fig5to8["compute_curves"]) == {"dgemm", "dtrsm", "dsyrk",
                                              "dpotrf", "dgetrf"}
    # each rank's launches in the routine benchmark: none on the CPU
    assert len(fig5to8["calibration_launches"]) == 4
    assert all(v == 0 for counts in fig5to8["calibration_launches"]
               for v in counts.values())
    json.dumps(fig5to8)


def _link_word_types_rank(rank, world, device, which):
    """One rank of a bench's link step; returns the word type of each link
    benchmark it ran."""
    import torch.distributed as dist
    from repro_torch.benchmarks import fig2_alpha_beta, fig34_calibration
    torch.set_num_threads(1)
    seen = set()
    setup = cal._link_setup

    def recording(name, *args, **kwargs):
        dev, dtype = setup(name, *args, **kwargs)
        seen.add((name, str(dtype).removeprefix("torch.")))
        return dev, dtype

    cal._link_setup = recording
    if which == "fig5to8":
        fig5to8_validation.measure_links(dist.group.WORLD,
                                         torch.device(device), 2)
    else:
        {"fig2": fig2_alpha_beta, "fig34": fig34_calibration}[
            which].measure(rank, world, device)
    return sorted(seen)


@pytest.mark.parametrize("which,world,benches", [
    ("fig2", 2, ("bench_ping",)),
    ("fig34", 4, ("bench_contention", "bench_ping")),
    ("fig5to8", 4, ("bench_contention", "bench_ping")),
])
def test_links_send_the_references_words(which, world, benches):
    """The reference's ping and contention ask for float64, which JAX
    without x64 gives as float32: its beta is per 4-byte word, the word of
    its fp32 blocks.  The port's link benchmarks send the same words."""
    import warnings
    import jax.numpy as jnp
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = str(jnp.ones((1,), jnp.float64).dtype)
    got = common.run_group_bench(_link_word_types_rank, world, "cpu",
                                 args=(which,))
    assert got == [(name, ref) for name in benches]
    assert ref == "float32"


@pytest.mark.parametrize("variant", VARIANTS_2D)
def test_fig5to8_variant(fig5to8, variant):
    """Each 2D variant: its collected output within 1e-4 of the library,
    no kernel launched on the CPU, and both estimates the reference's
    model on the parameters the JSON carries."""
    from repro.core import evaluate
    from repro.perf import EvalOptions
    row = fig5to8["results"][variant]
    assert row["rel_residual"] < 1e-4
    assert row["measured_s"] > 0.0
    assert len(row["launches"]) == 4
    assert all(v == 0 for counts in row["launches"] for v in counts.values())
    algo, v = variant.split("_", 1)
    ctx = _ref_context(fig5to8)
    n, p = fig5to8["n"], fig5to8["p"]
    assert row["est_cal_s"] == pytest.approx(
        evaluate(ctx, algo, v, n, p, r=1).total, rel=1e-12)
    assert row["est_nocal_s"] == pytest.approx(
        evaluate(ctx, algo, v, n, p, r=1,
                 options=EvalOptions("nocal")).total, rel=1e-12)
    assert row["cal_rel_err"] == pytest.approx(
        abs(row["est_cal_s"] - row["measured_s"]) / row["measured_s"])


def test_fig5to8_refuses_a_non_square_world():
    with pytest.raises(ValueError, match="not a square"):
        fig5to8_validation.main(world=3, device="cpu")


def test_fig5to8_compute_sizes():
    assert fig5to8_validation.compute_sizes(256) == (128, 256)
    assert fig5to8_validation.compute_sizes(4096) == (128, 256, 512, 1024,
                                                      2048, 4096)
    assert fig5to8_validation.compute_sizes(300) == (128, 256, 300)
    assert fig5to8_validation.compute_sizes(64) == (32, 64)


# -- no CPU fallback ----------------------------------------------------------

@pytest.mark.parametrize("call", [
    lambda: fig5to8_validation.main(world=4, device="cuda"),
    lambda: bench_tuner.main(device="cuda"),
    lambda: bench_obs.main(device="cuda"),
    lambda: bench_serving._calibrate(device="cuda"),
], ids=["fig5to8", "tuner", "obs", "serving"])
def test_device_benches_raise_without_a_gpu(call, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


# -- the stamp and the CLI ----------------------------------------------------

def test_fingerprint_differs_from_the_reference_suite(monkeypatch):
    import benchmarks.common as ref_common
    monkeypatch.delenv("REPRO_BENCH_FINGERPRINT", raising=False)
    assert common.machine_fingerprint() != ref_common.machine_fingerprint()
    meta = common.run_meta()
    assert set(meta) >= {"commit", "timestamp", "fingerprint", "repeats"}
    if not torch.cuda.is_available():
        assert "device" not in meta and "power_limit_w" not in meta


def test_run_cli_writes_stamped_jsons(tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC,
               REPRO_TORCH_ARTIFACTS=str(tmp_path))
    env.pop("REPRO_BENCH_FINGERPRINT", None)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.benchmarks.run", "--device",
         "cpu", "--only", "sim", "faults", "lm_model"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[0] == "name,us_per_call,derived"
    assert not any("_FAILED" in line for line in lines)
    written = sorted(os.listdir(tmp_path / "bench_torch"))
    assert written == ["BENCH_faults.json", "BENCH_sim.json",
                       "lm_model.json"]
    for name in written:
        with open(tmp_path / "bench_torch" / name) as f:
            meta = json.load(f)["_meta"]
        assert meta["fingerprint"] and meta["timestamp"] > 0


def test_run_cli_fails_a_bench_that_raises(tmp_path, monkeypatch, capsys):
    """A bench that raises prints ``<name>_FAILED`` and its traceback, the
    others still run, and the run exits 1."""
    def boom():
        raise RuntimeError("bench gave up")
    monkeypatch.setenv("REPRO_TORCH_ARTIFACTS", str(tmp_path))
    monkeypatch.setitem(run.BENCHES, "sim", boom)
    with pytest.raises(SystemExit) as exc:
        run.main(["--device", "cpu", "--only", "sim", "lm_model"])
    assert exc.value.code == 1
    captured = capsys.readouterr()
    assert "sim_FAILED" in captured.out
    assert "lm_model_qwen1.5-110b" in captured.out
    assert "bench gave up" in captured.err
    assert os.listdir(tmp_path / "bench_torch") == ["lm_model.json"]


def test_check_regressions_warns_on_an_empty_history(tmp_path, monkeypatch,
                                                      capsys):
    bench_dir = tmp_path / "bench_torch"
    bench_dir.mkdir()
    (bench_dir / "BENCH_x.json").write_text(json.dumps(
        {"events_per_sec": 50.0, "_meta": common.run_meta()}))
    monkeypatch.setenv("REPRO_TORCH_BENCH_HISTORY_DIR",
                       str(tmp_path / "hist"))
    monkeypatch.setenv("REPRO_TORCH_ARTIFACTS", str(tmp_path))
    assert run.check_regressions() == 0
    assert "warn-only" in capsys.readouterr().out
    assert (tmp_path / "hist" / "history.jsonl").exists()
