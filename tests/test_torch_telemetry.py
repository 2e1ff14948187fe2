"""The port's telemetry layer against the reference's: one JSONL record
schema (a store written by either package loads in the other), the same
residual join, refit, drift and report on the same records, and observed
dispatch that records the reference's fields, phase names and predicted
keys."""

import dataclasses
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import telemetry as ref_tel
from repro.tuner import PlanCache as RefPlanCache
from repro.tuner import Tuner as RefTuner
from repro.tuner import build_default_registry as ref_registry
from repro.tuner.dispatch import execute as ref_execute
from repro.tuner.plan import ExecutionPlan as RefPlan
from repro_torch import linalg
from repro_torch import telemetry as tel
from repro_torch.tuner import PlanCache, Tuner, build_default_registry
from repro_torch.tuner import dispatch
from repro_torch.tuner.plan import ExecutionPlan

CPU = torch.device("cpu")
# the refit modules (each package's ``telemetry.refit`` name is the function)
REFIT = importlib.import_module("repro_torch.telemetry.refit")
REF_REFIT = importlib.import_module("repro.telemetry.refit")
# (op, variant) pairs whose cost-IR programs both registries hold
SCENARIOS = [("summa", "2d"), ("cannon", "2.5d_ovlp"), ("trsm", "2d_ovlp"),
             ("cholesky", "2.5d")]


@pytest.fixture(autouse=True)
def _isolated_telemetry():
    """Neither package's global recording state (nor a record in the repo's
    artifacts directory) leaks out of a test."""
    tel.reset()
    ref_tel.reset()
    yield
    tel.reset()
    ref_tel.reset()


#: measured execute over the model's prediction: around it, and where F6
#: (ROADMAP.md, R4) puts the quickstart's CPU products, which torch runs 80x
#: to 150x faster than CPU_HOST predicts
AROUND, F6 = (0.3, 4.0), (1 / 150, 1 / 80)


def _record_fields(seed: int, n_runs: int = 12, ratio=AROUND):
    """Record fields drawn from a numpy seed: measured phases around the
    model's prediction (execute at ``ratio`` of it), an overhead phase, one
    named model phase where the program has it.  At F6's ratios a record
    holds execute alone, as the quickstart records it."""
    rng = np.random.default_rng(seed)
    reg = ref_registry()
    out = []
    for i in range(n_runs):
        algo, variant = SCENARIOS[i % len(SCENARIOS)]
        n = int(rng.choice([1024, 4096, 16384]))
        p, c = ((8, 2) if variant.startswith("2.5d") else
                (int(rng.choice([1, 4, 16])), 1))
        ctx = reg.machine("cpu-host").context()
        res = reg.evaluate_grid(ctx, algo, variant, float(n), float(p),
                                float(c), 1.0)
        phases = {"execute": float(res.total) * float(rng.uniform(*ratio)),
                  "distribute": float(rng.uniform(1e-4, 1e-2))}
        named = sorted(res.phases)
        if ratio == F6:
            phases = {"execute": phases["execute"]}
        elif named:
            ph = named[int(rng.integers(len(named)))]
            if float(res.phases[ph].exposed) > 0:
                phases[ph] = float(res.phases[ph].exposed) * float(
                    rng.uniform(0.5, 2.0))
        out.append(dict(fingerprint="fp-cpu", machine="cpu-host", op=algo,
                        variant=variant, n=n, p=p, c=c, phases=phases,
                        predicted={"total": float(res.total)},
                        meta={"seed": seed, "i": i},
                        timestamp=1000.0 + i))
    return out


def _rows(mod, fields):
    return mod.join([mod.RunRecord(**f) for f in fields],
                    build_default_registry() if mod is tel
                    else ref_registry())


def _row_tuple(r):
    return (r.op, r.variant, r.n, r.p, r.c, r.phase, r.measured, r.source,
            r.machine, r.timestamp)


# -- the store ---------------------------------------------------------------

def test_schema_and_switches_equal_the_reference():
    assert tel.TELEMETRY_SCHEMA == ref_tel.TELEMETRY_SCHEMA
    assert ([f.name for f in dataclasses.fields(tel.RunRecord)]
            == [f.name for f in dataclasses.fields(ref_tel.RunRecord)])


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_a_store_written_by_one_package_loads_in_the_other(writer, tmp_path):
    fields = _record_fields(1, n_runs=6)
    w_mod, r_mod = (tel, ref_tel) if writer == "port" else (ref_tel, tel)
    store = w_mod.RunStore(str(tmp_path))
    for f in fields:
        store.append(w_mod.RunRecord(**f))
    loaded = r_mod.RunStore(str(tmp_path)).load()
    assert [dataclasses.asdict(r) for r in loaded] == [
        dataclasses.asdict(r_mod.RunRecord(**f)) for f in fields]
    assert r_mod.RunStore(str(tmp_path)).fingerprints() == ["fp-cpu"]


def test_env_switches_match(monkeypatch, tmp_path):
    """The recording switch is the reference's; the store's location is
    the port's own (``REPRO_TORCH_TELEMETRY_DIR``)."""
    monkeypatch.setenv("REPRO_TELEMETRY_DIR", str(tmp_path / "ref"))
    monkeypatch.setenv("REPRO_TORCH_TELEMETRY_DIR", str(tmp_path / "port"))
    assert ref_tel.telemetry_dir() == str(tmp_path / "ref")
    assert tel.telemetry_dir() == str(tmp_path / "port")
    monkeypatch.delenv("REPRO_TELEMETRY_DIR")
    monkeypatch.delenv("REPRO_TORCH_TELEMETRY_DIR")
    monkeypatch.delenv("REPRO_TORCH_ARTIFACTS", raising=False)
    assert tel.telemetry_dir() != ref_tel.telemetry_dir()
    for value, on in (("1", True), ("0", False), ("", False)):
        monkeypatch.setenv("REPRO_TELEMETRY", value)
        assert tel.enabled() is on and ref_tel.enabled() is on


def test_phase_timer_and_kernel_timer_records_equal(tmp_path):
    recs = []
    for mod in (tel, ref_tel):
        pt = mod.PhaseTimer("summa", variant="2d", n=4096, p=16,
                            machine="cpu-host", fingerprint="f",
                            predicted={"total": 2.0})
        pt.add("execute", 1.5)
        pt.add("execute", 0.5)
        pt.add("plan", 0.25)
        kt = mod.kernel_timer("matmul", (512, 256, 384),
                              {"bm": 128, "bn": 128, "bk": 256},
                              itemsize=4, machine="tpu-v5e", fingerprint="k")
        kt.add("execute", 1e-3)
        recs.append([dataclasses.asdict(pt.record()),
                     dataclasses.asdict(kt.record())])
    for a, b in zip(*recs):
        a.pop("timestamp")
        b.pop("timestamp")
        assert a == b


# -- join, refit, drift, report on the same records ------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_join_matches_the_reference(seed):
    fields = _record_fields(seed)
    got, want = _rows(tel, fields), _rows(ref_tel, fields)
    assert len(got) == len(want) > len(fields)
    for g, w in zip(got, want):
        assert _row_tuple(g) == _row_tuple(w)
        for attr in ("predicted", "pred_comm", "pred_comp"):
            assert getattr(g, attr) == pytest.approx(getattr(w, attr),
                                                     rel=1e-9, abs=0)
    assert tel.mean_abs_log_ratio(got) == pytest.approx(
        ref_tel.mean_abs_log_ratio(want), rel=1e-9)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_join_include_sim_matches_the_reference(seed):
    """The simulator flavor of the join: one source="sim" total row per
    joinable record beside the model rows, equal to the reference's."""
    fields = _record_fields(seed)
    got = tel.join([tel.RunRecord(**f) for f in fields],
                   build_default_registry(), include_sim=True)
    want = ref_tel.join([ref_tel.RunRecord(**f) for f in fields],
                        ref_registry(), include_sim=True)
    assert [_row_tuple(g) for g in got] == [_row_tuple(w) for w in want]
    for g, w in zip(got, want):
        assert g.predicted == pytest.approx(w.predicted, rel=1e-12, abs=0)
    sim_rows = [r for r in got if r.source == "sim"]
    assert len(sim_rows) == len(fields)
    assert {r.phase for r in sim_rows} == {"total"}
    # the model rows are those of the plain join
    assert [_row_tuple(r) for r in got if r.source == "model"] == \
        [_row_tuple(r) for r in _rows(tel, fields)]


@pytest.mark.parametrize("seed,ratio", [
    pytest.param(0, AROUND, id="0"), pytest.param(3, AROUND, id="3"),
    pytest.param(0, F6, id="f6-0"), pytest.param(3, F6, id="f6-3")])
def test_refit_matches_the_reference(seed, ratio):
    """The two refits on the same rows, and the quickstart's report after
    each (refit, apply, join again, overall mean relative error).  At F6's
    ratios both clamp the speed scale at MAX_SCALE alike: F6 is the shared
    model's limit (ROADMAP.md, R4), not a fault of the port."""
    fields = _record_fields(seed, ratio=ratio)
    port_reg, ref_reg = build_default_registry(), ref_registry()
    got = tel.refit(tel.join([tel.RunRecord(**f) for f in fields], port_reg),
                    port_reg)
    want = ref_tel.refit(ref_tel.join([ref_tel.RunRecord(**f)
                                       for f in fields], ref_reg), ref_reg)
    assert dataclasses.asdict(got.machine) == dataclasses.asdict(want.machine)
    assert got.fingerprint == want.fingerprint
    assert "torch" not in got.machine.notes.lower()
    for attr in ("speed_scale", "shape_scale", "comm_scale"):
        assert getattr(got, attr) == pytest.approx(getattr(want, attr),
                                                   rel=1e-9)
    assert (got.n_comp_rows, got.n_comm_rows) == (want.n_comp_rows,
                                                  want.n_comm_rows)
    assert ({k: dataclasses.asdict(v) for k, v in got.efficiency.items()}
            == {k: dataclasses.asdict(v) for k, v in want.efficiency.items()})
    assert type(got.calibration).__name__ == type(want.calibration).__name__
    assert (dataclasses.asdict(got.calibration)
            == dataclasses.asdict(want.calibration))
    if ratio == F6:
        assert REFIT.MAX_SCALE == REF_REFIT.MAX_SCALE
        assert got.speed_scale == want.speed_scale == REFIT.MAX_SCALE
    reports = []
    for mod, result, reg in ((tel, got, port_reg), (ref_tel, want, ref_reg)):
        result.apply(reg)
        rows = mod.join([mod.RunRecord(**f) for f in fields], reg)
        reports.append(mod.accuracy_report(rows)["overall"])
    assert reports[0]["n_rows"] == reports[1]["n_rows"]
    assert reports[0]["mean_rel_err"] == pytest.approx(
        reports[1]["mean_rel_err"], rel=0, abs=1e-9)


def test_refit_kernels_matches_the_reference():
    rng = np.random.default_rng(5)
    fields = []
    for i in range(6):
        m, k, n = (int(x) for x in rng.choice([256, 512, 1024], 3))
        blocks = {"bm": 128, "bn": 128, "bk": int(rng.choice([128, 256]))}
        fields.append(dict(
            fingerprint="k", machine="tpu-v5e", op="kernel:matmul",
            variant="pallas", n=max(m, k, n), p=1, c=1, kind="kernel",
            phases={"execute": float(rng.uniform(1e-3, 1e-1))},
            meta={"kernel": "matmul", "shape": [m, k, n], "tile": blocks,
                  "itemsize": 4}, timestamp=10.0 + i))
    got = tel.refit_kernels([tel.RunRecord(**f) for f in fields],
                            build_default_registry())
    want = ref_tel.refit_kernels([ref_tel.RunRecord(**f) for f in fields],
                                 ref_registry())
    assert dataclasses.asdict(got.machine) == dataclasses.asdict(want.machine)
    assert got.fingerprint == want.fingerprint
    assert got.n_rows == want.n_rows


def _residuals(mod, op, rel_errs, t0=0.0):
    return [mod.Residual(op=op, variant="2d", n=64, p=1, c=1,
                         phase="execute", measured=1.0, predicted=1.0 + e,
                         machine="cpu-host", timestamp=t0 + i)
            for i, e in enumerate(rel_errs)]


@pytest.mark.parametrize("errs", [[0.1, 0.2, 0.05], [2.0, 3.0, 1.5, 4.0],
                                  [5.0, 5.0]])
def test_drift_matches_the_reference(errs):
    statuses = []
    bumped = []
    for mod, reg in ((tel, build_default_registry()),
                     (ref_tel, ref_registry())):
        rows = _residuals(mod, "summa", errs) + _residuals(mod, "trsm",
                                                           [0.01] * 4)
        st = mod.check(rows, latch=mod.DriftLatch())
        statuses.append({k: dataclasses.asdict(v) | {"drifted": v.drifted}
                         for k, v in st.items()})
        new = mod.detect_and_invalidate(rows, reg, "cpu-host",
                                        latch=mod.DriftLatch())
        bumped.append(None if new is None else dataclasses.asdict(new))
    assert statuses[0] == statuses[1]
    assert bumped[0] == bumped[1]


@pytest.mark.parametrize("seed", [0, 4])
def test_report_matches_the_reference(seed, tmp_path):
    fields = _record_fields(seed)
    got = tel.accuracy_report(_rows(tel, fields))
    want = ref_tel.accuracy_report(_rows(ref_tel, fields))
    assert got == want
    assert tel.format_report(got) == ref_tel.format_report(want)
    path = tel.save_report(got, str(tmp_path / "report.json"))
    assert os.path.exists(path)


# -- recording from the tuner and dispatch ----------------------------------

def test_plan_observe_records_like_the_reference(tmp_path):
    port_store = tel.RunStore(str(tmp_path / "port"))
    ref_store = ref_tel.RunStore(str(tmp_path / "ref"))
    port = Tuner(cache=PlanCache(str(tmp_path / "pp")), store=port_store)
    ref = RefTuner(cache=RefPlanCache(str(tmp_path / "rp")), store=ref_store)
    for _ in range(2):      # the second call is a cache hit, also recorded
        port.plan("trsm", 4096, device_count=16, platform="cpu",
                  observe=True)
        ref.plan("trsm", 4096, device_count=16, platform="cpu",
                 observe=True)
    got = [dataclasses.asdict(r) for r in port_store.load()]
    want = [dataclasses.asdict(r) for r in ref_store.load()]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        g.pop("timestamp")
        w.pop("timestamp")
        assert g == w
    assert port.stats["observed"] == ref.stats["observed"] == 2


def _shape_of(rec):
    return (rec.kind, rec.op, rec.variant, rec.n, rec.p, rec.c, rec.dtype,
            rec.machine, rec.fingerprint, sorted(rec.phases),
            sorted(rec.predicted))


@pytest.mark.parametrize("op", ["matmul", "trsm", "cholesky"])
def test_observed_execute_records_the_reference_fields(op, tmp_path):
    """One frozen plan (p = 1), executed by both packages on the CPU with
    observe=True: one record each, equal in everything but the measured
    seconds; the port's result agrees with the reference's."""
    rng = np.random.default_rng(11)
    n = 96
    a = rng.standard_normal((n, n)).astype(np.float32)
    if op == "matmul":
        args = (a, rng.standard_normal((n, n)).astype(np.float32))
    elif op == "trsm":
        args = (np.triu(a) + n * np.eye(n, dtype=np.float32), a)
    else:
        args = (a @ a.T + n * np.eye(n, dtype=np.float32),)
    ref_plan = RefTuner(cache=RefPlanCache(str(tmp_path / "rp"))).plan(
        op, n, device_count=1, platform="cpu")
    plan = ExecutionPlan.from_dict(ref_plan.to_dict())
    ref_store = ref_tel.RunStore(str(tmp_path / "ref"))
    port_store = tel.RunStore(str(tmp_path / "port"))
    want = ref_execute(RefPlan.from_dict(ref_plan.to_dict()),
                       *(jnp.asarray(x) for x in args),
                       devices=jax.devices()[:1], observe=True,
                       store=ref_store)
    got = dispatch.execute(plan, *(torch.tensor(x) for x in args),
                           devices=[CPU], observe=True, store=port_store)
    [g], [w] = port_store.load(), ref_store.load()
    assert _shape_of(g) == _shape_of(w)
    assert sorted(g.phases) == ["distribute", "execute"]
    assert all(v > 0 for v in g.phases.values())
    assert g.predicted == w.predicted
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("op", ["matmul", "cholesky"])
def test_observed_wrapper_records_plan_and_dispatch(op, tmp_path):
    """Through the model-guided wrapper (p = 4 stacked on the CPU): the
    plan record and the dispatch record with plan, distribute and execute
    phases, as the reference's wrapper emits them."""
    rng = np.random.default_rng(12)
    n = 64
    a = rng.standard_normal((n, n)).astype(np.float32)
    args = (a, a) if op == "matmul" else (a @ a.T + n * np.eye(
        n, dtype=np.float32),)
    store = tel.RunStore(str(tmp_path / "port"))
    tuner = Tuner(cache=PlanCache(str(tmp_path / "pp")), store=store)
    getattr(linalg, op)(*(torch.tensor(x) for x in args), devices=[CPU] * 4,
                        tuner=tuner, observe=True)
    kinds = [(r.kind, sorted(r.phases)) for r in store.load()]
    assert kinds == [("plan", []),
                     ("dispatch", ["distribute", "execute", "plan"])]
    rows = tel.join(store.load(), build_default_registry())
    assert [r.phase for r in rows] == ["execute"]


def test_unobserved_dispatch_records_nothing(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_TELEMETRY", raising=False)
    monkeypatch.delenv("REPRO_OBS", raising=False)
    store = tel.RunStore(str(tmp_path / "port"))
    tuner = Tuner(cache=PlanCache(str(tmp_path / "pp")), store=store)
    linalg.matmul(torch.eye(32), torch.eye(32), devices=[CPU], tuner=tuner)
    assert store.load() == []


def test_global_switch_records_into_the_enabled_store(tmp_path):
    store = tel.enable(tel.RunStore(str(tmp_path / "on")))
    tuner = Tuner(cache=PlanCache(str(tmp_path / "pp")))
    linalg.matmul(torch.eye(32), torch.eye(32), devices=[CPU], tuner=tuner)
    [rec] = store.load()
    assert rec.kind == "dispatch" and rec.op in ("cannon", "summa")
