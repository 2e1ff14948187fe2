"""The port's copy of the planning closure against the reference.

Plans, model values and profiles must agree exactly, so that state frozen
by the reference (a plan in the cache, a refitted machine profile) loads
and executes in the port.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro.core.machine import CPU_HOST as REF_CPU_HOST
from repro.core.machine import MACHINES as REF_MACHINES
from repro.tuner import PlanCache as RefPlanCache
from repro.tuner import Tuner as RefTuner
from repro.tuner import build_default_registry as ref_registry
from repro_torch.core import (HOPPER, AlgoContext, CommModel, ComputeModel,
                              IdentityCalibration, ParametricCalibration,
                              evaluate)
from repro_torch.core.machine import H100_SXM, Machine
from repro_torch.core.perfmodel import HOPPER_EFFICIENCY
from repro_torch.tuner import (ExecutionPlan, PlanCache, Tuner,
                               build_default_registry, machine_for_platform)
from repro_torch.tuner import dispatch

GOLD_PATH = os.path.join(os.path.dirname(__file__), "golden",
                         "model_values.json")
with open(GOLD_PATH) as _f:
    ENTRIES = json.load(_f)["entries"]
KEYS = sorted({(e["algo"], e["variant"]) for e in ENTRIES})
CTX = {
    "param": AlgoContext(CommModel(HOPPER, ParametricCalibration()),
                         ComputeModel(HOPPER, HOPPER_EFFICIENCY)),
    "identity": AlgoContext(CommModel(HOPPER, IdentityCalibration()),
                            ComputeModel(HOPPER, HOPPER_EFFICIENCY)),
}
CPU = torch.device("cpu")


def _tuners(tmp_path, ref_reg=None, port_reg=None):
    return (RefTuner(registry=ref_reg,
                     cache=RefPlanCache(str(tmp_path / "ref"))),
            Tuner(registry=port_reg, cache=PlanCache(str(tmp_path / "port"))))


@pytest.mark.parametrize("n", [96, 4096, 16384])
@pytest.mark.parametrize("p", [1, 4, 8, 9])
@pytest.mark.parametrize("op", ["matmul", "trsm", "cholesky"])
def test_plan_equals_reference(op, p, n, tmp_path):
    ref, port = _tuners(tmp_path)
    want = ref.plan(op, n, device_count=p, platform="cpu")
    got = port.plan(op, n, device_count=p, platform="cpu")
    assert got.to_dict() == want.to_dict()


@pytest.mark.parametrize("algo,variant", KEYS)
def test_evaluator_matches_golden(algo, variant):
    for e in ENTRIES:
        if (e["algo"], e["variant"]) != (algo, variant):
            continue
        res = evaluate(CTX[e["calibration"]], algo, variant,
                       e["n"], e["p"], c=e["c"], r=e["r"])
        for field in ("total", "comm", "comp"):
            assert getattr(res, field) == pytest.approx(e[field], rel=1e-9)
        for name, want in e["terms"].items():
            assert res.terms[name] == pytest.approx(want, rel=1e-9,
                                                    abs=1e-300)


@pytest.mark.parametrize("name", sorted(REF_MACHINES))
def test_machine_from_dict_round_trips_reference_profiles(name):
    ref = REF_MACHINES[name]
    d = json.loads(json.dumps(dataclasses.asdict(ref)))
    got = Machine.from_dict(d)
    assert got.fingerprint() == ref.fingerprint()
    assert got == Machine.from_dict(dataclasses.asdict(got))


def test_refitted_profile_carries_across(tmp_path):
    """A telemetry-refitted revision of a reference profile, rebuilt in the
    port, keys and chooses the same plan."""
    refit = dataclasses.replace(REF_CPU_HOST, revision=3,
                                peak_flops_per_unit=7.5e9)
    ref_reg, port_reg = ref_registry(), build_default_registry()
    surface = ref_reg.machine(refit.name)
    ref_reg.register_machine(refit, surface.efficiency, overwrite=True)
    port_surface = port_reg.machine(refit.name)
    port_reg.register_machine(
        Machine.from_dict(json.loads(json.dumps(dataclasses.asdict(refit)))),
        port_surface.efficiency, overwrite=True)
    ref, port = _tuners(tmp_path, ref_reg, port_reg)
    want = ref.plan("cholesky", 4096, device_count=8, platform="cpu")
    got = port.plan("cholesky", 4096, device_count=8, platform="cpu")
    assert got.to_dict() == want.to_dict()


def test_reference_plan_cache_is_served_to_the_port(tmp_path):
    ref = RefTuner(cache=RefPlanCache(str(tmp_path)))
    ref.plan("trsm", 96, device_count=4, platform="cpu")
    port = Tuner(cache=PlanCache(str(tmp_path)))
    port.plan("trsm", 96, devices=[CPU] * 4)
    assert port.stats == {"model_evals": 0, "cache_hits": 1}


@pytest.mark.parametrize("local_kernel", ["jnp", "pallas"])
@pytest.mark.parametrize("op", ["matmul", "trsm", "cholesky"])
def test_reference_frozen_plan_executes_in_port(op, local_kernel, tmp_path):
    n, p = 96, 8
    frozen = RefTuner(cache=RefPlanCache(str(tmp_path))).plan(
        op, n, device_count=p, platform="cpu", local_kernel=local_kernel)
    plan = ExecutionPlan.from_dict(json.loads(json.dumps(frozen.to_dict())))
    assert plan.local_kernel == local_kernel
    rng = np.random.default_rng(11)
    a = rng.standard_normal((n, n))
    b = rng.standard_normal((n, n))
    if op == "matmul":
        args, want = (a, b), a @ b
    elif op == "trsm":
        u = np.triu(a) + 3 * np.eye(n)
        args, want = (u, b), b @ np.linalg.inv(u)
    else:
        s = a @ a.T + n * np.eye(n)
        args, want = (s,), np.linalg.cholesky(s)
    got = dispatch.execute(plan, *(torch.tensor(x, dtype=torch.float32)
                                   for x in args), devices=[CPU] * p)
    assert np.abs(got.numpy() - want).max() / np.abs(want).max() < 1e-4


def test_h100_profile_is_the_cuda_machine(tmp_path):
    assert machine_for_platform("cuda") == H100_SXM.name == "h100-sxm"
    assert H100_SXM.kernel_constants is None
    assert "spec-sheet" in H100_SXM.notes
    plan = Tuner(cache=PlanCache(str(tmp_path))).plan(
        "cholesky", 16384, device_count=1, platform="cuda",
        device_kind="NVIDIA H100 80GB HBM3")
    assert plan.machine == "h100-sxm"
    assert plan.local_kernel == "pallas"
    # no kernel constants: the heuristic tiles, block 256
    assert plan.tiles["cholesky"] == {"block": 256}
    assert plan.tiles["trsm"] == {"block": 256}


def test_torch_devices_key_like_the_reference(tmp_path):
    ref, port = _tuners(tmp_path)
    want = ref.plan("matmul", 96, device_count=4, platform="cpu")
    got = port.plan("matmul", 96, devices=[CPU] * 4)
    assert got.fingerprint == want.fingerprint
    assert got.local_kernel == "jnp"
    assert dispatch._dtype_key(torch.zeros(1)) == "float32"


@pytest.mark.parametrize("p", [4, 8, 9])
@pytest.mark.parametrize("op", ["matmul", "trsm", "cholesky"])
def test_refine_sim_plans_like_the_reference(op, p, tmp_path):
    """The sim-refined stage: the same re-ranked plan, simulated totals
    and cache key as the reference's."""
    ref, port = _tuners(tmp_path)
    want = ref.plan(op, 4096, device_count=p, platform="cpu", refine="sim")
    got = port.plan(op, 4096, device_count=p, platform="cpu", refine="sim")
    assert got.to_dict() == want.to_dict()
    assert "sim_total" in got.predicted
    assert port.stats == ref.stats
    assert port.stats["sim_evals"] > 0


@pytest.mark.parametrize("p", [1, 4, 8])
@pytest.mark.parametrize("op", ["matmul", "trsm", "cholesky"])
def test_h100_crossbar_keeps_the_closed_form_plans(op, p, tmp_path):
    """H100_SXM's torus_dims is 0 (NVSwitch: a crossbar to the simulator).
    Closed-form planning never reads the field, so plans keep the
    algo/variant/grid they had with torus_dims = 1; only the fingerprint
    moves."""
    ring = dataclasses.replace(H100_SXM, torus_dims=1)
    reg = build_default_registry()
    surface = reg.machine(H100_SXM.name)
    reg.register_machine(ring, surface.efficiency, overwrite=True)
    kw = dict(device_count=p, platform="cuda",
              device_kind="NVIDIA H100 80GB HBM3")
    for n in (4096, 16384):
        got = Tuner(cache=PlanCache(str(tmp_path / "crossbar"))).plan(
            op, n, **kw)
        was = Tuner(registry=reg, cache=PlanCache(str(tmp_path / "ring"))
                    ).plan(op, n, **kw)
        assert (got.algo, got.variant, got.p, got.c, got.g, got.tiles) == (
            was.algo, was.variant, was.p, was.c, was.g, was.tiles)
        assert got.predicted == was.predicted
        assert got.fingerprint != was.fingerprint


def test_plan_observe_records_the_plan(tmp_path):
    """observe=True on Tuner.plan records the planning decision (a record
    with no phases) into the tuner's store, as the reference does."""
    from repro_torch.telemetry import RunStore
    store = RunStore(str(tmp_path / "runs"))
    tuner = Tuner(cache=PlanCache(str(tmp_path)), store=store)
    plan = tuner.plan("matmul", 96, device_count=4, platform="cpu",
                      observe=True)
    [rec] = store.load()
    assert (rec.kind, rec.op, rec.variant, rec.n, rec.p, rec.c) == (
        "plan", plan.algo, plan.variant, 96, plan.p, plan.c)
    assert rec.phases == {} and rec.predicted == plan.predicted
    assert tuner.stats["observed"] == 1


def test_lm_helpers_raise(tmp_path):
    """``serve_chunk`` no longer raises: it sizes a prefill chunk to a step
    budget as the reference's does (both packages' serving cost models of
    reduced qwen1.5-4b on the CPU host profile), and both packages'
    ``prefill_chunk`` agree."""
    from repro.configs import get as ref_get
    from repro.core.machine import CPU_HOST as REF_CPU_HOST
    from repro.serving import ServeCostModel as RefCost
    from repro_torch.configs import get
    from repro_torch.core.machine import CPU_HOST
    from repro_torch.serving import ServeCostModel
    ref, port = _tuners(tmp_path)
    cm = ServeCostModel(get("qwen1.5-4b").reduced(), CPU_HOST)
    ref_cm = RefCost(ref_get("qwen1.5-4b").reduced(), REF_CPU_HOST)
    whole = cm.prefill_step([(512, 0)]).prefill_s
    for budget in (2 * whole, whole / 4, 0.0):
        got = port.serve_chunk(512, ctx0=0, cost=cm, budget_s=budget,
                               granularity=32)
        assert got == ref.serve_chunk(512, ctx0=0, cost=ref_cm,
                                      budget_s=budget, granularity=32)
        assert got % 32 == 0 and 0 <= got <= 512
    for s in (3, 8, 21, 4096):
        assert port.prefill_chunk(s) == ref.prefill_chunk(s)


@pytest.mark.parametrize("mesh", [{"data": 16, "model": 16}, {"data": 256}])
def test_recommend_fsdp_like_the_reference(mesh, tmp_path):
    from repro.configs import SHAPES as REF_SHAPES
    from repro.configs.registry import get as ref_get
    from repro_torch.configs import SHAPES
    from repro_torch.configs.registry import get
    ref, port = _tuners(tmp_path)
    for arch in ("qwen1.5-110b", "granite-20b", "arctic-480b"):
        want = ref.recommend_fsdp(ref_get(arch), REF_SHAPES["train_4k"], mesh)
        got = port.recommend_fsdp(get(arch), SHAPES["train_4k"], mesh)
        assert got is want
    assert port.stats == ref.stats


def test_execute_observe_emits_a_record(tmp_path):
    """dispatch.execute(..., observe=True) runs the plan and emits one
    dispatch record with its distribute and execute phases."""
    from repro_torch.telemetry import RunStore
    store = RunStore(str(tmp_path / "runs"))
    tuner = Tuner(cache=PlanCache(str(tmp_path)))
    plan = tuner.plan("matmul", 96, devices=[CPU])
    out = dispatch.execute(plan, torch.eye(96), torch.eye(96), devices=[CPU],
                           observe=True, store=store)
    assert torch.equal(out, torch.eye(96))
    [rec] = store.load()
    assert rec.kind == "dispatch" and rec.fingerprint == plan.fingerprint
    assert sorted(rec.phases) == ["distribute", "execute"]
