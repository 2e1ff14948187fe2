"""The port's per-rank network simulator against the reference.

Both packages replay the same cost-IR programs on the same topologies from
the same inputs; totals, per-phase clocks, the critical rank and the link
ledgers must agree to 1e-12 relative (the simulator is the same numpy
arithmetic in both, so they agree to round-off).  The sim-refined tuner,
the LM-step model and ``recommend_fsdp`` are held to the reference the
same way.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

import repro.core.calibration as ref_calibration
from repro import sim as ref_sim
from repro.core import lm_model as ref_lm
from repro.configs import SHAPES as REF_SHAPES
from repro.configs.registry import ARCHS as REF_ARCHS
from repro.perf import PROGRAMS as REF_PROGRAMS
from repro.tuner import DEFAULT_REGISTRY as REF_REGISTRY
from repro.tuner import PlanCache as RefPlanCache
from repro.tuner import Tuner as RefTuner
import repro_torch.core.calibration as calibration
from repro_torch import sim
from repro_torch.configs import SHAPES
from repro_torch.configs.registry import ARCHS
from repro_torch.core import lm_model
from repro_torch.core.machine import H100_SXM
from repro_torch.perf import PROGRAMS, EvalOptions, evaluate_program
from repro_torch.tuner import DEFAULT_REGISTRY, PlanCache, Tuner

REL = 1e-12
# the vector engine folds symmetric ranks and sums in another order than
# the per-transfer loop; 1e-6 is the gate the reference holds them to
ENGINE_REL = 1e-6
MACHINE = "hopper-cray-xe6"
PROGRAM_KEYS = sorted(PROGRAMS)
TOPOLOGIES = {"crossbar16": lambda mod: mod.Crossbar(16),
              "torus4x4": lambda mod: mod.Torus((4, 4))}


def _ctxs():
    return DEFAULT_REGISTRY.context(MACHINE), REF_REGISTRY.context(MACHINE)


def _scenario(program, n):
    return dict(n=float(n), p=16, c=2 if program.uses_c else 1,
                r=2 if program.uses_r else 1)


def _close(got, want, rel=REL):
    np.testing.assert_allclose(np.asarray(got, dtype=float),
                               np.asarray(want, dtype=float), rtol=rel,
                               atol=0)


def assert_same_sim(got, want, rel=REL):
    """Every number a SimResult carries, held to ``want``."""
    assert (got.algo, got.variant, got.p, got.events, got.engine) == (
        want.algo, want.variant, want.p, want.events, want.engine)
    assert got.total == pytest.approx(want.total, rel=rel, abs=0)
    _close(got.per_rank, want.per_rank, rel)
    _close(got.comm, want.comm, rel)
    _close(got.comp, want.comp, rel)
    assert list(got.phases) == list(want.phases)
    for name, ph in got.phases.items():
        w = want.phases[name]
        for field in ("start", "exposed", "comm", "comp"):
            _close(getattr(ph, field), getattr(w, field), rel)
    assert got.critical_rank == want.critical_rank
    assert got.overlap_efficiency == pytest.approx(want.overlap_efficiency,
                                                   rel=rel, abs=0)
    for ledger in ("words", "busy", "peak_load"):
        g = getattr(got.link_stats, ledger)
        w = getattr(want.link_stats, ledger)
        assert sorted(g) == sorted(w)
        _close([g[k] for k in sorted(g)], [w[k] for k in sorted(w)], rel)
    hg, hw = got.utilization_histogram(), want.utilization_histogram()
    assert hg["counts"] == hw["counts"]
    _close(hg["edges"], hw["edges"], rel)


# -- topology --------------------------------------------------------------

def test_h100_routes_on_a_crossbar():
    """The H100 profile is all to all (NVSwitch): the simulator gives it
    the contention-free crossbar, one hop between any two cards."""
    assert H100_SXM.torus_dims == 0
    topo = sim.topology_for(H100_SXM, 8)
    assert isinstance(topo, sim.Crossbar) and topo.n_nodes == 8
    assert all(topo.hops(i, j) == 1 for i in range(8) for j in range(8)
               if i != j)
    assert sim.topology_for(H100_SXM, 8) is topo       # memoized


@pytest.mark.parametrize("shape,p,d", [((4, 4), 16, 1), ((4, 4), 16, 5),
                                       ((4, 4, 4), 64, 3),
                                       ((16, 16), 256, 17)])
def test_shift_plans_equal_the_reference(shape, p, d):
    got = sim.Torus(shape).shift_plan(p, d)
    want = ref_sim.Torus(shape).shift_plan(p, d)
    for field in ("indptr", "links", "uniq_links", "link_idx", "owner",
                  "static_load"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))
    assert got.max_static_load == want.max_static_load


@pytest.mark.parametrize("machine,p", [(MACHINE, 64), (MACHINE, 100),
                                       ("tpu-v5e", 256), ("cpu-host", 16)])
def test_topology_for_equals_the_reference(machine, p):
    got = sim.topology_for(DEFAULT_REGISTRY.machine(machine).machine, p)
    want = ref_sim.topology_for(REF_REGISTRY.machine(machine).machine, p)
    assert repr(got) == repr(want)


# -- programs --------------------------------------------------------------

@pytest.mark.parametrize("topo", sorted(TOPOLOGIES))
@pytest.mark.parametrize("algo,variant", PROGRAM_KEYS)
def test_program_simulation_equals_the_reference(algo, variant, topo):
    ctx, ref_ctx = _ctxs()
    for n in (4096, 16384):
        scen = _scenario(PROGRAMS[(algo, variant)], n)
        got = sim.simulate_program(PROGRAMS[(algo, variant)], ctx,
                                   TOPOLOGIES[topo](sim), **scen)
        want = ref_sim.simulate_program(REF_PROGRAMS[(algo, variant)],
                                        ref_ctx, TOPOLOGIES[topo](ref_sim),
                                        **scen)
        assert_same_sim(got, want)


@pytest.mark.parametrize("algo,variant", PROGRAM_KEYS)
def test_crossbar_makespan_is_est_nocal(algo, variant):
    """On the contention-free crossbar every transfer takes its ideal
    alpha-beta time: the makespan is the closed-form est_NoCal total to
    round-off (measured 9.2e-15 at worst), with all ranks in lockstep."""
    ctx, _ = _ctxs()
    program = PROGRAMS[(algo, variant)]
    for n in (4096, 16384):
        scen = _scenario(program, n)
        est = float(evaluate_program(
            program, ctx, scen["n"], scen["p"], scen["c"], scen["r"],
            options=EvalOptions(mode="nocal")).total)
        res = sim.simulate_program(program, ctx, sim.Crossbar(16), **scen)
        assert res.total == pytest.approx(est, rel=REL)
        assert np.ptp(res.per_rank) <= 1e-9 * res.total


@pytest.mark.parametrize("algo,variant", PROGRAM_KEYS)
def test_vector_engine_agrees_with_the_per_transfer_engine(algo, variant):
    ctx, _ = _ctxs()
    scen = _scenario(PROGRAMS[(algo, variant)], 8192)
    topo = sim.Torus((4, 4))
    vec = sim.simulate_program(PROGRAMS[(algo, variant)], ctx, topo, **scen)
    ref = sim.simulate_program(PROGRAMS[(algo, variant)], ctx, topo,
                               engine="reference", **scen)
    assert ref.engine == "reference"
    assert vec.total == pytest.approx(ref.total, rel=ENGINE_REL)
    _close(vec.per_rank, ref.per_rank, ENGINE_REL)


def test_batch_equals_the_reference():
    ctx, ref_ctx = _ctxs()
    keys = [("summa", "2d"), ("cannon", "2.5d_ovlp"), ("trsm", "2d_ovlp"),
            ("cholesky", "2.5d")]
    scens = [{"n": 8192.0, "p": 64, "c": 4 if "2.5d" in v else 1}
             for _, v in keys]
    machine = DEFAULT_REGISTRY.machine(MACHINE).machine
    got = sim.simulate_programs([PROGRAMS[k] for k in keys], ctx, scens,
                                machine=machine)
    want = ref_sim.simulate_programs(
        [REF_PROGRAMS[k] for k in keys], ref_ctx, scens,
        machine=REF_REGISTRY.machine(MACHINE).machine)
    for g, w in zip(got, want):
        assert_same_sim(g, w)


def test_chrome_trace_equals_the_reference(tmp_path, monkeypatch):
    """The port's trace lands under REPRO_TORCH_ARTIFACTS/traces_torch,
    the reference's under its own root, and they hold the same events."""
    monkeypatch.setenv("REPRO_TORCH_ARTIFACTS", str(tmp_path / "port"))
    monkeypatch.setattr(ref_calibration, "ARTIFACTS_DIR",
                        str(tmp_path / "ref"))
    ctx, ref_ctx = _ctxs()
    args = (4096.0, 16)
    got = sim.simulate_program(PROGRAMS[("cannon", "2d")], ctx,
                               sim.Torus((4, 4)), *args)
    want = ref_sim.simulate_program(REF_PROGRAMS[("cannon", "2d")], ref_ctx,
                                    ref_sim.Torus((4, 4)), *args)
    assert sim.traces_dir() == os.path.join(str(tmp_path), "port",
                                            "traces_torch")
    path = got.dump_chrome_trace()
    assert os.path.dirname(path) == sim.traces_dir()
    ref_path = want.dump_chrome_trace()
    assert os.path.dirname(ref_path) == os.path.join(str(tmp_path), "ref",
                                                     "traces")
    with open(path) as f:
        trace = json.load(f)
    assert trace == json.loads(json.dumps(want.chrome_trace()))
    assert {e["tid"] for e in trace["traceEvents"]
            if e.get("ph") == "X"} == set(range(16))


# -- calibration surfaces --------------------------------------------------

@pytest.mark.parametrize("mode", ["static", "des"])
def test_derive_calibration_equals_the_reference(mode):
    kw = dict(ps=[16, 64, 256], distances=[1, 2, 4, 8], mode=mode)
    got = sim.derive_calibration(sim.v5e_pod_topology(), **kw)
    want = ref_sim.derive_calibration(ref_sim.v5e_pod_topology(), **kw)
    assert got.avg == want.avg and got.mx == want.mx
    assert got.to_json() == want.to_json()


@pytest.mark.parametrize("mode", ["static", "des"])
@pytest.mark.parametrize("d", [1, 5, 16])
def test_shift_factors_on_the_hopper_torus(mode, d):
    got = sim.shift_factors(sim.hopper_like_topology(), 512, d, mode=mode)
    want = ref_sim.shift_factors(ref_sim.hopper_like_topology(), 512, d,
                                 mode=mode)
    assert got == want


# -- faults ----------------------------------------------------------------

def _fault_specs(mod, topo):
    link = mod.torus_link(topo, 8, 2, +1)
    return {
        "slow_rank": mod.FaultSpec(slow_ranks=(mod.SlowRank(11, 2.5),)),
        "degraded_link": mod.FaultSpec(
            degraded_links=(mod.DegradedLink(link, 6.0),)),
        "dead_link": mod.FaultSpec(
            dead_links=(mod.DeadLink(mod.torus_link(topo, 5, 0, +1)),)),
        "late_onset": mod.FaultSpec(degraded_links=(
            mod.DegradedLink(link, 6.0, onset_s=1e-3),)),
    }


@pytest.mark.parametrize("fault", ["slow_rank", "degraded_link", "dead_link",
                                   "late_onset"])
def test_faulted_simulation_equals_the_reference(fault):
    ctx, ref_ctx = _ctxs()
    topo, ref_topo = sim.Torus((4, 4, 4)), ref_sim.Torus((4, 4, 4))
    fs = _fault_specs(sim, topo)[fault]
    ref_fs = _fault_specs(ref_sim, ref_topo)[fault]
    assert fs.fingerprint() == ref_fs.fingerprint()
    for key in (("lu", "2d"), ("cannon", "2d")):
        kw = dict(n=4096.0, p=64, c=1)
        got = sim.simulate_program(PROGRAMS[key], ctx, topo, faults=fs, **kw)
        want = ref_sim.simulate_program(REF_PROGRAMS[key], ref_ctx, ref_topo,
                                        faults=ref_fs, **kw)
        assert_same_sim(got, want)
        oracle = sim.simulate_program(PROGRAMS[key], ctx, topo, faults=fs,
                                      engine="reference", **kw)
        assert got.total == pytest.approx(oracle.total, rel=ENGINE_REL)


@pytest.mark.parametrize("fault", ["degraded_link", "dead_link"])
def test_faulted_deliver_equals_the_reference(fault):
    """Network.deliver on an asymmetric transfer list and deliver_shift,
    with a degraded link or a dead link the torus routes around."""
    rng = np.random.default_rng(7)
    src = rng.integers(0, 64, 40)
    dst = rng.integers(0, 64, 40)
    words = rng.uniform(1e3, 1e6, 40)
    starts = rng.uniform(0.0, 1e-4, 40)
    out = []
    for mod in (sim, ref_sim):
        topo = mod.Torus((4, 4, 4))
        net = mod.Network(topo, 1e-6, 1e-9,
                          faults=_fault_specs(mod, topo)[fault])
        done = net.deliver([mod.Transfer(int(s), int(d), float(w), float(t))
                            for s, d, w, t in zip(src, dst, words, starts)])
        shift = net.deliver_shift(np.linspace(0.0, 1e-5, 64), 5e5, 3, 1e-6)
        out.append((done, shift, net.events))
    (done, shift, events), (ref_done, ref_shift, ref_events) = out
    _close(done, ref_done)
    _close(shift, ref_shift)
    assert events == ref_events


def test_dead_crossbar_channel_is_unreachable_in_both():
    for mod in (sim, ref_sim):
        xb = mod.Crossbar(4)
        ft = mod.FaultyTopology(xb, frozenset([xb.route(0, 1)[0]]))
        with pytest.raises(mod.UnreachableError):
            ft.route(0, 1)


# -- the sim-refined tuner -------------------------------------------------

def _plan_dicts_match(got, want):
    g, w = got.to_dict(), want.to_dict()
    gp, wp = g.pop("predicted"), w.pop("predicted")
    assert g == w
    assert sorted(gp) == sorted(wp)
    for k, v in wp.items():
        assert gp[k] == pytest.approx(v, rel=REL, abs=0), k


@pytest.mark.parametrize("machine,count", [(MACHINE, 64), (MACHINE, 256),
                                           ("tpu-v5e", 256)])
@pytest.mark.parametrize("op", ["matmul", "trsm", "cholesky"])
def test_refined_plan_equals_the_reference(op, machine, count, tmp_path):
    ref = RefTuner(cache=RefPlanCache(str(tmp_path / "ref")))
    port = Tuner(cache=PlanCache(str(tmp_path / "port")))
    kw = dict(device_count=count, platform="cpu", machine=machine,
              refine="sim")
    want = ref.plan(op, 8192, **kw)
    got = port.plan(op, 8192, **kw)
    _plan_dicts_match(got, want)
    assert "sim_total" in got.predicted
    assert port.stats["sim_evals"] == ref.stats["sim_evals"] > 0


def test_refined_plan_caches_under_its_own_key(tmp_path):
    t = Tuner(cache=PlanCache(str(tmp_path)))
    kw = dict(device_count=16, platform="cpu", machine="tpu-v5e")
    plan = t.plan("matmul", 4096, refine="sim", **kw)
    assert "sim_total" not in t.plan("matmul", 4096, **kw).predicted
    hits = t.stats["cache_hits"]
    assert t.plan("matmul", 4096, refine="sim", **kw).predicted == \
        plan.predicted
    assert t.stats["cache_hits"] == hits + 1
    t.cache.clear_memory()
    disk = t.plan("matmul", 4096, refine="sim", **kw)
    assert disk.predicted["sim_total"] == plan.predicted["sim_total"]


def test_refined_plan_on_a_reference_cache(tmp_path):
    """A refined plan the reference froze is served to the port."""
    RefTuner(cache=RefPlanCache(str(tmp_path))).plan(
        "trsm", 4096, device_count=64, platform="cpu", machine=MACHINE,
        refine="sim")
    port = Tuner(cache=PlanCache(str(tmp_path)))
    port.plan("trsm", 4096, device_count=64, platform="cpu",
              machine=MACHINE, refine="sim")
    assert port.stats == {"model_evals": 0, "cache_hits": 1}


def _all_links_dead(sim_mod, reg):
    """``reg``'s MACHINE surface re-registered with every link of its
    4-device topology dead, both ways: no candidate can be simulated."""
    surface = reg.machine(MACHINE)
    topo = sim_mod.topology_for(surface.machine, 4)
    assert isinstance(topo, sim_mod.Torus)
    dead = sim_mod.FaultSpec(dead_links=tuple(
        sim_mod.DeadLink(link)
        for link in range(topo.n_nodes * topo.ndim * 2)))
    reg.register_machine(surface.machine, surface.efficiency,
                         surface.calibration, overwrite=True, faults=dead)
    return reg


@pytest.mark.parametrize("op", ["matmul", "trsm", "cholesky"])
def test_refine_without_a_simulable_candidate_falls_back_as_the_reference(
        op, tmp_path):
    """When every shortlisted candidate is unreachable under the surface's
    dead links, both packages keep the closed-form argmin, with no
    sim_total, and count the same simulator evaluations."""
    from repro.tuner import build_default_registry as ref_registry
    from repro_torch.tuner import build_default_registry
    ref = RefTuner(registry=_all_links_dead(ref_sim, ref_registry()),
                   cache=RefPlanCache(str(tmp_path / "ref")))
    port = Tuner(registry=_all_links_dead(sim, build_default_registry()),
                 cache=PlanCache(str(tmp_path / "port")))
    kw = dict(device_count=4, platform="cpu", machine=MACHINE)
    want = ref.plan(op, 4096, **kw)
    got = port.plan(op, 4096, **kw)
    assert (got.algo, got.variant, got.g, got.c) == (
        want.algo, want.variant, want.g, want.c)
    if op == "matmul":
        assert (got.algo, got.variant, got.g, got.c) == ("cannon", "2d_ovlp",
                                                         2, 1)
    assert "sim_total" not in got.predicted
    assert "sim_total" not in want.predicted
    assert port.stats["sim_evals"] == ref.stats["sim_evals"] > 0
    _plan_dicts_match(got, want)


# -- the LM-step model -----------------------------------------------------

@pytest.fixture(scope="module")
def lm_tables():
    kw = dict(ps=[16, 64, 256], distances=[1, 2, 4, 8])
    return (sim.derive_calibration(sim.v5e_pod_topology(), **kw),
            ref_sim.derive_calibration(ref_sim.v5e_pod_topology(), **kw))


MESHES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
          {"data": 64, "model": 4}, {"data": 8}]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_train_step_estimate_equals_the_reference(arch, lm_tables):
    assert sorted(ARCHS) == sorted(REF_ARCHS)
    cal, ref_cal = lm_tables
    for mesh in MESHES:
        for fsdp in (False, True):
            for int8 in (False, True):
                got = lm_model.predict_train_step(
                    ARCHS[arch], SHAPES["train_4k"], mesh, calibration=cal,
                    fsdp=fsdp, int8_pod_reduce=int8).to_dict()
                want = ref_lm.predict_train_step(
                    REF_ARCHS[arch], REF_SHAPES["train_4k"], mesh,
                    calibration=ref_cal, fsdp=fsdp,
                    int8_pod_reduce=int8).to_dict()
                assert sorted(got) == sorted(want)
                for k, v in want.items():
                    assert got[k] == pytest.approx(v, rel=REL, abs=0), k


def test_default_calibration_and_tradeoff_table_equal_the_reference():
    cfg, ref_cfg = ARCHS["qwen1.5-110b"], REF_ARCHS["qwen1.5-110b"]
    got = lm_model.predict_train_step(cfg, SHAPES["train_4k"],
                                      {"data": 16, "model": 16}, fsdp=True)
    want = ref_lm.predict_train_step(ref_cfg, REF_SHAPES["train_4k"],
                                     {"data": 16, "model": 16}, fsdp=True)
    assert dataclasses.asdict(got) == pytest.approx(
        dataclasses.asdict(want), rel=REL)
    tbl = lm_model.sharding_tradeoff_table(cfg, SHAPES["train_4k"], chips=64)
    ref_tbl = ref_lm.sharding_tradeoff_table(ref_cfg, REF_SHAPES["train_4k"],
                                             chips=64)
    assert sorted(tbl) == sorted(ref_tbl)
    for k, row in ref_tbl.items():
        assert tbl[k] == pytest.approx(row, rel=REL)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_recommend_fsdp_equals_the_reference(arch, tmp_path):
    ref = RefTuner(cache=RefPlanCache(str(tmp_path / "ref")))
    port = Tuner(cache=PlanCache(str(tmp_path / "port")))
    for mesh in MESHES[:3]:
        want = ref.recommend_fsdp(REF_ARCHS[arch], REF_SHAPES["train_4k"],
                                  mesh)
        got = port.recommend_fsdp(ARCHS[arch], SHAPES["train_4k"], mesh)
        assert isinstance(got, bool) and got == want
    assert port.recommend_fsdp(ARCHS[arch], SHAPES["train_4k"],
                               MESHES[0], required=True) is True
    # the decision and both predictions are cached under the same keys
    for mesh in MESHES[:3]:
        port.recommend_fsdp(ARCHS[arch], SHAPES["train_4k"], mesh)
    assert port.stats["cache_hits"] == 3
    assert port.stats["model_evals"] == ref.stats["model_evals"] == 3
