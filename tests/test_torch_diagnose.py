"""The port's fault diagnosis against the reference.

A faulted ``sim.Network`` stands in for the measured channel in both
packages; the probes, the verdicts, the degraded profile and the re-plan
on it must agree.  Durations and severities are compared to 1e-12
relative, verdicts and plans exactly.
"""

import dataclasses
import tempfile

import numpy as np
import pytest

from repro import sim as ref_sim
from repro import telemetry as ref_tel
from repro.tuner import PlanCache as RefPlanCache
from repro.tuner import Tuner as RefTuner
from repro.core.machine import Machine as RefMachine
from repro.core.perfmodel import HOPPER_EFFICIENCY as REF_HOPPER_EFFICIENCY
from repro.tuner.registry import build_default_registry
from repro_torch import sim
from repro_torch import telemetry as tel
from repro_torch.core.machine import H100_SXM
from repro_torch.tuner import PlanCache, Tuner
from repro_torch.tuner import build_default_registry as port_registry

REL = 1e-12
HOPPER = "hopper-cray-xe6"
# the H100's NVLink latency (5 us) dwarfs a 4096-word transfer (36 ns), so
# its probe sends 2^24 words (64 MiB of fp32), which the bandwidth governs
H100_WORDS = float(2 ** 24)


def ref_registry():
    """The reference's registry with the port's h100-sxm profile added as
    the port registers it (the Hopper efficiency shapes), so both
    packages diagnose the same machine."""
    reg = build_default_registry()
    reg.register_machine(RefMachine(**dataclasses.asdict(H100_SXM)),
                         REF_HOPPER_EFFICIENCY)
    return reg


def _machine(mod_registry, name):
    return mod_registry().machine(name).machine


def _measured(mod, machine, p, link_of, scale=8.0):
    topo = mod.topology_for(machine, p)
    link = link_of(mod, topo)
    fs = mod.FaultSpec(degraded_links=(mod.DegradedLink(link, scale),))
    return mod.Network(topo, machine.latency, machine.inv_bandwidth,
                       faults=fs), link


def _torus_link(mod, topo):
    return mod.torus_link(topo, 8, 2, +1)


def _crossbar_link(mod, topo):
    return topo.route(0, 1)[0]


CASES = {
    # (machine, p, link, probe words)
    "hopper-torus": (HOPPER, 64, _torus_link, 4096.0),
    "h100-crossbar": ("h100-sxm", 8, _crossbar_link, H100_WORDS),
}


def _same_diagnosis(got, want):
    assert (got.kind, got.component, got.component_name) == (
        want.kind, want.component, want.component_name)
    assert got.severity == pytest.approx(want.severity, rel=REL, abs=0)
    assert got.to_dict() == pytest.approx(want.to_dict(), rel=REL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_probe_links_equals_the_reference(case):
    name, p, link_of, words = CASES[case]
    net, link = _measured(sim, _machine(port_registry, name), p,
                          link_of)
    ref_net, ref_link = _measured(ref_sim, _machine(ref_registry, name), p,
                                  link_of)
    assert link == ref_link
    got = tel.probe_links(net, words=words)
    want = ref_tel.probe_links(ref_net, words=words)
    _same_diagnosis(got, want)
    assert got.kind == "degraded_link" and got.component == link
    assert 2.0 < got.severity <= 8.0
    for d in tel.default_probe_distances(net.topology, p):
        np.testing.assert_allclose(
            tel.probe_shift_durations(net, p, d, words=words),
            ref_tel.probe_shift_durations(ref_net, p, d, words=words),
            rtol=REL, atol=0)


def test_default_probe_distances_equal_the_reference():
    for shape in ((16, 16), (4, 4, 4), (8,), (2, 2)):
        p = int(np.prod(shape))
        assert tel.default_probe_distances(sim.Torus(shape), p) == \
            ref_tel.default_probe_distances(ref_sim.Torus(shape), p)
    assert tel.default_probe_distances(sim.Crossbar(8), 8) == (1, 2, 3)


@pytest.mark.parametrize("case", sorted(CASES))
def test_healthy_channel_stays_healthy(case):
    name, p, _, words = CASES[case]
    m = _machine(port_registry, name)
    net = sim.Network(sim.topology_for(m, p), m.latency, m.inv_bandwidth)
    assert tel.probe_links(net, words=words).healthy


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_localize_link_from_probe_arrays_equals_the_reference(seed):
    """localize_link on measured arrays drawn from a numpy seed: a few
    ranks of each probe run late by 1.1x to 6x."""
    rng = np.random.default_rng(seed)
    p, dists = 64, (1, 4, 16)
    base = {d: rng.uniform(1e-5, 2e-5, p) for d in dists}
    meas = {}
    for d in dists:
        ratio = np.ones(p)
        late = rng.choice(p, 5, replace=False)
        ratio[late] = rng.uniform(1.1, 6.0, 5)
        meas[d] = base[d] * ratio
    got = tel.localize_link(sim.Torus((4, 4, 4)), p, measure=meas.get,
                            baseline=base.get, distances=dists)
    want = ref_tel.localize_link(ref_sim.Torus((4, 4, 4)), p,
                                 measure=meas.get, baseline=base.get,
                                 distances=dists)
    _same_diagnosis(got, want)
    assert got.evidence == want.evidence


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_localize_rank_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    times = rng.uniform(0.9, 1.1, 16)
    times[int(rng.integers(16))] *= float(rng.choice([1.5, 2.5, 4.0]))
    got, want = tel.localize_rank(times), ref_tel.localize_rank(times)
    _same_diagnosis(got, want)
    assert got.evidence == pytest.approx(want.evidence, rel=REL)
    assert got.to_fault_spec().to_dict() == want.to_fault_spec().to_dict()


def mod_tel(mod):
    return tel if mod is sim else ref_tel


def _responder_loop(mod, registry, name, p, link_of, words):
    """Two firings of one episode and one after the revision moved on:
    the responder diagnoses once per revision."""
    net, _ = _measured(mod, registry.machine(name).machine, p, link_of)
    fired = []
    resp = mod_tel(mod).DiagnosisResponder(
        registry, name,
        lambda firing: fired.append(firing)
        or mod_tel(mod).probe_links(net, words=words),
        series_filter=lambda firing: firing != "ignored")
    verdicts = [resp("drift"), resp("drift"), resp("ignored")]
    return resp, verdicts, fired


@pytest.mark.parametrize("case", sorted(CASES))
def test_diagnosis_responder_equals_the_reference(case):
    name, p, link_of, words = CASES[case]
    reg, ref_reg = port_registry(), ref_registry()
    rev0 = reg.machine(name).machine.revision
    got = _responder_loop(sim, reg, name, p, link_of, words)
    want = _responder_loop(ref_sim, ref_reg, name, p, link_of, words)
    (resp, verdicts, fired), (ref_resp, ref_verdicts, ref_fired) = got, want
    assert fired == ref_fired == ["drift"]          # latched after one
    assert [v is None for v in verdicts] == \
        [v is None for v in ref_verdicts] == [False, True, True]
    _same_diagnosis(verdicts[0], ref_verdicts[0])
    assert [r["revision"] for r in resp.responses] == \
        [r["revision"] for r in ref_resp.responses] == [rev0 + 1]
    surface, ref_surface = reg.machine(name), ref_reg.machine(name)
    assert surface.machine.revision == rev0 + 1
    assert surface.faults.to_dict() == ref_surface.faults.to_dict()
    assert dataclasses.asdict(surface.machine) == \
        dataclasses.asdict(ref_surface.machine)
    assert surface.machine.fingerprint() == ref_surface.machine.fingerprint()


def _replan(mod, registry_fn, tuner_cls, cache_cls):
    """tests/test_faults.py's loop: probe -> degraded revision -> the tuner
    re-plans sim-refined on its own and routes around the link -> the new
    plan beats the stale one under the fault."""
    reg = registry_fn()
    surf = reg.machine(HOPPER)
    net, link = _measured(mod, surf.machine, 64, _torus_link)
    diag = mod_tel(mod).probe_links(net)
    with tempfile.TemporaryDirectory() as td:
        tuner = tuner_cls(registry=reg, cache=cache_cls(td))
        kw = dict(device_count=64, platform="cpu", machine=HOPPER)
        healthy = tuner.plan("matmul", 8192, refine="sim", **kw)
        mod_tel(mod).emit_degraded_profile(reg, HOPPER, diag.to_fault_spec(),
                                           diagnosis=diag)
        degraded = tuner.plan("matmul", 8192, **kw)
        surf2 = reg.machine(HOPPER)
        totals = {}
        for tag, pl in (("stale", healthy), ("replan", degraded)):
            totals[tag] = mod.simulate_programs(
                reg.program(pl.algo, pl.variant), surf2.context(),
                [{"n": 8192.0, "p": pl.p, "c": pl.c, "r": 1}],
                topology=mod.topology_for(surf2.machine, 64),
                faults=diag.to_fault_spec())[0].total
    return diag, link, healthy, degraded, totals


def test_degraded_profile_replan_equals_the_reference():
    got = _replan(sim, port_registry, Tuner, PlanCache)
    want = _replan(ref_sim, ref_registry, RefTuner, RefPlanCache)
    diag, link, healthy, degraded, totals = got
    _same_diagnosis(diag, want[0])
    assert diag.component == link == want[1]
    for g, w in ((healthy, want[2]), (degraded, want[3])):
        gd, wd = g.to_dict(), w.to_dict()
        gp, wp = gd.pop("predicted"), wd.pop("predicted")
        assert gd == wd
        assert gp == pytest.approx(wp, rel=REL)
    assert "sim_total" in degraded.predicted        # refined unasked
    assert (healthy.algo, healthy.variant, healthy.c) != (
        degraded.algo, degraded.variant, degraded.c)
    assert totals["replan"] < totals["stale"]
    assert totals == pytest.approx(want[4], rel=REL)


def test_h100_fault_forces_sim_refinement(tmp_path):
    """The degraded h100-sxm surface plans sim-refined without being asked,
    on the crossbar of the whole pool, at a new fingerprint."""
    reg = port_registry()
    net, link = _measured(sim, reg.machine("h100-sxm").machine, 8,
                          _crossbar_link)
    diag = tel.probe_links(net, words=H100_WORDS)
    tuner = Tuner(registry=reg, cache=PlanCache(str(tmp_path)))
    kw = dict(device_count=8, platform="cuda",
              device_kind="NVIDIA H100 80GB HBM3")
    healthy = {op: tuner.plan(op, 4096, **kw)
               for op in ("matmul", "trsm", "cholesky")}
    machine = tel.emit_degraded_profile(reg, "h100-sxm",
                                        diag.to_fault_spec(), diagnosis=diag)
    evals = tuner.stats.get("sim_evals", 0)
    for op, plan in healthy.items():
        assert "sim_total" not in plan.predicted
        degraded = tuner.plan(op, 4096, **kw)
        assert "sim_total" in degraded.predicted
        assert degraded.fingerprint != plan.fingerprint
        assert degraded.machine == "h100-sxm"
    assert tuner.stats["sim_evals"] > evals
    assert machine.revision == 1
    assert reg.machine("h100-sxm").faults.degraded_links[0].link == link
