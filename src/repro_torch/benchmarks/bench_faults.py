"""Chaos benchmark: the fault & degradation loop end to end (pure
numpy/CPU; no device needed).

Four measurements, emitted as ``artifacts/bench_torch/BENCH_faults.json``:

* agreement — the faulted vector engine (degraded link + slow rank +
  dead-link reroute on a 4x4x4 torus) against the per-transfer reference
  oracle; ``max_rel_err_vs_reference`` is a CI gate (<= 1e-6);
* detect -> diagnose -> re-plan — inject a degraded link, localize it by
  shift-pattern probes, emit the degraded machine revision and re-plan:
  the gates are exact localization and the re-planned candidate strictly
  beating the stale plan when both are simulated under the fault;
* serving overload — an overloaded bounded-queue replay with deadlines
  and graceful degradation: the gates are shed > 0 and deadline
  evictions counted;
* recovery planner — the model-guided continue/checkpoint/reschedule
  decision on a synthetic straggler sweep.
"""

import time


def main() -> dict:
    import tempfile

    from ..perf import PROGRAMS
    from ..sim import (DeadLink, DegradedLink, FaultSpec, Network,
                       SlowRank, Torus, simulate_program,
                       simulate_programs, topology_for, torus_link)
    from ..telemetry import emit_degraded_profile, probe_links
    from ..tuner import Tuner
    from ..tuner.registry import build_default_registry
    from ..training import RecoveryPlanner

    # --- agreement: faulted vector engine vs reference oracle --------------
    reg = build_default_registry()
    ctx = reg.context("hopper-cray-xe6")
    topo = Torus((4, 4, 4))
    fs = FaultSpec(
        degraded_links=(DegradedLink(torus_link(topo, 8, 2, +1), 6.0),),
        slow_ranks=(SlowRank(11, 2.5),),
        dead_links=(DeadLink(torus_link(topo, 5, 0, +1)),))
    max_rel = 0.0
    agreement = {}
    t0 = time.perf_counter()
    for algo, variant in (("lu", "2d"), ("cannon", "2d"), ("summa", "2d")):
        prog = PROGRAMS[(algo, variant)]
        kw = dict(n=4096.0, p=64, c=1, faults=fs)
        vec = simulate_program(prog, ctx, topo, **kw)
        ref = simulate_program(prog, ctx, topo, engine="reference", **kw)
        rel = abs(vec.total - ref.total) / ref.total
        agreement[f"{algo}/{variant}"] = rel
        max_rel = max(max_rel, rel)
    agreement_wall = time.perf_counter() - t0

    # --- detect -> diagnose -> re-plan -------------------------------------
    surf = reg.machine("hopper-cray-xe6")
    topo64 = topology_for(surf.machine, 64)
    link = torus_link(topo64, 8, 2, +1)
    inject = FaultSpec(degraded_links=(DegradedLink(link, 8.0),))
    measured = Network(topo64, surf.machine.latency,
                       surf.machine.inv_bandwidth, faults=inject)
    t0 = time.perf_counter()
    diag = probe_links(measured)
    probe_wall = time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as td:
        tuner = Tuner(registry=reg, plan_dir=td)
        kw = dict(device_count=64, platform="cpu", machine="hopper-cray-xe6")
        healthy = tuner.plan("matmul", 8192, refine="sim", **kw)
        emit_degraded_profile(reg, "hopper-cray-xe6", diag.to_fault_spec(),
                              diagnosis=diag)
        t0 = time.perf_counter()
        degraded = tuner.plan("matmul", 8192, **kw)
        replan_wall = time.perf_counter() - t0
        surf2 = reg.machine("hopper-cray-xe6")
        totals = {}
        for name, pl in (("stale", healthy), ("replan", degraded)):
            sim = simulate_programs(
                reg.program(pl.algo, pl.variant), surf2.context(),
                [{"n": 8192.0, "p": pl.p, "c": pl.c, "r": 1}],
                topology=topology_for(surf2.machine, 64),
                faults=diag.to_fault_spec())[0]
            totals[name] = float(sim.total)

    replan = {
        "injected_link": int(link),
        "localized_link": int(diag.component),
        "localized_correct": bool(diag.component == link),
        "injected_scale": 8.0,
        "estimated_severity": float(diag.severity),
        "probe_wall_s": probe_wall,
        "healthy_plan": f"{healthy.algo}/{healthy.variant}/c{healthy.c}",
        "degraded_plan": f"{degraded.algo}/{degraded.variant}/c{degraded.c}",
        "plan_flipped": bool((healthy.algo, healthy.variant, healthy.c)
                             != (degraded.algo, degraded.variant,
                                 degraded.c)),
        "replan_wall_s": replan_wall,
        "stale_under_fault_s": totals["stale"],
        "replan_under_fault_s": totals["replan"],
        "makespan_improvement": totals["stale"] / totals["replan"],
    }

    # --- serving overload: shed + deadlines + degradation ------------------
    import dataclasses

    from ..configs import get
    from ..core.machine import CPU_HOST
    from ..serving import (SchedulerConfig, TraceConfig, cost_model_for,
                           replay_traced, synthesize_trace)

    cost = cost_model_for(get("qwen1.5-4b").reduced(), CPU_HOST)
    trace = synthesize_trace(TraceConfig(n_requests=400, arrival_rate=200.0,
                                         seed=3))
    trace = [dataclasses.replace(r, deadline_s=2.0) for r in trace]
    t0 = time.perf_counter()
    rep, _, _ = replay_traced(trace, cost, policy="model",
                              scheduler_cfg=SchedulerConfig(max_queue=16),
                              degrade=True)
    serve_wall = time.perf_counter() - t0
    serving = {
        "n_requests": len(trace),
        "n_finished": rep.n_finished,
        "n_shed": rep.n_shed,
        "n_deadline_missed": rep.n_deadline_missed,
        "makespan_s": rep.makespan_s,
        "goodput_rps": rep.goodput_rps,
        "replay_wall_s": serve_wall,
    }

    # --- recovery planner decision sweep -----------------------------------
    planner = RecoveryPlanner(1.0, restart_overhead_s=20.0, checkpoint_s=2.0)
    decisions = {}
    for ratio in (1.2, 2.0, 4.0):
        for remaining in (5, 50, 500):
            d = planner.decide(ratio, remaining)
            decisions[f"ratio{ratio}_rem{remaining}"] = d.action

    return {
        "agreement": {
            "max_rel_err_vs_reference": max_rel,
            "per_program": agreement,
            "wall_s": agreement_wall,
        },
        "replan": replan,
        "serving": serving,
        "recovery_decisions": decisions,
    }


if __name__ == "__main__":
    import json

    print(json.dumps(main(), indent=1))
