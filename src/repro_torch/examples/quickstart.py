"""Quickstart: the paper's workflow in a few dozen lines, on the port.

1. Build a performance model for a machine (Hopper constants, fitted
   calibration), 2. ask it which algorithm variant to run for a scenario,
3. author a brand-new algorithm model through the cost-IR API
   (``repro_torch.perf``) and tune it over a vectorized scenario grid,
4. replay a program rank-by-rank on an explicit torus with the
   discrete-event simulator (``repro_torch.sim``) and dump a Chrome trace,
5. close the loop (``repro_torch.telemetry``): record real dispatched
   matmuls on the device (K1 on the card), join them against the model's
   per-phase predictions, refit the device's profile from the residuals,
   and save the paper-style accuracy report under the port's
   ``artifacts/telemetry_torch/``,
6. watch the loop (``repro_torch.obs.watch``): stream the same residuals
   through the per-tier anomaly detectors and render the self-contained
   HTML observatory dashboard under ``artifacts/obs_torch/``.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Steps 1-4, the fault diagnosis and the LM table are host arithmetic in
numpy; only step 5 touches the device.  The Hopper fit runs once (about two
minutes) and is cached in ``artifacts/hopper_joint_torch.json``.  With
``REPRO_TELEMETRY=1`` the dispatch inside the loop also records itself.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..core import HOPPER
from ..core.calibration import hopper_fitted_ctx
from ..core.predictor import best_variant, format_table, prediction_table
from . import add_device_argument, device_for


def author_a_model_demo(ctx):
    """Authoring through the cost IR: a toy ring-style matmul — all-gather
    the A panels, local dgemms, reduce the partials — in ~10 lines, then
    one vectorized evaluation over a whole (n, p) grid."""
    from ..perf import Collective, Compute, Loop, N, P, Program, Seq, T, sqrt
    from ..tuner import PerfModelRegistry

    sp = sqrt(P)
    bs = N / sp
    w = bs * bs
    toy = Program(
        "ring_matmul", "2d",
        Seq(("allgather_A", Collective("allgather", w, q=sp, dist=1)),
            ("dgemm", Loop(Compute("dgemm", bs, T), sp)),
            ("reduce_C", Collective("reduce", w, q=sp, dist=sp))))
    reg = PerfModelRegistry()
    reg.register_program(toy)

    ns = np.array([8192.0, 16384.0, 32768.0, 65536.0])
    ps = np.array([256.0, 1024.0, 4096.0])
    Ng, Pg = np.meshgrid(ns, ps, indexing="ij")
    res = reg.evaluate_grid(ctx, "ring_matmul", "2d", Ng, Pg)
    print("  est seconds over the (n, p) grid (one vectorized pass):")
    for i, n in enumerate(ns):
        row = "  ".join(f"p={int(p):>5}: {res.total[i, j]:7.2f}s"
                        for j, p in enumerate(ps))
        print(f"    n={int(n):>6}  {row}")
    agg = res.phases["allgather_A"].exposed + res.phases["reduce_C"].exposed
    frac = float(np.mean(agg / res.total))
    print(f"    (collectives are {100 * frac:.0f}% of the estimate "
          f"on average — per-phase breakdown comes free)")


def simulate_demo(ctx):
    """Per-rank simulation (repro_torch.sim): the same IR program replayed
    on an explicit 2D torus — contention emerges from link loads instead
    of a calibrated scalar — then inspected as a Chrome trace."""
    from ..perf import EvalOptions, PROGRAMS, evaluate_program
    from ..sim import Torus, simulate_program

    n, p = 32768.0, 64
    prog = PROGRAMS[("summa", "2d_ovlp")]
    res = simulate_program(prog, ctx, Torus((8, 8)), n, p)
    nocal = evaluate_program(prog, ctx, n, p,
                             options=EvalOptions(mode="nocal"))
    trace = res.dump_chrome_trace()
    print(f"  simulated {res.p} ranks on {res.topology}: "
          f"{res.total:.3f}s vs {float(nocal.total):.3f}s contention-free "
          f"({res.events} events)")
    print(f"  critical rank {res.critical_rank}; per-phase on it: "
          + ", ".join(f"{name}={dur:.3f}s" for name, dur in res.critical_path))
    print(f"  overlap efficiency {res.overlap_efficiency:.0%}; Chrome trace "
          f"-> {trace}")
    print("  (open chrome://tracing or https://ui.perfetto.dev and load the "
          "file to see one timeline track per rank)")


def telemetry_demo(device):
    """The measured-run feedback loop: the paper validates its models
    against measured executions (Tables II-V); here the validation — and
    the re-parameterization it suggests — runs live on ``device``.

    The products run through ``dispatch.execute`` on one rank (p = 1: the
    local block is the whole matrix, so on the card every product is
    K1); each record is the best of 5 host-timed calls, each ending in a
    synchronize on the card."""
    import time

    import torch

    from .. import telemetry
    from ..tuner import Tuner, build_default_registry
    from ..tuner import dispatch

    registry = build_default_registry()
    tuner = Tuner(registry=registry)
    store = telemetry.default_store()  # artifacts/telemetry_torch/ (or env)
    rng = np.random.default_rng(0)
    sizes = (768, 1024)
    reps, records = 5, 8
    mats = {n: torch.from_numpy(rng.standard_normal((n, n)).astype(
        "float32")).to(device) for n in sizes}
    plans = {n: tuner.plan("matmul", n, devices=[device]) for n in sizes}
    fp = plans[sizes[0]].fingerprint

    def run(n):
        out = dispatch.execute(plans[n], mats[n], mats[n], devices=[device])
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return out

    telemetry.disable()          # the inner timing loop self-records below
    try:
        for n in sizes:          # untimed: the kernels build on first use
            run(n)
        for _ in range(records):
            for n in sizes:
                # best-of-reps, like the paper's own benchmarks: one clean
                # record per scenario repetition, immune to GC/noise spikes
                best = float("inf")
                for _ in range(reps):
                    t0 = time.perf_counter()
                    run(n)
                    best = min(best, time.perf_counter() - t0)
                pt = telemetry.timer_for_plan(plans[n],
                                              meta={"agg": f"best{reps}"})
                pt.add("execute", best)
                pt.emit(store=store, force=True)
    finally:
        telemetry.reset()

    runs = [r for r in store.load(fp) if r.meta.get("agg") == f"best{reps}"]
    rows = telemetry.join(runs, registry)
    before = telemetry.mean_abs_log_ratio(rows)
    result = telemetry.refit(rows, registry)
    result.apply(registry)
    rows2 = telemetry.join(runs, registry)
    print(f"  recorded {len(runs)} runs -> {len(rows)} residual rows; "
          f"refit: speed x{result.speed_scale:.2f}, "
          f"comm x{result.comm_scale:.2f} "
          f"(profile revision {result.machine.revision}, "
          f"fingerprint {result.fingerprint})")
    print(f"  mean |log measured/predicted|: {before:.3f} -> "
          f"{telemetry.mean_abs_log_ratio(rows2):.3f}")
    report = telemetry.accuracy_report(rows2)
    print("  " + telemetry.format_report(report).replace("\n", "\n  "))
    path = telemetry.save_report(report)
    print(f"  report -> {path}")
    for st in telemetry.check(rows2).values():
        print(f"  drift[{st.op}]: rolling mean rel err "
              f"{st.rolling_mean_rel_err:.1%} over last {st.n_rows} runs "
              f"-> {'DRIFTED (profile would be retired)' if st.drifted else 'healthy'}")
    return rows2, report


def observatory_demo(rows, report):
    """The observatory (repro_torch.obs.watch): stream the demo's residual
    rows through the per-tier detector banks and render the
    self-contained HTML dashboard — accuracy table, residual
    histograms, alert feed — under ``artifacts/obs_torch/``."""
    from .. import obs
    from ..obs import watch

    obs.enable()
    watcher = watch.StreamWatcher()
    for row in sorted(rows, key=lambda r: r.timestamp):
        watcher.observe_residual(row)
    s = watcher.summary()
    print(f"  {s['n_obs']} residuals through {s['n_series']} detector "
          f"bank(s): {s['n_firings']} firing(s)"
          + (" - the profile would be retired and re-planned"
             if s["n_firings"] else " (stream in control)"))
    path = watch.save_dashboard(
        data=watch.collect_data(accuracy=report, watch=watcher))
    print(f"  observatory dashboard -> {path} (self-contained HTML; "
          f"open in any browser)")


def fault_demo():
    """Break the machine, find the break, plan around it (repro_torch.sim
    faults + repro_torch.telemetry.diagnose): inject a degraded torus
    link, localize it with shift-pattern probes, emit the degraded machine
    revision, and let the tuner re-plan with the fault injected."""
    import tempfile

    from ..sim import DegradedLink, FaultSpec, Network, topology_for, \
        torus_link
    from ..telemetry import emit_degraded_profile, probe_links
    from ..tuner import Tuner
    from ..tuner.registry import build_default_registry

    reg = build_default_registry()
    surf = reg.machine("hopper-cray-xe6")
    topo = topology_for(surf.machine, 64)
    link = torus_link(topo, 8, 2, +1)          # one dim-2 link, 8x slower
    measured = Network(topo, surf.machine.latency, surf.machine.inv_bandwidth,
                       faults=FaultSpec(degraded_links=(
                           DegradedLink(link, 8.0),)))
    diag = probe_links(measured)
    print(f"  injected link {link}; probes localized "
          f"{diag.component_name} (link {diag.component}) at "
          f"~{diag.severity:.1f}x")
    with tempfile.TemporaryDirectory() as td:
        tuner = Tuner(registry=reg, plan_dir=td)
        kw = dict(device_count=64, platform="cpu",
                  machine="hopper-cray-xe6")
        healthy = tuner.plan("matmul", 8192, refine="sim", **kw)
        emit_degraded_profile(reg, "hopper-cray-xe6", diag.to_fault_spec(),
                              diagnosis=diag)
        degraded = tuner.plan("matmul", 8192, **kw)  # cache-missed, faulted
        print(f"  healthy plan {healthy.algo}/{healthy.variant} c={healthy.c}"
              f" -> degraded plan {degraded.algo}/{degraded.variant} "
              f"c={degraded.c} (routes around the sick link)")


def lm_table():
    """The LM-step model's sharding trade-off for a TPU pod."""
    from ..configs import SHAPES, get
    from ..core.lm_model import sharding_tradeoff_table
    tbl = sharding_tradeoff_table(get("qwen1.5-110b"), SHAPES["train_4k"],
                                  chips=256)
    for name, row in sorted(tbl.items(), key=lambda kv: kv[1]["step_s"])[:5]:
        print(f"  {name:16s} step={row['step_s']:7.2f}s "
              f"compute={row['compute_s']:6.2f}s "
              f"coll={row['collective_s']:6.2f}s "
              f"params/chip={row['param_gb_per_chip']:.2f} GB")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device_argument(ap)
    args = ap.parse_args(argv)
    device = device_for(args.device)

    # The fitted Hopper model (calibration recovered from the paper's
    # published Cannon table; cached under the port's artifacts root)
    ctx = hopper_fitted_ctx()

    print("=== Which matmul variant should I run? (paper §VI-B) ===")
    for cores in (1536, 24576, 393216):
        p = cores // HOPPER.threads_per_unit
        choices = best_variant(ctx, "cannon", 32768, p)
        best = min(choices, key=lambda v: choices[v].result.total)
        print(f"  {cores:>7} cores -> {best:10s} "
              f"(est {choices[best].result.total:.2f}s, "
              f"{choices[best].pct_peak:.1f}% of peak)")

    print("\n=== Predicted %-of-peak table (Table II analog) ===")
    tbl = prediction_table(ctx, "cannon", [32768], [1536, 6144, 24576])
    print(format_table(tbl, "cannon"))

    print("\n=== Author a new model through the cost IR (repro_torch.perf) ===")
    author_a_model_demo(ctx)

    print("\n=== Simulate it rank-by-rank on a torus (repro_torch.sim) ===")
    simulate_demo(ctx)

    print("\n=== Close the loop: measure, refit, report (repro_torch.telemetry) ===")
    rows, report = telemetry_demo(device)

    print("\n=== Watch the loop: detectors + dashboard (repro_torch.obs.watch) ===")
    observatory_demo(rows, report)

    print("\n=== Break it: inject a fault, localize, re-plan (repro_torch.sim) ===")
    fault_demo()

    print("\n=== The same question for an LLM on a TPU pod (beyond-paper) ===")
    lm_table()


if __name__ == "__main__":
    main()
