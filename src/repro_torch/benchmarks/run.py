"""Benchmark harness of the port — one entry per paper table/figure and the
port's host-side emitters.  Prints ``name,us_per_call,derived`` CSV.

    python -m repro_torch.benchmarks.run [--device cuda|cpu] \\
        [--only fig1 tables ...]
    python -m repro_torch.benchmarks.run --check-regressions

``--device`` (default ``cuda``, with no CPU fallback) is the device of the
benches that touch one (``ON_DEVICE``); on ``cuda`` they run at the sizes
of :data:`CARD_SIZES`.  fig2, fig34 and fig5to8 spawn a
``torch.distributed`` world (``common.run_group_bench``: gloo, every rank
on cuda:0 or on the CPU).  The rest are host-side model arithmetic.
Results are written to ``<root>/bench_torch/*.json`` under the port's
artifacts root (``repro_torch.paths``, resolved at each write), each
stamped with ``_meta`` (``common.run_meta``).  ``tables`` fits the Hopper
surface once (about two minutes) and caches it under the root.

``roofline`` reads the dry run's records (``launch/dryrun.py``, under
``<root>/dryrun_torch/``) and emits their three terms; run the dry run
first.
``kernels`` sweeps K1's CTA tiles through matmul plans and refits the
kernel tier's constants (``bench_kernels``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

from .. import paths
from .common import emit, run_meta

#: the stamped JSONs' directory where set (the reference's module
#: attribute, which its tests point elsewhere); None: ``paths.bench_dir()``,
#: resolved at each write
OUT = None


def out_dir() -> str:
    return OUT or paths.bench_dir()

#: what ``--device cuda`` runs: fig5to8 on 4 gloo ranks on cuda:0 (g = 2,
#: 4096-row local blocks), the tuner at n = 4096 on 8 stacked ranks,
#: Phase A of the serving bench on qwen1.5-4b at full width and depth, and
#: K1's tile sweep at 4096^3
CARD_SIZES = {
    "fig5to8": {"world": 4, "n": 8192},
    "tuner": {"n": 4096},
    "serving": {"reduced": False},
    "kernels": {"n": 4096},
}


def _save(name: str, obj: dict):
    out = out_dir()
    os.makedirs(out, exist_ok=True)
    if isinstance(obj, dict):
        # run-metadata stamp: commit + timestamp + machine fingerprint +
        # repeat count (+ the card) — what the bench-history sentinel keys
        # runs by
        obj.setdefault("_meta", run_meta())
    with open(os.path.join(out, f"{name}.json"), "w") as f:
        json.dump(obj, f, indent=1)


def _sizes(name: str, device: str) -> dict:
    return CARD_SIZES.get(name, {}) if device == "cuda" else {}


def bench_fig1(device):
    t0 = time.perf_counter()
    from .fig1_blas_efficiency import main as fig1
    res = fig1(device=device)
    _save("fig1", res)
    emit("fig1_blas_efficiency", (time.perf_counter() - t0) * 1e6,
         f"peak={res['peak_gflops']:.1f}GF "
         f"dgemm_effmax={res['routines']['dgemm']['eff_max']:.2f}")
    return res


def bench_fig2(device):
    t0 = time.perf_counter()
    from .fig2_alpha_beta import main as fig2
    res = fig2(world=2, device=device)
    _save("fig2", res)
    emit("fig2_alpha_beta", (time.perf_counter() - t0) * 1e6,
         f"L={res['latency_s']:.2e}s bw={res['bandwidth_GBps']:.2f}GB/s")
    return res


def bench_fig34(device):
    t0 = time.perf_counter()
    from .fig34_calibration import main as fig34
    res = fig34(world=4, device=device)
    _save("fig34", res)
    m = res["measured_factor_vs_distance"]
    emit("fig34_calibration", (time.perf_counter() - t0) * 1e6,
         "measured_factors=" + ";".join(f"d{k}:{v:.2f}" for k, v in m.items()))
    return res


def bench_fig5to8(device):
    t0 = time.perf_counter()
    from .fig5to8_validation import main as fig5to8
    res = fig5to8(device=device, **_sizes("fig5to8", device))
    _save("fig5to8", res)
    emit("fig5to8_validation", (time.perf_counter() - t0) * 1e6,
         f"geo_err_cal={res['geomean_rel_err_cal']:.2f} "
         f"geo_err_nocal={res['geomean_rel_err_nocal']:.2f}")
    return res


def bench_tables():
    t0 = time.perf_counter()
    from .tables_2to5_predictions import main as tables
    res = tables()
    _save("tables_2to5", res)
    cl = res["claims"]
    emit("tables_2to5_predictions", (time.perf_counter() - t0) * 1e6,
         f"best_variant_agreement={cl['best_variant_agreement']:.2f} "
         f"crossover_cannon={cl['crossover_cannon']} "
         f"crossover_trsm={cl['crossover_trsm']}")
    for algo, rep in res["validation"].items():
        emit(f"table_validation_{algo}", 0.0,
             f"heldout_rel={rep['geo_mean_rel_err']:.1%} "
             f"mean_abs={rep['mean_abs_pct_points']:.2f}pts")
    return res


def lm_model_rows() -> dict:
    """The LM-step model's estimates of three archs' train step on a
    16 x 16 mesh (the ``lm_model`` bench's JSON)."""
    from ..configs import SHAPES, get
    from ..core.lm_model import predict_train_step
    rows = {}
    for arch in ("qwen1.5-110b", "arctic-480b", "granite-20b"):
        t0 = time.perf_counter()
        cfg = get(arch)
        est = predict_train_step(cfg, SHAPES["train_4k"],
                                 {"data": 16, "model": 16},
                                 fsdp=cfg.param_count() * 2 / 16 > 4e9)
        rows[arch] = est.to_dict()
        emit(f"lm_model_{arch}", (time.perf_counter() - t0) * 1e6,
             f"step={est.total_overlapped:.3f}s compute={est.compute_s:.3f}s "
             f"coll={est.collective_s:.3f}s")
    return rows


def bench_lm_model():
    rows = lm_model_rows()
    _save("lm_model", rows)
    return rows


def bench_tuner(device):
    t0 = time.perf_counter()
    from .bench_tuner import main as tuner
    res = tuner(device=device, **_sizes("tuner", device))
    _save("tuner", res)
    emit("tuner_dispatch", (time.perf_counter() - t0) * 1e6,
         f"model_eval={res['model_eval_us']:.0f}us "
         f"cache_mem={res['cache_hit_mem_us']:.0f}us "
         f"cache_disk={res['cache_hit_disk_us']:.0f}us "
         f"overhead={res['dispatch_overhead_us']:.0f}us "
         f"pred_speedup={res['predicted_speedup_auto_vs_worst']:.2f} "
         f"auto={res['auto']}")
    me = res["model_eval"]
    _save("BENCH_model_eval", me)
    emit("model_eval_vectorized", 0.0,
         f"scenarios={me['scenarios']} "
         f"min_speedup={me['min_speedup']:.1f}x "
         f"geomean_speedup={me['geomean_speedup']:.1f}x")
    return res


def bench_sim():
    t0 = time.perf_counter()
    from .bench_sim import main as sim
    res = sim()
    _save("BENCH_sim", res)
    emit("sim_summa_16x16_torus", (time.perf_counter() - t0) * 1e6,
         f"events={res['events']} "
         f"events_per_sec={res['events_per_sec']:.0f} "
         f"sim_over_nocal={res['sim_over_nocal']:.2f} "
         f"max_rel_err_nocal={res['max_rel_err_nocal']:.1e}")
    return res


def bench_sim_scale():
    t0 = time.perf_counter()
    from .bench_sim_scale import main as sim_scale
    res = sim_scale()
    _save("BENCH_sim_scale", res)
    emit("sim_scale", (time.perf_counter() - t0) * 1e6,
         f"p256={res['events_per_sec_p256']:.2e}ev/s "
         f"({res['throughput_vs_pr3_baseline']:.0f}x baseline, "
         f"{res['speedup_vs_reference_p256']:.1f}x reference) "
         f"p4096={res['wall_p4096_s']:.2f}s "
         f"p24576={res['wall_p24576_s']:.2f}s "
         f"agree={res['max_rel_err_vs_reference']:.1e}")
    return res


def bench_telemetry():
    t0 = time.perf_counter()
    from .bench_telemetry import main as tele
    res = tele()
    _save("BENCH_telemetry", res)
    emit("telemetry_loop", (time.perf_counter() - t0) * 1e6,
         f"record={res['record_runs_per_sec']:.0f}/s "
         f"join={res['join_rows_per_sec']:.0f}/s "
         f"refit={res['refit_seconds']:.2f}s "
         f"compact={res['compact_runs_per_sec']:.0f}/s")
    return res


def bench_kernels(device):
    t0 = time.perf_counter()
    from .bench_kernels import main as kern
    res = kern(device=device, **_sizes("kernels", device))
    _save("BENCH_kernels", res)
    ch, df = res["chosen_tile"], res["default_tile"]
    emit("kernels_tile_autotune", (time.perf_counter() - t0) * 1e6,
         f"tuned_over_default={res['tuned_over_default']:.2f}x "
         f"chosen={ch['bm']}x{ch['bn']}x{ch['bk']} "
         f"default={df['bm']}x{df['bn']}x{df['bk']} "
         f"shortlist={res['shortlist_size']} "
         f"refit_rev={res['refit']['revision']}")
    where = "card" if device == "cuda" else "cpu plain versions"
    for name, us in res["family_us"].items():
        emit(f"kernel_{name}_n{res['n']}", us, f"{where}: {res['device']}")
    return res


def bench_obs(device):
    t0 = time.perf_counter()
    from .bench_obs import main as obs_bench
    res = obs_bench(device=device)
    _save("BENCH_obs", res)
    emit("obs_tracing", (time.perf_counter() - t0) * 1e6,
         f"spans={res['spans_per_sec']:.0f}/s "
         f"overhead={res['enabled_overhead_pct']:.2f}% "
         f"export10k={res['export_10k_span_ms']:.0f}ms "
         f"flow_events={res['serving_trace_flow_events']}")
    emit("obs_watch", 0.0,
         f"detector_obs={res['watch_obs_per_sec']:.0f}/s "
         f"dashboard={res['dashboard_render_s'] * 1e3:.0f}ms "
         f"outlier_fires={res['watch_outlier_fires']}")
    return res


def bench_serving(device):
    t0 = time.perf_counter()
    from .bench_serving import main as serve
    res = serve(device=device, **_sizes("serving", device))
    _save("BENCH_serving", res)
    rp, cal = res["replay"], res["calibration"]
    emit("serving_scheduler", (time.perf_counter() - t0) * 1e6,
         f"refit_err={cal['mean_rel_err_after_refit']:.2f} "
         f"goodput_ratio={rp['goodput_ratio_model_over_fifo']:.2f} "
         f"p95ttft_fifo={rp['ttft_p95_fifo_s']:.2f}s "
         f"p95ttft_model={rp['ttft_p95_model_s']:.2f}s "
         f"replayed={rp['n_requests']}")
    return res


def bench_faults():
    t0 = time.perf_counter()
    from .bench_faults import main as faults
    res = faults()
    _save("BENCH_faults", res)
    rp, sv = res["replan"], res["serving"]
    emit("faults_chaos", (time.perf_counter() - t0) * 1e6,
         f"agree={res['agreement']['max_rel_err_vs_reference']:.1e} "
         f"localized={rp['localized_correct']} "
         f"flipped={rp['plan_flipped']} "
         f"improve={rp['makespan_improvement']:.2f}x "
         f"shed={sv['n_shed']} deadline={sv['n_deadline_missed']}")
    return res


def bench_roofline():
    t0 = time.perf_counter()
    from .roofline_table import load_cells, main as roof
    res = roof()
    meshes = list(res)
    _save("roofline", res)
    for mesh in meshes:
        agg = res[mesh]
        emit(f"roofline_{mesh}", (time.perf_counter() - t0) * 1e6,
             f"cells={agg['n_cells']} dominant={agg['dominant_counts']} "
             f"worst={agg['worst_fraction']}")
    for c in load_cells("pod"):
        if c["kind"] == "train":
            emit(f"roofline_cell_{c['arch']}@{c['shape']}", 0.0,
                 f"compute={c['compute_term']:.3g}s "
                 f"collective={c['collective_term']:.3g}s "
                 f"frac={c['roofline_fraction']:.3f}")
    return res


BENCHES = {
    "fig1": bench_fig1,
    "fig2": bench_fig2,
    "fig34": bench_fig34,
    "fig5to8": bench_fig5to8,
    "tables": bench_tables,
    "lm_model": bench_lm_model,
    "tuner": bench_tuner,
    "sim": bench_sim,
    "sim_scale": bench_sim_scale,
    "telemetry": bench_telemetry,
    "kernels": bench_kernels,
    "serving": bench_serving,
    "obs": bench_obs,
    "faults": bench_faults,
    "roofline": bench_roofline,
}
#: the benches that take the device
ON_DEVICE = ("fig1", "fig2", "fig34", "fig5to8", "tuner", "serving", "obs",
             "kernels")


def run_bench(name: str, device: str = "cuda") -> dict:
    """Run one bench (``ON_DEVICE`` ones on ``device``), write its JSON and
    return its result; an exception propagates."""
    fn = BENCHES[name]
    return fn(device) if name in ON_DEVICE else fn()


def check_regressions() -> int:
    """Bench-history sentinel: verdict the freshly-written BENCH_*.json
    files against prior same-machine history, then append them to the
    history (so the *next* run sees this one).  Exit 1 only on a
    regression with sufficient history — the first runs that merely
    build the baseline are warn-only by construction.  The JSONs are
    :func:`out_dir`'s, the history ``paths.bench_history_dir()``: never
    the reference suite's."""
    from ..obs.watch import history as hist

    out = out_dir()
    h = hist.BenchHistory()
    prior = h.load()
    runs_now = h.ingest_dir(out)
    if not runs_now:
        print(f"check-regressions: no BENCH_*.json under {out} "
              "(run the benches first)")
        return 0
    current = {r.bench: r.metrics for r in runs_now}
    fp = runs_now[0].fingerprint or None
    report = hist.check_regressions(current, prior, fingerprint=fp)
    print(hist.format_report(report))
    report_path = os.path.join(out, "regression_report.json")
    with open(report_path, "w") as f:
        json.dump(report, f, indent=1, sort_keys=True)
    print(f"report: {report_path}  history: {h.path} "
          f"({len(prior)} prior + {len(runs_now)} new lines)")
    if not report["sufficient_history"]:
        print("check-regressions: no metric has enough same-machine "
              "history yet - warn-only")
        return 0
    return 1 if report["counts"]["regression"] else 0


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="*", default=None, choices=list(BENCHES))
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device of the benches that touch one (no CPU "
                         "fallback: cpu must be asked for)")
    ap.add_argument("--check-regressions", action="store_true",
                    help="don't run benches; verdict <root>/bench_torch/"
                         "BENCH_*.json against the bench history and "
                         "append this run to it")
    args = ap.parse_args(argv)
    if args.check_regressions:
        sys.exit(check_regressions())
    print("name,us_per_call,derived")
    failures = []
    for name in BENCHES:
        if args.only and name not in args.only:
            continue
        try:
            run_bench(name, args.device)
        except Exception as e:  # noqa: BLE001 — report and run the rest
            traceback.print_exc()
            failures.append((name, repr(e)))
            emit(f"{name}_FAILED", 0.0, repr(e)[:120])
    if failures:
        sys.exit(1)


if __name__ == "__main__":
    main()
