"""Observability-layer overhead and throughput, emitted as
``artifacts/bench_torch/BENCH_obs.json``.

    python -m repro_torch.benchmarks.bench_obs [--device cuda|cpu]

Five measurements; the dispatch loop runs on the device, the rest on the
host:

* **spans/sec** — raw tracer throughput (`span()` open/close into the
  ring buffer);
* **dispatch overhead** — the same model-guided matmul dispatch loop
  timed with tracing off and tracing on; CI gates the enabled-path
  overhead at <= 5% (min-of-batches on both sides, so scheduler noise
  cancels);
* **exporter** — wall milliseconds to render a 10k-span buffer to the
  paired Chrome/Perfetto JSON (saved under the port's traces directory,
  ``<root>/traces_torch/``, as the paired serving trace below;
  ``repro_torch.paths``);
* **serving trace** — a cost-model trace replay exported through
  ``obs.serving_trace``; CI checks the paired predicted/measured flow
  events are present;
* **watch** — streaming-detector throughput on the incremental path
  (CI gates >= 100k obs/s) and observatory-dashboard render time for a
  10k-span session (CI gates < 1 s).
"""

import json
import os
import shutil
import tempfile
import time


def _batch_seconds(fn, calls: int = 8) -> float:
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t0) / calls


def main(device: str = "cuda") -> dict:
    """``device``: the dispatch loop's (``"cuda"``: the current card; no
    CPU fallback)."""
    import numpy as np
    import torch

    from .. import obs, paths, telemetry
    from ..devices import canonical, default_devices

    dev = default_devices()[0] if device == "cuda" else canonical(device)
    out = {}

    # --- (A) tracer throughput -------------------------------------------
    tr = obs.Tracer(capacity=16384)
    n = 50_000
    t0 = time.perf_counter()
    for _ in range(n):
        with tr.span("work", cat="dispatch"):
            pass
    dt = time.perf_counter() - t0
    out["spans_per_sec"] = n / dt
    out["span_us_per_call"] = dt / n * 1e6

    # --- (B) dispatch-loop overhead, tracing off vs on --------------------
    from ..tuner import PlanCache, Tuner, build_default_registry
    from ..tuner import dispatch

    tmp = tempfile.mkdtemp(prefix="bench_obs_")
    try:
        tuner = Tuner(registry=build_default_registry(),
                      cache=PlanCache(os.path.join(tmp, "plans")))
        rng = np.random.default_rng(0)
        a = torch.from_numpy(np.asarray(rng.standard_normal((320, 320)),
                                        dtype=np.float32)).to(dev)

        dispatch.matmul(a, a, tuner=tuner, devices=[dev])   # warm: plan

        # block on both sides: the traced path blocks inside the execute
        # phase (so the span covers real work), and an unblocked baseline
        # would make the comparison async-vs-sync instead of off-vs-on
        def call():
            dispatch.matmul(a, a, tuner=tuner, devices=[dev])
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        telemetry.disable()
        # warm both modes (first traced call builds the tracer and the
        # PhaseTimer path), then interleave off/on batches so clock and
        # scheduler drift hit both sides equally; min-of-batches each
        obs.disable()
        call()
        obs.enable(capacity=16384)
        call()
        base_s = traced_s = float("inf")
        for _ in range(16):
            obs.disable()
            base_s = min(base_s, _batch_seconds(call))
            obs.enable()
            traced_s = min(traced_s, _batch_seconds(call))
        n_spans_per_call = 4                      # plan + root + 2 phases
        out["dispatch_base_us"] = base_s * 1e6
        out["dispatch_traced_us"] = traced_s * 1e6
        out["enabled_overhead_pct"] = max(0.0, traced_s / base_s - 1.0) * 100
        out["enabled_overhead_us_per_span"] = (
            max(0.0, traced_s - base_s) / n_spans_per_call * 1e6)
    finally:
        obs.reset()
        telemetry.reset()
        shutil.rmtree(tmp, ignore_errors=True)

    # --- (C) exporter time on a 10k-span trace ----------------------------
    big = obs.Tracer(capacity=16384)
    for i in range(10_000):
        big.complete(f"op{i % 7}", 1e-4, cat="dispatch",
                     predicted_s=(9e-5 if i % 2 else None),
                     args={"n": i})
    spans = big.spans()
    t0 = time.perf_counter()
    doc = obs.export_spans(spans)
    payload = json.dumps(doc)
    out["export_10k_span_ms"] = (time.perf_counter() - t0) * 1e3
    out["export_events"] = len(doc["traceEvents"])
    traces = paths.traces_dir()
    os.makedirs(traces, exist_ok=True)
    with open(os.path.join(traces, "obs_bench_trace.json"), "w") as f:
        f.write(payload)

    # --- (D) serving replay -> paired trace -------------------------------
    from ..configs import get
    from ..core.machine import CPU_HOST
    from ..serving.cost import cost_model_for
    from ..serving.trace import TraceConfig, replay_traced, \
        synthesize_trace

    cfg = get("qwen1.5-4b").reduced()
    cost = cost_model_for(cfg, CPU_HOST)
    trace = synthesize_trace(TraceConfig(n_requests=300, seed=3))
    t0 = time.perf_counter()
    rep, reports, reg = replay_traced(trace, cost, policy="model")
    out["replay_wall_s"] = time.perf_counter() - t0
    out["replay_steps"] = rep.steps
    out["replay_goodput_rps"] = rep.goodput_rps
    doc = obs.serving_trace(reports, other_data=rep.to_dict())
    flows = sum(1 for ev in doc["traceEvents"] if ev.get("ph") == "s")
    out["serving_trace_events"] = len(doc["traceEvents"])
    out["serving_trace_flow_events"] = flows
    with open(os.path.join(traces, "serving_paired_trace.json"), "w") as f:
        json.dump(doc, f)

    # --- (E) watch: detector throughput + dashboard render ----------------
    from ..obs import watch

    watcher = watch.StreamWatcher(emit_alerts=False)
    rng = np.random.default_rng(7)
    vals = 0.05 + 0.01 * rng.standard_normal(100_000)
    sw = watcher.series("rel_err/op/dgemm", tier="op")
    fires = 0
    t0 = time.perf_counter()
    observe = sw.observe
    for v in vals:
        fires += len(observe(v))
    dt = time.perf_counter() - t0
    out["watch_obs_per_sec"] = len(vals) / dt
    out["watch_obs_us"] = dt / len(vals) * 1e6
    out["watch_firings_in_control"] = fires
    out["watch_outlier_fires"] = len(sw.observe(10.0))

    # dashboard render over the (C) 10k-span session + a synthetic
    # SLO/history payload — the gate is < 1 s wall
    slo = watch.SLOWatcher()
    for i in range(2000):
        slo.record_outcomes(float(i), ttft=(i % 17 != 0),
                            tpot=True, goodput=(i % 17 != 0))
        slo.check(float(i))
    hist_runs = [watch.BenchRun("BENCH_obs", f"c{i}", "bench", float(i),
                                {"spans_per_sec": 5e5 * (1 + 0.01 * i)})
                 for i in range(12)]
    t0 = time.perf_counter()
    data = watch.collect_data(
        summary=obs.summary(spans=spans), accuracy=None,
        watch=watcher, slo=slo, history=hist_runs)
    html = watch.render_dashboard(data)
    out["dashboard_render_s"] = time.perf_counter() - t0
    out["dashboard_bytes"] = len(html)
    os.makedirs(paths.obs_dir(), exist_ok=True)
    with open(os.path.join(paths.obs_dir(), "dashboard_bench.html"),
              "w") as f:
        f.write(html)
    return out


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()
    print(json.dumps(main(args.device), indent=1))
