"""Telemetry-subsystem throughput (pure CPU; no device needed).

The feedback loop has to keep up with a serving system that dispatches
thousands of operations per second, so each stage is measured on a
synthetic-but-realistic workload and emitted as
``artifacts/bench_torch/BENCH_telemetry.json``:

* record  — ``RunStore.append`` throughput (runs/sec, fsync-free JSONL);
* load    — full-store parse throughput (runs/sec);
* join    — residual rows/sec joining measured runs against the model's
  per-phase predictions (the per-scenario eval cache is what makes many
  repeated scenarios cheap);
* refit   — wall seconds of one online recalibration over the joined rows;
* compact — runs/sec rewriting the store with a per-scenario history cap.
"""

import shutil
import tempfile
import time


def main() -> dict:
    import numpy as np

    from .. import telemetry
    from ..tuner import build_default_registry

    registry = build_default_registry()
    ctx = registry.machine("cpu-host").context()

    # --- synthesize a realistic store: 32 scenarios x 64 repeats -----------
    scenarios = []
    rng = np.random.default_rng(0)
    for algo, variant in (("summa", "2d"), ("cannon", "2d"),
                          ("summa", "2.5d"), ("trsm", "2d")):
        for n in (1024, 4096, 16384, 65536):
            for p in (16, 64):
                c = 4 if variant == "2.5d" else 1
                res = registry.evaluate_grid(ctx, algo, variant, float(n),
                                             float(p), float(c), 1.0)
                scenarios.append((algo, variant, n, p, c, float(res.total)))
    reps = 64
    records = []
    for i in range(reps):
        for algo, variant, n, p, c, total in scenarios:
            noise = float(np.exp(rng.normal(np.log(2.0), 0.2)))
            records.append(telemetry.RunRecord(
                fingerprint="bench-fp", machine="cpu-host", op=algo,
                variant=variant, n=n, p=p, c=c,
                phases={"execute": total * noise},
                timestamp=1000.0 + i))
    n_runs = len(records)

    tmp = tempfile.mkdtemp(prefix="bench_telemetry_")
    try:
        store = telemetry.RunStore(tmp)
        t0 = time.perf_counter()
        store.extend(records)
        record_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        loaded = store.load()
        load_s = time.perf_counter() - t0
        assert len(loaded) == n_runs

        t0 = time.perf_counter()
        rows = telemetry.join(loaded, registry)
        join_s = time.perf_counter() - t0
        assert len(rows) == n_runs

        t0 = time.perf_counter()
        result = telemetry.refit(rows, registry)
        refit_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        dropped = store.compact(keep_last=16)
        compact_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # --- disabled-path overhead ------------------------------------------
    # The hot-path guard (enabled() + a no-op phase_scope) is what every
    # dispatch pays when recording is off; it must stay sub-microsecond.
    from ..telemetry import phase_scope
    telemetry.disable()
    try:
        n_calls = 200_000
        t0 = time.perf_counter()
        for _ in range(n_calls):
            if telemetry.enabled():
                pass
            with phase_scope(None, "execute"):
                pass
        disabled_us = (time.perf_counter() - t0) / n_calls * 1e6
    finally:
        telemetry.reset()
    assert disabled_us < 1.0, (
        f"disabled telemetry path costs {disabled_us:.3f}us/call (>= 1us)")

    return {
        "disabled_path_us_per_call": disabled_us,
        "runs": n_runs,
        "scenarios": len(scenarios),
        "record_runs_per_sec": n_runs / record_s,
        "load_runs_per_sec": n_runs / load_s,
        "join_rows_per_sec": len(rows) / join_s,
        "refit_seconds": refit_s,
        "refit_speed_scale": result.speed_scale,
        "compact_runs_per_sec": n_runs / compact_s,
        "compact_dropped": dropped,
    }


if __name__ == "__main__":
    import json

    print(json.dumps(main(), indent=1))
