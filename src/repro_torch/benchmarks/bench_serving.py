"""Serving scheduler benchmark — the paper's predict/measure/refit loop
applied to continuous batching, emitted as
``artifacts/bench_torch/BENCH_serving.json``.

    python -m repro_torch.benchmarks.bench_serving [--device cuda|cpu]

Phase A (calibrate): run real scheduler steps on the device (on the CPU
qwen1.5-4b at its smoke size, on a card at full width and depth in bf16,
with the cost model of the device's profile) with telemetry recording on,
so every step carries (predicted, measured) prefill/decode phases; ``refit_serving`` fits the per-phase scales and
the post-refit mean relative error on serving steps is the accuracy
gate (CI requires <= 0.35, the paper-style "model matches machine" bar).

Phase B (replay): a >= 10k-request skewed synthetic trace replayed on
the simulated clock under FIFO and under the model-guided policy —
same trace, same (calibrated) cost model, same SLOs.  CI gates on the
model-guided policy achieving >= FIFO goodput and strictly better p95
TTFT.

Phase C (re-key): a drift-style machine revision bump must retire the
calibrated serving cost table exactly like it retires tuner plans.
"""

import dataclasses
import shutil
import tempfile
import time
from typing import Optional


def _calibrate(n_requests: int = 16, device: str = "cpu",
               reduced: bool = True) -> dict:
    """Phase A: measured serve steps -> telemetry -> refit_serving, on
    ``device`` with the cost model of its profile (``cpu-host`` or
    ``h100-sxm``); ``reduced``: the smoke-size config, else full width and
    depth in the config's own type."""
    import numpy as np
    import torch

    from .. import telemetry
    from ..configs import get
    from ..core.machine import MACHINES
    from ..devices import canonical, default_devices
    from ..models import build_model
    from ..serving.cost import cost_model_for, refit_serving
    from ..serving.policy import ModelGuidedPolicy
    from ..serving.scheduler import (ModelBackend, Request, Scheduler,
                                     SchedulerConfig)
    from ..telemetry import residuals
    from ..tuner.registry import machine_for_platform

    dev = default_devices()[0] if device == "cuda" else canonical(device)
    cfg = get("qwen1.5-4b")
    if reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    net = model.init(0, device=dev)
    cost = cost_model_for(cfg, MACHINES[machine_for_platform(dev.type)])
    rng = np.random.default_rng(0)

    def workload(tag: str) -> Scheduler:
        backend = ModelBackend(model, net, max_cache_len=128)
        sched = Scheduler(backend, cost,
                          SchedulerConfig(max_cache_len=128, max_batch=8),
                          policy=ModelGuidedPolicy(step_budget_s=0.05))
        r = np.random.default_rng(1)
        # long-ish decodes keep the decode batch shape stable between
        # steps, so measured step times are dominated by real work, not
        # by batch-churn noise — exactly the rows the affine refit wants
        for i in range(n_requests):
            plen = int(r.integers(8, 48))
            sched.submit(Request(
                rid=f"{tag}{i}",
                prompt=torch.tensor(r.integers(1, cfg.vocab_size, (1, plen)),
                                    dtype=torch.int32),
                max_new_tokens=int(r.integers(16, 33)),
                arrival_s=0.002 * i))
        return sched

    workload("warm").run()          # warm every step shape off the record

    tmp = tempfile.mkdtemp(prefix="bench_serving_")
    try:
        telemetry.enable(telemetry.RunStore(tmp))
        t0 = time.perf_counter()
        sched = workload("c")
        reports = sched.run()
        wall = time.perf_counter() - t0
        records = [r for r in telemetry.default_store().load()
                   if r.kind == "serve_step"]
    finally:
        telemetry.reset()
        shutil.rmtree(tmp, ignore_errors=True)

    refit = refit_serving(records, cost)
    rows = residuals.join(records)
    del rng
    return {
        "requests": n_requests,
        "steps": len(reports),
        "wall_s": wall,
        "serve_step_records": len(records),
        "residual_rows": len(rows),
        "refit": refit.to_dict(),
        "mean_rel_err_after_refit": refit.mean_rel_err_after,
        "scales": refit.scales.to_dict(),
    }


def _replay(scales, n_requests: int = 10_000) -> dict:
    """Phase B: big-trace policy comparison on the simulated clock."""
    from ..configs import get
    from ..core.machine import CPU_HOST
    from ..serving.cost import ServeCostModel
    from ..serving.trace import TraceConfig, compare_policies, \
        synthesize_trace

    cfg = get("qwen1.5-4b").reduced()
    cost = ServeCostModel(cfg, CPU_HOST, scales)
    # arrival rate just past the calibrated capacity knee (~4 req/s on
    # cpu-host scales): the regime where composition matters — lighter
    # and FIFO is fine, heavier and nobody meets SLOs
    trace = synthesize_trace(TraceConfig(n_requests=n_requests, seed=0,
                                         arrival_rate=4.5))
    t0 = time.perf_counter()
    reps = compare_policies(trace, cost, step_budget_s=0.06)
    wall = time.perf_counter() - t0
    fifo, model = reps["fifo"], reps["model"]
    return {
        "n_requests": n_requests,
        "replay_wall_s": wall,
        "fifo": fifo.to_dict(),
        "model": model.to_dict(),
        "goodput_ratio_model_over_fifo":
            (model.goodput_rps / fifo.goodput_rps
             if fifo.goodput_rps > 0 else float("inf")),
        "ttft_p95_fifo_s": fifo.ttft_p95_s,
        "ttft_p95_model_s": model.ttft_p95_s,
        "model_beats_fifo_p95_ttft": model.ttft_p95_s < fifo.ttft_p95_s,
        "model_goodput_ge_fifo": model.goodput_rps >= fifo.goodput_rps,
    }


def _rekey() -> dict:
    """Phase C: a revision bump retires the calibrated cost table."""
    from ..configs import get
    from ..core.machine import CPU_HOST
    from ..serving.cost import ServeScales, cost_model_for, install_scales

    cfg = get("qwen1.5-4b").reduced()
    install_scales(cfg, CPU_HOST, ServeScales(prefill_scale=2.0,
                                              decode_scale=2.0,
                                              overhead_s=1e-4))
    calibrated = cost_model_for(cfg, CPU_HOST).scales.prefill_scale
    bumped = dataclasses.replace(CPU_HOST, revision=CPU_HOST.revision + 1)
    fresh = cost_model_for(cfg, bumped).scales.prefill_scale
    return {
        "calibrated_scale": calibrated,
        "post_bump_scale": fresh,
        "rekey_ok": calibrated == 2.0 and fresh == 1.0,
    }


def main(device: str = "cuda", reduced: Optional[bool] = None) -> dict:
    """``device``: Phase A's (``"cuda"``: the current card; no CPU
    fallback).  ``reduced`` (default: on the CPU only): Phase A's model at
    its smoke size rather than full width and depth."""
    from ..serving.cost import ServeScales

    cal = _calibrate(device=device,
                     reduced=(device == "cpu") if reduced is None else reduced)
    # the replay gate uses a *pinned* cpu-host calibration (a refit
    # output captured once) rather than this run's fitted scales, so the
    # FIFO-vs-model comparison is bit-deterministic in CI — Phase A
    # above is where live measurement noise is allowed to show up
    replay = _replay(ServeScales(prefill_scale=0.357, decode_scale=2.497,
                                 overhead_s=7.5e-4))
    rekey = _rekey()
    return {
        "calibration": cal,
        "replay": replay,
        "rekey": rekey,
        "gates": {
            "post_refit_mean_rel_err_le_035":
                cal["mean_rel_err_after_refit"] <= 0.35,
            "model_goodput_ge_fifo": replay["model_goodput_ge_fifo"],
            "model_beats_fifo_p95_ttft":
                replay["model_beats_fifo_p95_ttft"],
            "rekey_ok": rekey["rekey_ok"],
        },
    }


if __name__ == "__main__":
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()
    print(json.dumps(main(args.device), indent=1))
