"""Discrete-event simulator benchmark (pure numpy; no device needed).

Two measurements, emitted as ``artifacts/bench_torch/BENCH_sim.json``:

* throughput — events/second replaying the SUMMA 2D program on a 16x16
  torus (256 ranks, the v5e-pod shape), plus the per-phase makespan and a
  Chrome trace dumped under ``artifacts/traces_torch/`` for visual
  inspection;
* agreement — for every registered cost-IR program, the relative error of
  the contention-free (crossbar) simulation against the closed-form
  ``est_NoCal`` evaluator.  ``max_rel_err_nocal`` over the paper's 16
  (algo, variant) programs is the CI gate (<= 1e-6); LU rides along in
  ``agreement_nocal`` for completeness.
"""

import json
import time


def main() -> dict:
    from ..perf import EvalOptions, PROGRAMS, evaluate_program
    from ..sim import Crossbar, Torus, simulate_program
    from ..tuner import DEFAULT_REGISTRY

    ctx = DEFAULT_REGISTRY.context("hopper-cray-xe6")

    # --- throughput: SUMMA 2D on a 16x16 torus -----------------------------
    torus = Torus((16, 16))
    prog = PROGRAMS[("summa", "2d")]
    n, p = 65536.0, 256
    # warm the route/fold caches on the SAME instance the timed run uses
    # (timing a fresh Torus would charge cold route construction to the
    # reported events/sec)
    simulate_program(prog, ctx, torus, n, p)
    t0 = time.perf_counter()
    res = simulate_program(prog, ctx, torus, n, p)
    wall = time.perf_counter() - t0
    trace_path = res.dump_chrome_trace()
    est_cal = evaluate_program(prog, ctx, n, p)
    est_nocal = evaluate_program(prog, ctx, n, p,
                                 options=EvalOptions(mode="nocal"))

    # --- agreement: contention-free sim vs est_NoCal per variant -----------
    xbar = Crossbar(16)
    agreement = {}
    max_rel_paper = 0.0
    for (algo, variant), program in sorted(PROGRAMS.items()):
        c = 2 if program.uses_c else 1
        r = 2 if program.uses_r else 1
        est = float(evaluate_program(program, ctx, 8192.0, 16, c, r,
                                     options=EvalOptions(mode="nocal")).total)
        sim = simulate_program(program, ctx, xbar, 8192.0, 16, c, r)
        rel = abs(sim.total - est) / est
        agreement[f"{algo}/{variant}"] = rel
        if algo != "lu":  # the paper's 16 golden programs gate CI
            max_rel_paper = max(max_rel_paper, rel)

    return {
        "topology": "Torus(16, 16)",
        "program": "summa/2d", "n": n, "p": p,
        "wall_s": wall,
        "events": int(res.events),
        "events_per_sec": res.events / wall,
        "sim_total_s": float(res.total),
        "est_cal_s": float(est_cal.total),
        "est_nocal_s": float(est_nocal.total),
        "sim_over_nocal": float(res.total / est_nocal.total),
        "critical_rank": res.critical_rank,
        "overlap_efficiency": res.overlap_efficiency,
        "link_utilization": res.utilization_histogram(),
        "trace": trace_path,
        "agreement_nocal": agreement,
        "max_rel_err_nocal": max_rel_paper,
    }


if __name__ == "__main__":
    print(json.dumps(main()))
