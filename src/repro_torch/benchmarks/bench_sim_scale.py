"""Paper-scale simulator benchmark: the folded sparse engine vs the
original per-transfer event loop (pure numpy; no device needed).

Emitted as ``artifacts/bench_torch/BENCH_sim_scale.json``:

* ``events_per_sec_p256`` — the SUMMA 2D replay on a warm 16x16 torus
  (the BENCH_sim workload), CI-gated at >= 10x the baseline
  throughput the original engine recorded.  Two caveats make this
  a trajectory number, not a pure engine-speed ratio: the vector engine
  counts two logical endpoints per message (including messages simulated
  by a folded representative) where the original contended loop counted one
  per event-loop iteration (~4x fewer on this replay), and the baseline
  number included its own cold-route-construction warm-up bug;
* ``speedup_vs_reference_p256`` — wall-clock of the identical warm replay
  through ``engine="reference"`` divided by the folded engine's wall:
  the honest same-machine, same-workload engine comparison (gated >= 1,
  so an engine-speed regression cannot hide behind the event counter);
* ``wall_p4096_s`` / ``wall_p24576_s`` — SUMMA 2.5D at the paper's
  validation scales: 4096 ranks on a 16^3 torus and 24,576 ranks on a
  (24, 32, 32) torus (exactly one rank per node, the shape symmetry
  folding wants).  The 24,576 cold wall — route construction, symmetry
  detection and simulation from scratch — is the paper-scale acceptance
  gate (< 30 s CPU);
* ``max_rel_err_vs_reference`` — the folded engine (and its ``fold=False``
  sparse fallback) against the reference engine across every registered
  program on both a torus and a crossbar, gated at 1e-6 relative.
"""

import json
import time

#: events/sec of the original engine on the p=256 SUMMA replay as recorded by
#: its own BENCH_sim.json (cold-construction bug and all) — the baseline
#: the >= 10x throughput gate multiplies.
BASELINE_EVENTS_PER_SEC = 360_000.0


def main() -> dict:
    from ..perf import PROGRAMS
    from ..sim import Crossbar, Torus, simulate_program
    from ..tuner import DEFAULT_REGISTRY

    ctx = DEFAULT_REGISTRY.context("hopper-cray-xe6")

    # --- p=256 throughput: folded engine vs reference on warm caches -------
    prog2d = PROGRAMS[("summa", "2d")]
    n256, p256 = 65536.0, 256

    def timed(topology, repeats: int = 5, **kw):
        """Best-of-N timing: the replay is ~ms-scale, so a single run is
        at the mercy of scheduler noise on shared CI runners."""
        simulate_program(prog2d, ctx, topology, n256, p256, **kw)  # warm
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            res = simulate_program(prog2d, ctx, topology, n256, p256, **kw)
            best = min(best, time.perf_counter() - t0)
        return res, best

    res_v, wall_v = timed(Torus((16, 16)))
    res_r, wall_r = timed(Torus((16, 16)), engine="reference")

    # --- paper scale: SUMMA 2.5D at 4096 and 24,576 ranks ------------------
    prog25d = PROGRAMS[("summa", "2.5d")]
    t0 = time.perf_counter()
    res_4k = simulate_program(prog25d, ctx, Torus((16, 16, 16)),
                              262144.0, 4096, 4)
    wall_4k = time.perf_counter() - t0
    topo_24k = Torus((24, 32, 32))  # 24,576 nodes: one per rank
    t0 = time.perf_counter()
    res_24k = simulate_program(prog25d, ctx, topo_24k, 786432.0, 24576, 6)
    wall_24k = time.perf_counter() - t0
    t0 = time.perf_counter()
    simulate_program(prog25d, ctx, topo_24k, 786432.0, 24576, 6)
    wall_24k_warm = time.perf_counter() - t0

    # --- agreement: folded + unfolded engines vs the reference engine ------
    max_rel = 0.0
    per_program = {}
    for (algo, variant), program in sorted(PROGRAMS.items()):
        c = 2 if program.uses_c else 1
        r = 2 if program.uses_r else 1
        worst = 0.0
        for topo in (Torus((4, 4)), Crossbar(16)):
            ref = simulate_program(program, ctx, topo, 8192.0, 16, c, r,
                                   engine="reference")
            for kw in ({}, {"fold": False}):
                got = simulate_program(program, ctx, topo, 8192.0, 16, c, r,
                                       **kw)
                worst = max(worst, abs(got.total - ref.total) / ref.total)
        max_rel = max(max_rel, worst)
        per_program[f"{algo}/{variant}"] = worst
    # the flagship workload at pod scale too
    rel256 = abs(res_v.total - res_r.total) / res_r.total
    max_rel = max(max_rel, rel256)

    return {
        "p256": {
            "program": "summa/2d", "topology": "Torus(16, 16)",
            "n": n256, "p": p256,
            "wall_vector_s": wall_v, "wall_reference_s": wall_r,
            "events": int(res_v.events),
        },
        "events_per_sec_p256": res_v.events / wall_v,
        "pr3_baseline_events_per_sec": BASELINE_EVENTS_PER_SEC,
        "throughput_vs_pr3_baseline":
            (res_v.events / wall_v) / BASELINE_EVENTS_PER_SEC,
        "events_metric_note":
            "events = 2 logical endpoints per message (incl. folded / "
            "fast-forwarded); the baseline counted event-loop "
            "iterations and charged cold route construction — "
            "speedup_vs_reference_p256 is the engine-speed comparison",
        "speedup_vs_reference_p256": wall_r / wall_v,
        "wall_p4096_s": wall_4k,
        "sim_total_p4096_s": float(res_4k.total),
        "wall_p24576_s": wall_24k,
        "wall_p24576_warm_s": wall_24k_warm,
        "sim_total_p24576_s": float(res_24k.total),
        "events_p24576": int(res_24k.events),
        "events_per_sec_p24576": res_24k.events / wall_24k,
        "max_rel_err_vs_reference": max_rel,
        "agreement_vs_reference": per_program,
    }


if __name__ == "__main__":
    print(json.dumps(main()))
