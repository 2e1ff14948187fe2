"""Paper Tables II-V on the port: prediction tables from the Hopper-fitted
models, validated against the published values + the qualitative claims
(ranking / 2.5D-overlap crossover), and the TPU-v5e adaptation tables (the
models' predictions for the v5e profile; no device runs them).

    python -m repro_torch.benchmarks.tables_2to5_predictions

Host-side model arithmetic in numpy.  The Hopper fit
(``core.calibration.hopper_fitted_ctx``) runs once, about two minutes, and
is cached in ``artifacts/hopper_joint.json``.
"""

import json


def main(ctx=None) -> dict:
    """``ctx``: the Hopper context to tabulate (default: the cached joint
    fit, ``hopper_fitted_ctx()``)."""
    from ..core import AlgoContext, CommModel, ComputeModel, TPU_V5E
    from ..core.algorithms import ALGOS
    from ..core.calibration import (hopper_fitted_ctx,
                                    joint_validation_report)
    from ..sim import derive_calibration, v5e_pod_topology
    from ..core.machine import HOPPER
    from ..core.paper_data import (CLAIMED_CROSSOVER, CORE_COUNTS,
                                   PAPER_TABLES, table_best_variant)
    from ..core.perfmodel import TPU_EFFICIENCY
    from ..core.predictor import best_variant, crossover_core_count, \
        prediction_table

    ctx = hopper_fitted_ctx() if ctx is None else ctx
    out = {"hopper": {}, "validation": {}, "claims": {}, "tpu_v5e": {}}

    # --- reproduce the tables ----------------------------------------------
    for algo in ALGOS:
        sizes = list(PAPER_TABLES[algo].keys())
        tbl = prediction_table(ctx, algo, sizes, CORE_COUNTS)
        out["hopper"][algo] = {
            str(n): {str(c): {v: round(p, 2) for v, p in row.items()}
                     for c, row in by.items()}
            for n, by in tbl.items()}

    # --- held-out accuracy ---------------------------------------------------
    out["validation"] = joint_validation_report(ctx)

    # --- qualitative claims ---------------------------------------------------
    # (1) ranking: does our best variant match the table's best per cell?
    match, total = 0, 0
    for algo in ALGOS:
        for size in PAPER_TABLES[algo]:
            for cores in CORE_COUNTS:
                p = cores // HOPPER.threads_per_unit
                ours = best_variant(ctx, algo, size, p)
                our_best = max(ours, key=lambda v: -ours[v].result.total)
                our_best = min(ours, key=lambda v: ours[v].result.total)
                total += 1
                match += (our_best == table_best_variant(algo, size, cores))
    out["claims"]["best_variant_agreement"] = match / total
    # (2) crossover: 2.5D+ovlp overtakes 2D+ovlp as cores grow
    for algo in ALGOS:
        size = max(PAPER_TABLES[algo].keys())
        cx = crossover_core_count(ctx, algo, size, CORE_COUNTS)
        out["claims"][f"crossover_{algo}"] = cx
        out["claims"][f"crossover_{algo}_expected"] = CLAIMED_CROSSOVER[algo]

    # --- TPU v5e adaptation: same methodology, v5e machine + simulator ------
    cal = derive_calibration(v5e_pod_topology(), ps=[16, 64, 256],
                             distances=[1, 2, 4, 8, 16])
    tpu_ctx = AlgoContext(CommModel(TPU_V5E, cal),
                          ComputeModel(TPU_V5E, TPU_EFFICIENCY))
    for algo in ALGOS:
        tbl = prediction_table(tpu_ctx, algo, [65536, 131072], [64, 256, 1024])
        out["tpu_v5e"][algo] = {
            str(n): {str(c): {v: round(p, 2) for v, p in row.items()}
                     for c, row in by.items()}
            for n, by in tbl.items()}
    return out


if __name__ == "__main__":
    print(json.dumps(main()))
