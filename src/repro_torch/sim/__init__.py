"""repro_torch.sim — per-rank discrete-event simulation of cost-IR programs on
explicit network topologies.

The closed-form evaluator (``repro_torch.perf.evaluate``) collapses network
contention into one calibrated scalar per phase; this package replays the
*same* IR programs rank-by-rank on a link-level topology model, so
contention emerges from where traffic actually collides:

  topology.py   Torus (k-ary n-cube, dimension-ordered routing) and the
                contention-free Crossbar baseline; CSR ``ShiftPlan``
                link-incidence arrays per shift pattern; ``topology_for``
                sizes (and memoizes) a torus for a machine
  fold.py       rank-symmetry folding: color refinement finds the
                coarsest equitable partition of a pattern, so one
                representative transfer per class is simulated with
                multiplicity-weighted link loads (exact; DESIGN.md §7)
  network.py    the fluid max-rate link engine: a transfer's rate is
                1 / (beta * max instantaneous load over its links);
                folded sparse event loop, plus the plain per-transfer
                loop as ``engine="reference"`` (the agreement oracle)
  executor.py   ``simulate_program``: walks an IR program per rank —
                collectives expand step-by-step, Overlap branches race,
                Loop/ramp forms unroll; ``simulate_programs`` batches
                scenarios over shared route/fold caches
  result.py     ``SimResult`` (per-rank phases, critical path, link
                utilization, overlap efficiency) + Chrome-trace emission
                under ``artifacts/traces_torch/``
  calibrate.py  ``derive_calibration``: C_avg / C_max tables from
                simulated link loads
  faults.py     declarative fault injection: ``FaultSpec`` bundles slow
                ranks (compute multipliers), degraded links (per-link
                beta multipliers) and dead links (reroute-or-
                unreachable), with optional onsets; applied inside
                ``Network``/``ProgramSimulator`` via ``faults=``

On a contention-free topology the simulated makespan equals the
closed-form ``est_NoCal`` estimate to float round-off (gated in CI); on a
torus it adds what the calibration factors only approximate — *where* the
contention happens and which rank carries the critical path.  The tuner
uses it as an opt-in second planning stage: ``Tuner.plan(...,
refine="sim")`` re-ranks the closed-form shortlist by simulated time.

The simulator is host-side planning arithmetic in numpy: nothing in it
touches a device, and its results equal the reference package's to
round-off.
"""

from .topology import Crossbar, ShiftPlan, Topology, Torus, topology_for
from .fold import Fold, build_fold, refine_partition, trivial_fold
from .faults import (DeadLink, DegradedLink, FaultSpec, FaultyTopology,
                     SlowRank, UnreachableError, torus_link)
from .network import LinkStats, Network, Transfer
from .executor import (MAX_UNROLL, ProgramSimulator, simulate_program,
                       simulate_programs)
from .result import RankPhase, SimResult, traces_dir
from .calibrate import (derive_calibration, hopper_like_topology,
                        shift_factors, v5e_pod_topology)

__all__ = [
    "Crossbar", "ShiftPlan", "Topology", "Torus", "topology_for",
    "Fold", "build_fold", "refine_partition", "trivial_fold",
    "DeadLink", "DegradedLink", "FaultSpec", "FaultyTopology",
    "SlowRank", "UnreachableError", "torus_link",
    "LinkStats", "Network", "Transfer",
    "MAX_UNROLL", "ProgramSimulator", "simulate_program",
    "simulate_programs",
    "RankPhase", "SimResult", "traces_dir",
    "derive_calibration", "hopper_like_topology", "shift_factors",
    "v5e_pod_topology",
]
