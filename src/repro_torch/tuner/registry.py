"""One query surface over every analytic performance model in the repo.

Before this module existed the model layers were islands: the 16
algorithm-variant models lived in ``core.algorithms.MODELS``, the collective
models were free functions in ``core.collectives``, and the machine /
calibration surfaces were assembled ad hoc at every call site
(``AlgoContext(CommModel(HOPPER, ...), ComputeModel(HOPPER, ...))``).  The
``PerfModelRegistry`` unifies them:

* **algorithm models** — ``(algo, variant) -> Program`` (cost-IR, see
  ``repro_torch.perf``) with registration, enumeration, scalar ``evaluate`` and
  vectorized ``evaluate_grid``; plain scalar ``ModelFn`` registration is
  kept as a legacy path;
* **collective models** — name -> analytic collective, so consumers (the
  tuner benchmark, the LM-step models) can enumerate and cross-check them;
* **machine surfaces** — machine constants + routine-efficiency curves +
  contention calibration bundled per machine name, with ``context()``
  building the ``AlgoContext`` every model evaluation needs.

``core.predictor`` sits on top of this registry (it no longer hard-codes
the ALGOS/VARIANTS tuples), and ``repro_torch.tuner.autotune`` uses it to plan
end-to-end execution.  ``DEFAULT_REGISTRY`` is pre-populated with
everything the repo ships; tests may build private registries.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

from ..core import algorithms as alg
from ..core import collectives as coll
from ..core.machine import (CPU_HOST, H100_SXM, HOPPER, MACHINES, TPU_V5E,
                            Machine)
from ..core.perfmodel import (Calibration, CommModel, ComputeModel,
                              EfficiencyCurve, HOPPER_EFFICIENCY,
                              ParametricCalibration, TPU_EFFICIENCY)
from ..perf import EvalOptions, EvalResult, Program, evaluate_program
from ..perf.models import PROGRAMS


@dataclasses.dataclass
class MachineSurface:
    """Everything needed to evaluate models for one machine: the constants,
    the local-routine efficiency curves (paper Fig. 1) and the contention
    calibration (paper Figs. 3-4).

    ``faults`` is an optional :class:`repro_torch.sim.faults.FaultSpec` (typed
    loosely to keep this module free of a sim import): a *degraded* surface
    emitted by diagnosis carries the localized fault here, and the tuner's
    sim-refined planning stage injects it into every candidate simulation.
    It deliberately lives outside :class:`~repro_torch.core.machine.Machine` —
    the machine fingerprint (and thus plan-cache keys) changes via the
    revision bump that accompanies every degraded-profile emission."""

    machine: Machine
    efficiency: Mapping[str, EfficiencyCurve]
    calibration: Calibration
    faults: Optional[object] = None

    def context(self, calibration: Optional[Calibration] = None) -> alg.AlgoContext:
        cal = calibration if calibration is not None else self.calibration
        return alg.AlgoContext(comm=CommModel(self.machine, cal),
                               comp=ComputeModel(self.machine, self.efficiency))


class PerfModelRegistry:
    """Unified registry of algorithm models, collective models and machine
    surfaces behind one query interface."""

    def __init__(self):
        self._algo_models: Dict[Tuple[str, str], alg.ModelFn] = {}
        self._programs: Dict[Tuple[str, str], Program] = {}
        self._collectives: Dict[str, Callable] = {}
        self._machines: Dict[str, MachineSurface] = {}

    # -- registration --------------------------------------------------------
    def register_algorithm(self, algo: str, variant: str, fn: alg.ModelFn,
                           *, overwrite: bool = False) -> None:
        """Register a plain scalar ModelFn (legacy path: no vectorized
        evaluation; batch consumers fall back to per-scenario calls).
        Prefer :meth:`register_program`."""
        key = (algo, variant)
        if key in self._algo_models and not overwrite:
            raise ValueError(f"model for {key} already registered")
        self._algo_models[key] = fn

    def register_program(self, program: Program,
                         *, overwrite: bool = False) -> None:
        """Register a cost-IR :class:`~repro_torch.perf.Program`: the model gains
        vectorized grid evaluation and a scalar shim in one step."""
        key = program.key
        if (key in self._algo_models or key in self._programs) \
                and not overwrite:
            raise ValueError(f"model for {key} already registered")
        self._programs[key] = program
        self._algo_models[key] = alg.scalar_shim(program)

    def register_collective(self, name: str, fn: Callable,
                            *, overwrite: bool = False) -> None:
        if name in self._collectives and not overwrite:
            raise ValueError(f"collective {name!r} already registered")
        self._collectives[name] = fn

    def register_machine(self, machine: Machine,
                         efficiency: Mapping[str, EfficiencyCurve],
                         calibration: Optional[Calibration] = None,
                         *, overwrite: bool = False,
                         faults=None) -> None:
        if machine.name in self._machines and not overwrite:
            raise ValueError(f"machine {machine.name!r} already registered")
        self._machines[machine.name] = MachineSurface(
            machine, efficiency, calibration or ParametricCalibration(),
            faults=faults)

    # -- queries -------------------------------------------------------------
    def algos(self) -> Tuple[str, ...]:
        return tuple(dict.fromkeys(a for a, _ in self._algo_models))

    def variants(self, algo: str) -> Tuple[str, ...]:
        out = tuple(v for a, v in self._algo_models if a == algo)
        if not out:
            raise KeyError(f"no models registered for algo {algo!r} "
                           f"(have: {self.algos()})")
        return out

    def model(self, algo: str, variant: str) -> alg.ModelFn:
        try:
            return self._algo_models[(algo, variant)]
        except KeyError:
            raise KeyError(f"no model for ({algo!r}, {variant!r}); "
                           f"registered: {sorted(self._algo_models)}") from None

    def has_program(self, algo: str, variant: str) -> bool:
        return (algo, variant) in self._programs

    def program(self, algo: str, variant: str) -> Program:
        try:
            return self._programs[(algo, variant)]
        except KeyError:
            raise KeyError(f"no cost-IR program for ({algo!r}, {variant!r}); "
                           f"registered: {sorted(self._programs)}") from None

    def collective(self, name: str) -> Callable:
        return self._collectives[name]

    def collectives(self) -> Tuple[str, ...]:
        return tuple(self._collectives)

    def machine(self, name: str) -> MachineSurface:
        try:
            return self._machines[name]
        except KeyError:
            raise KeyError(f"unknown machine {name!r}; registered: "
                           f"{sorted(self._machines)}") from None

    def machines(self) -> Tuple[str, ...]:
        return tuple(self._machines)

    def context(self, machine: str,
                calibration: Optional[Calibration] = None) -> alg.AlgoContext:
        return self.machine(machine).context(calibration)

    # -- evaluation ----------------------------------------------------------
    def evaluate(self, ctx: alg.AlgoContext, algo: str, variant: str,
                 n: int, p: int, c: int = 1, r: int = 1,
                 options: Optional[EvalOptions] = None) -> alg.ModelResult:
        fn = self.model(algo, variant)
        if options is not None:
            return fn(ctx, n, p, c=c, r=r, options=options)
        return fn(ctx, n, p, c=c, r=r)

    def evaluate_grid(self, ctx: alg.AlgoContext, algo: str, variant: str,
                      n, p, c=1, r=1,
                      options: Optional[EvalOptions] = None) -> EvalResult:
        """Vectorized evaluation over numpy arrays of scenarios — one pass
        for a whole ``(n, p, c, r)`` grid (arrays broadcast)."""
        return evaluate_program(self.program(algo, variant), ctx, n, p, c, r,
                                options=options)


def build_default_registry() -> PerfModelRegistry:
    """A fresh registry with everything the repo ships.  ``DEFAULT_REGISTRY``
    is one of these; telemetry tests build private copies so refits and
    drift-bumped machine revisions never leak across tests."""
    reg = PerfModelRegistry()
    for program in PROGRAMS.values():
        reg.register_program(program)
    for name in ("t_redsca_sync", "t_scatter_sync", "t_gather", "t_allgather",
                 "t_allgather_sync", "t_reduce", "t_bcast", "t_bcast_sync",
                 "t_inirepl", "t_ring_allgather", "t_ring_reducescatter",
                 "t_ring_allreduce", "t_all_to_all"):
        reg.register_collective(name, getattr(coll, name))
    # CPU host and H100 reuse the Hopper (Cray XE6) efficiency shapes until
    # measured curves are fitted by the calibration benchmarks.
    for machine, eff in ((HOPPER, HOPPER_EFFICIENCY),
                         (TPU_V5E, TPU_EFFICIENCY),
                         (CPU_HOST, HOPPER_EFFICIENCY),
                         (H100_SXM, HOPPER_EFFICIENCY)):
        reg.register_machine(machine, eff)
    return reg


DEFAULT_REGISTRY = build_default_registry()


#: machine chosen per device platform when the caller does not name one
PLATFORM_MACHINES = {
    "cpu": CPU_HOST.name,
    "tpu": TPU_V5E.name,
    "cuda": H100_SXM.name,
}


def machine_for_platform(platform: str) -> str:
    """Best-match registered machine for a device platform string."""
    return PLATFORM_MACHINES.get(platform, CPU_HOST.name)
