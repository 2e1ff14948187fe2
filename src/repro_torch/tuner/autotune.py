"""The model-guided autotuner: plans end-to-end execution from the models.

``Tuner.plan(op, n, devices=...)`` answers "how should this operation run
on this device pool?" by

1. enumerating the process-grid configurations the pool can actually
   realize (2D ``g x g`` grids and 2.5D ``c x g x g`` grids — the
   executable 2.5D matmuls need ``c | g``, and replication is capped at
   ``c <= g`` so every layer owns work);
2. evaluating every candidate (algo, variant, c) through the registry's
   analytic models via ``core.predictor`` — the paper's §VI selection,
   restricted to realizable configurations;
3. freezing the argmin into an :class:`ExecutionPlan` and persisting it in
   the plan cache, so the next call with the same (machine fingerprint,
   op, n, p, dtype) never touches the models again.

``plan(..., refine="sim")`` inserts an opt-in second stage between 2 and
3: the closed-form evaluator shortlists the top-k grids, then the
per-rank discrete-event simulator (``repro_torch.sim``) replays each
candidate on the machine's topology and the argmin is taken over
*simulated* makespans (DESIGN.md §4.4).

The same Tuner also serves the LM layers: ``recommend_fsdp`` consults the
LM-step model for the parameter-sharding layout choice, and
``prefill_chunk`` / ``serve_chunk`` size the serving engine's chunked
prefill.  Devices are ``torch.device`` objects: the platform is the device
type (``"cuda"`` / ``"cpu"``) and the device kind is the card's name.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core import predictor
from ..core.algorithms import result_from_eval
from ..devices import default_devices, device_kind_of
from ..perf.kernel import tiles_for_plan
from .plan import (ExecutionPlan, PlanCache, machine_fingerprint, plan_key)
from .registry import DEFAULT_REGISTRY, PerfModelRegistry, machine_for_platform

#: public operation -> candidate algorithm models (matmul races Cannon
#: against SUMMA; the factorizations map one-to-one).  "lu" plans through
#: the models only (no executable dispatch yet).
OP_ALGOS: Dict[str, Tuple[str, ...]] = {
    "matmul": ("cannon", "summa"),
    "cannon": ("cannon",),
    "summa": ("summa",),
    "trsm": ("trsm",),
    "cholesky": ("cholesky",),
    "lu": ("lu",),
}


def feasible_grids(device_count: int, algo: str) -> List[Tuple[int, int, int]]:
    """Realizable (p, c, g) grid configurations for a device pool.

    2D: the largest square ``g*g <= device_count`` (one entry).
    2.5D: every power-of-two ``c`` with ``c * g*g <= device_count``,
    ``c <= g`` (each layer must own columns / steps), and — for the
    shift/broadcast matmuls — ``c | g`` (each layer executes a contiguous
    chunk of ``g/c`` steps).
    """
    out: List[Tuple[int, int, int]] = []
    g2 = int(math.isqrt(device_count))
    if g2 >= 1:
        out.append((g2 * g2, 1, g2))
    c = 2
    while c * c * c <= device_count:  # c <= g implies c^3 <= c*g*g <= D
        g = int(math.isqrt(device_count // c))
        while g >= c:
            if algo in ("cannon", "summa") and g % c != 0:
                g -= 1
                continue
            out.append((c * g * g, c, g))
            break
        c *= 2
    return out


class Tuner:
    """Registry + plan cache + selection policy, behind one object."""

    def __init__(self, registry: Optional[PerfModelRegistry] = None,
                 cache: Optional[PlanCache] = None,
                 plan_dir: Optional[str] = None,
                 store=None):
        self.registry = registry or DEFAULT_REGISTRY
        self.cache = cache or PlanCache(plan_dir)
        self.store = store      # telemetry RunStore for observe=True records
        self.stats = {"model_evals": 0, "cache_hits": 0}
        self._lock = threading.Lock()
        self._lm_cal = None

    # -- linalg planning -----------------------------------------------------
    def plan(self, op: str, n: int, *,
             devices: Optional[Sequence] = None,
             device_count: Optional[int] = None,
             platform: Optional[str] = None,
             device_kind: Optional[str] = None,
             dtype: str = "float32",
             machine: Optional[str] = None,
             local_kernel: Optional[str] = None,
             use_cache: bool = True,
             refine: Optional[str] = None,
             shortlist: int = 4,
             observe: bool = False) -> ExecutionPlan:
        """Resolve (or recall) the best execution plan for ``op`` at size
        ``n`` on the given device pool.

        Pass real ``devices`` (``torch.device`` objects; one per rank,
        repeats allowed) for dispatch, or ``device_count``/``platform``
        alone to ask hypothetical questions ("what would 4096 Hopper
        processes run?") without touching device state.

        ``refine="sim"`` adds the opt-in second planning stage: the
        vectorized closed-form evaluator shortlists the ``shortlist`` best
        grids, then the per-rank discrete-event simulator
        (``repro_torch.sim``) replays each on the machine's topology and
        the plan is re-ranked by *simulated* time
        (``predicted["sim_total"]``).  When no shortlisted candidate can be
        simulated (every one unreachable under dead links), the closed-form
        argmin stands, without a ``sim_total``.  Refined plans cache under
        their own key, so closed-form plans are never shadowed.  A surface
        that carries a diagnosed fault always plans this way.

        ``observe=True`` records the planning decision (chosen variant +
        predicted timing) into the telemetry run store, so the measured
        feedback loop can later compare what the model promised with what
        dispatch delivered — it records regardless of the global
        ``REPRO_TELEMETRY`` switch (an explicit per-call opt-in).
        """
        if refine not in (None, "sim"):
            raise ValueError(f"refine must be None or 'sim', got {refine!r}")
        if devices is not None:
            devices = list(devices)
            device_count = len(devices)
            platform = platform or devices[0].type
            device_kind = device_kind or device_kind_of(devices[0])
        if device_count is None:
            devices = default_devices()
            device_count = len(devices)
            platform = platform or devices[0].type
            device_kind = device_kind or device_kind_of(devices[0])
        platform = platform or "cpu"
        device_kind = device_kind or platform
        machine = machine or machine_for_platform(platform)
        # A degraded surface (diagnosis attached a FaultSpec) demands the
        # simulator: only the per-rank engine sees link granularity, so
        # closed-form-only planning would ignore the fault entirely.
        try:
            _surface = self.registry.machine(machine)
        except KeyError:
            _surface = None
        if refine is None and _surface is not None \
                and getattr(_surface, "faults", None) is not None:
            refine = "sim"
        if local_kernel not in (None, "pallas", "jnp"):
            raise ValueError(f"local_kernel must be 'pallas' or 'jnp', "
                             f"got {local_kernel!r}")
        # "pallas" names the hand-written CUDA kernels (their plain versions
        # on CPU tensors), "jnp" the torch.matmul / torch.linalg locals: the
        # reference's plan strings, kept for plan-format compatibility
        local_kernel = local_kernel or ("pallas" if platform == "cuda"
                                        else "jnp")

        # Key plans by the registered Machine *profile* (its fingerprint
        # hashes every field, incl. the telemetry-bumped revision), not the
        # bare name — refits and drift invalidation change the key.
        try:
            profile = self.registry.machine(machine).machine
        except KeyError:
            profile = machine
        fp = machine_fingerprint(profile, platform, device_kind, device_count)
        # refine and shortlist both shape the refined decision, so they are
        # part of the cache identity (closed-form plans keep their old keys)
        key = plan_key(fp, op if refine is None
                       else f"{op}@{refine}{int(shortlist)}",
                       n, device_count, dtype)
        if use_cache:
            hit = self.cache.get(key)
            if hit is not None:
                try:
                    plan = ExecutionPlan.from_dict(hit)
                except (ValueError, TypeError):
                    self.cache.invalidate(key)
                else:
                    with self._lock:
                        self.stats["cache_hits"] += 1
                    if plan.local_kernel != local_kernel:
                        # kernel choice is an execution detail, not a model
                        # decision — honor the caller without re-planning
                        import dataclasses
                        plan = dataclasses.replace(plan,
                                                   local_kernel=local_kernel)
                    if observe:
                        self._observe(plan)
                    return plan

        plan = self._build_plan(op, n, device_count, machine, dtype,
                                local_kernel, fp, refine=refine,
                                shortlist=shortlist)
        with self._lock:
            self.stats["model_evals"] += 1
        if use_cache:
            self.cache.put(key, plan.to_dict())
        if observe:
            self._observe(plan)
        return plan

    def _observe(self, plan: ExecutionPlan) -> None:
        from ..telemetry import observe_plan
        observe_plan(plan, store=self.store)
        with self._lock:
            self.stats["observed"] = self.stats.get("observed", 0) + 1

    def _build_plan(self, op: str, n: int, device_count: int, machine: str,
                    dtype: str, local_kernel: str, fp: str,
                    refine: Optional[str] = None,
                    shortlist: int = 4) -> ExecutionPlan:
        try:
            algos = OP_ALGOS[op]
        except KeyError:
            raise ValueError(f"unknown op {op!r}; known: {sorted(OP_ALGOS)}") \
                from None
        ctx = self.registry.context(machine)
        # Enumerate every realizable (algo, variant, p, c, g) candidate in
        # selection-priority order, then score them with ONE vectorized
        # model evaluation per (algo, variant) instead of a scalar
        # predictor.select call per grid (the executables use r=1).
        cands: List[Tuple[str, str, int, int, int]] = []
        for algo in algos:
            all_variants = self.registry.variants(algo)
            for p, c, g in feasible_grids(device_count, algo):
                kind = "2d" if c == 1 else "2.5d"
                for variant in all_variants:
                    if not variant.startswith(kind):
                        continue
                    if variant.startswith("2.5d") and \
                            not predictor.fits_memory(ctx, algo, n, p, c):
                        continue  # replication at this c exceeds memory
                    cands.append((algo, variant, p, c, g))
        if not cands:
            raise ValueError(f"no feasible grid for {device_count} devices")
        totals = np.empty(len(cands))
        evals: Dict[Tuple[str, str], tuple] = {}
        groups: Dict[Tuple[str, str], List[int]] = {}
        for j, (algo, variant, p, c, g) in enumerate(cands):
            groups.setdefault((algo, variant), []).append(j)
        for (algo, variant), idx in groups.items():
            ps = np.array([cands[j][2] for j in idx], dtype=float)
            cs = np.array([cands[j][3] for j in idx], dtype=float)
            if self.registry.has_program(algo, variant):
                res = self.registry.evaluate_grid(ctx, algo, variant,
                                                  float(n), ps, cs, 1.0)
                evals[(algo, variant)] = (res, idx)
                totals[idx] = res.total
            else:  # legacy scalar ModelFn without a program
                for j in idx:
                    totals[j] = self.registry.evaluate(
                        ctx, algo, variant, n, cands[j][2], c=cands[j][3]).total
        sim_extra: Optional[Dict[str, float]] = None
        if refine == "sim":
            j, sim_extra = self._sim_rerank(cands, totals, machine, n,
                                            shortlist, device_count)
        else:
            j = int(np.argmin(totals))
        algo, variant, p, c, g = cands[j]
        ev = evals.get((algo, variant))
        if ev is not None:
            res = result_from_eval(self.registry.program(algo, variant),
                                   ev[0], n, p, c, 1, idx=ev[1].index(j))
        else:
            res = self.registry.evaluate(ctx, algo, variant, n, p, c=c)
        predicted = {"total": res.total, "comm": res.comm, "comp": res.comp,
                     "pct_peak": predictor.pct_of_peak(ctx, res)}
        if sim_extra is not None:
            predicted.update(sim_extra)
        # the intra-kernel tier: per-family tile plans for the local
        # kernels this algo will run — model-chosen when the machine profile
        # has kernel constants, today's heuristic blocks otherwise
        try:
            profile = self.registry.machine(machine).machine
        except KeyError:
            profile = None
        tiles = tiles_for_plan(profile, algo, n, g, dtype)
        return ExecutionPlan(
            algo=algo, variant=res.variant, n=n, p=p, c=c, r=res.r, g=g,
            local_kernel=local_kernel, dtype=dtype, machine=machine,
            fingerprint=fp, predicted=predicted, tiles=tiles)

    def _sim_rerank(self, cands, totals, machine: str, n: int,
                    shortlist: int, device_count: Optional[int] = None
                    ) -> Tuple[int, Dict[str, float]]:
        """The opt-in second planning stage: replay the closed-form top-k
        candidates through the per-rank discrete-event simulator on the
        machine's topology and pick the one with the smallest *simulated*
        makespan.  The whole shortlist goes through one
        ``simulate_programs`` batch so candidates at the same ``p`` share
        route/fold caches.  Returns (winning candidate index,
        predicted-dict extras).

        When the surface carries a diagnosed :class:`FaultSpec`, every
        candidate simulates on ONE topology — the full device pool's —
        so the fault's physical link ids mean the same thing for every
        grid (candidates use different ``p``), the fault is injected into
        each run, and a candidate rendered unreachable by dead links is
        skipped rather than sinking the batch."""
        from ..sim import simulate_programs, topology_for
        surface = self.registry.machine(machine)
        ctx = surface.context()
        faults = getattr(surface, "faults", None)
        topo = None
        if faults is not None and device_count is not None:
            topo = topology_for(surface.machine, device_count)
        order = np.argsort(totals)[:max(1, int(shortlist))]
        picked = [int(j) for j in order
                  if self.registry.has_program(*cands[int(j)][:2])]
        # legacy scalar models cannot be simulated; they drop out here
        programs = [self.registry.program(*cands[j][:2]) for j in picked]
        scens = [{"n": float(n), "p": cands[j][2], "c": cands[j][3], "r": 1}
                 for j in picked]
        sims = simulate_programs(programs, ctx, scens,
                                 machine=surface.machine, topology=topo,
                                 faults=faults, strict=(faults is None))
        with self._lock:
            self.stats["sim_evals"] = self.stats.get("sim_evals", 0) \
                + len(sims)
        best_j, best_t = int(order[0]), float("inf")
        extras: Dict[str, float] = {}
        for j, sim in zip(picked, sims):
            if sim is None:
                continue  # e.g. unreachable under dead links
            algo, variant, p, c, _g = cands[j]
            extras[f"sim/{algo}/{variant}@p{p}c{c}"] = float(sim.total)
            if sim.total < best_t:
                best_j, best_t = j, float(sim.total)
        if np.isfinite(best_t):
            extras["sim_total"] = best_t
        # else no candidate could be simulated: the closed-form argmin
        # stands, without a sim_total, as in the reference
        return best_j, extras

    # -- LM-layer consultation ----------------------------------------------
    def _lm_calibration_table(self):
        with self._lock:
            cal = self._lm_cal
        if cal is None:
            # build outside the lock: the simulator run is slow and the lock
            # also serializes every plan() stats update
            from ..sim import derive_calibration, v5e_pod_topology
            cal = derive_calibration(v5e_pod_topology(),
                                     ps=[16, 64, 256], distances=[1, 2, 4, 8])
            with self._lock:
                if self._lm_cal is None:
                    self._lm_cal = cal
                cal = self._lm_cal
        return cal

    def recommend_fsdp(self, cfg, shape, mesh_shape: Dict[str, int], *,
                       required: bool = False) -> bool:
        """Parameter-sharding layout choice for a train step: FSDP when the
        memory constraint requires it, else when the LM-step model predicts
        the per-layer all-gathers pay for themselves.  Cached per
        (model, shape, mesh) like any other plan."""
        if required:
            return True
        chips = 1
        for v in mesh_shape.values():
            chips *= int(v)
        name = getattr(cfg, "name", type(cfg).__name__)
        # the parameter count disambiguates same-named configs (reduced()
        # smoke-test shrinks keep the production name)
        params = int(getattr(cfg, "param_count", lambda: 0)())
        fp = machine_fingerprint("tpu-v5e", "plan", "lm", chips)
        mesh_tag = "x".join(f"{k}{v}" for k, v in sorted(mesh_shape.items()))
        key = plan_key(
            fp, f"fsdp-{name}-np{params}-b{shape.global_batch}-{mesh_tag}",
            shape.seq_len, chips, "bf16")
        hit = self.cache.get(key)
        if hit is not None and "fsdp" in hit:
            with self._lock:
                self.stats["cache_hits"] += 1
            return bool(hit["fsdp"])
        from ..core.lm_model import predict_train_step
        cal = self._lm_calibration_table()
        plain = predict_train_step(cfg, shape, mesh_shape, calibration=cal,
                                   fsdp=False)
        fsdp = predict_train_step(cfg, shape, mesh_shape, calibration=cal,
                                  fsdp=True)
        with self._lock:
            self.stats["model_evals"] += 1
        wants = fsdp.total_overlapped < plain.total_overlapped
        self.cache.put(key, {"fsdp": bool(wants),
                             "predicted_plain_s": plain.total_overlapped,
                             "predicted_fsdp_s": fsdp.total_overlapped})
        return wants

    def prefill_chunk(self, seq_len: int, *, max_chunk: int = 128) -> int:
        """Chunk size for the serving engine's prefill: the largest power of
        two that amortizes per-call dispatch overhead without exploding
        compile-shape count (two shapes total: the chunk and the 1-token
        remainder step).  Below 8 tokens chunking cannot win."""
        if seq_len < 8:
            return 1
        chunk = 1
        while chunk * 2 <= min(seq_len, max_chunk):
            chunk *= 2
        return chunk

    def serve_chunk(self, remaining: int, *, ctx0: int, cost, budget_s: float,
                    granularity: int = 8, base_prefill=(),
                    base_prefill_s: Optional[float] = None) -> int:
        """Prefill chunk sizing for the serving scheduler's batch mix: the
        largest token count (a multiple of ``granularity``, so the engine
        keeps its two compiled shapes) whose *marginal* predicted prefill
        time — on top of the chunks already packed into this step
        (``base_prefill``) — fits ``budget_s``.  Returns 0 when even one
        granularity chunk cannot fit; the policy decides whether to force
        progress anyway."""
        if remaining <= 0 or budget_s <= 0:
            return 0
        g = max(1, int(granularity))
        base = list(base_prefill)
        base_s = base_prefill_s if base_prefill_s is not None else (
            cost.prefill_step(base).prefill_s if base else 0.0)
        n = int(remaining)
        while n > 0:
            marginal = cost.prefill_step(base + [(n, ctx0)]).prefill_s - base_s
            if marginal <= budget_s:
                return n
            n = (n // 2) // g * g if n > g else 0
        return 0


_DEFAULT: Optional[Tuner] = None
_DEFAULT_LOCK = threading.Lock()


def default_tuner() -> Tuner:
    """Process-wide Tuner over the default registry and plan directory."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = Tuner()
        return _DEFAULT
