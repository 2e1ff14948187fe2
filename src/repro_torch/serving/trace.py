"""Synthetic request traces and cost-model-driven replay.

The paper evaluates its models by predicting whole runs before executing
them; the serving analog is *trace replay*: generate a request arrival
trace (skewed prompt/output length mixture over a Poisson arrival
process — the shape every serving benchmark uses), drive the scheduler's
full admission/compose/evict loop over a :class:`~.scheduler.SimBackend`
whose clock advances by the cost model's predicted step times, and
report the latency distribution each policy would deliver:

* **TTFT** — time to first token (arrival -> first sampled token),
* **TPOT** — time per output token after the first,
* **goodput** — requests meeting their TTFT/TPOT SLOs per second of
  makespan (the number a capacity planner actually buys hardware by).

Because replay is pure accounting, tens of thousands of requests run in
seconds on the CPU host — large enough for p99 tails to mean something —
and because both policies replay the *same* trace under the *same* cost
model, the comparison isolates scheduling policy from prediction error.
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.machine import CPU_HOST, Machine
from ..obs import MetricsRegistry
from .cost import ServeCostModel, cost_model_for
from .policy import make_policy
from .scheduler import (Request, Scheduler, SchedulerConfig, SimBackend,
                        StepReport)


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Knobs of the synthetic workload (defaults give the skewed mixture
    the model-guided policy is designed for: mostly short interactive
    prompts with a heavy tail of long documents)."""

    n_requests: int = 1000
    seed: int = 0
    arrival_rate: float = 8.0          # mean requests/second (Poisson)
    short_prompt: tuple = (16, 96)     # uniform range, the bulk
    long_prompt: tuple = (512, 1536)   # uniform range, the tail
    long_fraction: float = 0.1
    mean_output: int = 48              # geometric mean of output lengths
    max_output: int = 256
    eos_id: int = 1


def synthesize_trace(cfg: TraceConfig) -> List[Request]:
    """Deterministic (seeded) arrival trace of prompt-only requests."""
    rng = random.Random(cfg.seed)
    out: List[Request] = []
    t = 0.0
    for i in range(cfg.n_requests):
        t += rng.expovariate(cfg.arrival_rate)
        lo, hi = (cfg.long_prompt if rng.random() < cfg.long_fraction
                  else cfg.short_prompt)
        prompt_len = rng.randint(lo, hi)
        n_out = min(1 + int(rng.expovariate(1.0 / cfg.mean_output)),
                    cfg.max_output)
        out.append(Request(
            rid=f"r{i:06d}", prompt_len=prompt_len, arrival_s=t,
            max_new_tokens=n_out, output_len=n_out, eos_id=cfg.eos_id))
    return out


def _percentile(xs: Sequence[float], q: float) -> float:
    """Nearest-rank percentile; 0 for an empty sample."""
    if not xs:
        return 0.0
    s = sorted(xs)
    k = min(len(s) - 1, max(0, int(round(q / 100.0 * (len(s) - 1)))))
    return float(s[k])


@dataclasses.dataclass
class ReplayReport:
    policy: str
    n_requests: int
    n_finished: int
    makespan_s: float
    steps: int
    tokens_out: int
    ttft_p50_s: float
    ttft_p95_s: float
    ttft_p99_s: float
    tpot_p50_s: float
    tpot_p95_s: float
    goodput_rps: float                 # SLO-met requests / makespan
    throughput_tok_s: float
    slo_met_fraction: float
    ttft_slo_s: float
    tpot_slo_s: float
    n_shed: int = 0                    # load-shed before ever running
    n_deadline_missed: int = 0         # dropped/evicted past deadline

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def replay_traced(trace: Sequence[Request], cost: ServeCostModel, *,
                  policy: str = "fifo",
                  scheduler_cfg: Optional[SchedulerConfig] = None,
                  step_budget_s: Optional[float] = None,
                  ttft_slo_s: Optional[float] = None,
                  tpot_slo_s: Optional[float] = None,
                  max_steps: Optional[int] = None,
                  metrics: Optional[MetricsRegistry] = None,
                  slo_watcher=None, degrade: bool = False,
                  ) -> Tuple[ReplayReport, List[StepReport],
                             MetricsRegistry]:
    """:func:`replay`, returning also the per-step reports and the
    metrics registry the run was accounted through — the inputs
    ``obs.serving_trace`` / ``obs.summary`` want.

    SLO defaults are derived from the cost model so they track the
    machine: TTFT SLO = predicted whole-prefill time of a tail-length
    prompt plus slack; TPOT SLO = 6x a lightly-batched decode step.
    They are resolved *before* the run so the scheduler streams the
    SLO-met accounting into the registry as requests finish."""
    if ttft_slo_s is None:
        tail = max((r.prompt_len for r in trace), default=256)
        ttft_slo_s = 2.0 * cost.request_prefill_cost(tail) + 0.5
    if tpot_slo_s is None:
        # tolerate budget-bounded interleaving (a decode stream's token
        # time is the whole step it rides in), punish whole-prompt stalls
        tpot_slo_s = 6.0 * cost.decode_step([256] * 8).decode_s
    reg = metrics if metrics is not None else MetricsRegistry()
    pol = make_policy(policy, step_budget_s=step_budget_s)
    degradation = None
    if degrade:
        # graceful degradation needs a burn-rate signal; build a watcher
        # when the caller did not bring one
        if slo_watcher is None:
            from ..obs.watch.slo import SLOWatcher
            slo_watcher = SLOWatcher()
        from .policy import DegradationController
        degradation = DegradationController(pol)
    sched = Scheduler(SimBackend(), cost,
                      scheduler_cfg or SchedulerConfig(), policy=pol,
                      metrics=reg, ttft_slo_s=ttft_slo_s,
                      tpot_slo_s=tpot_slo_s, slo_watcher=slo_watcher,
                      degradation=degradation)
    for req in trace:
        sched.submit(dataclasses.replace(req))
    reports = sched.run(max_steps=max_steps)

    # the report is read *from the registry* — the same counters and
    # keep_values histograms the obs summary exposes, so the two cannot
    # disagree
    name = pol.name
    ttft_h = reg.histogram("serve_ttft_s", keep_values=True, policy=name)
    tpot_h = reg.histogram("serve_tpot_s", keep_values=True, policy=name)
    n_finished = int(reg.counter("serve_finished_total", policy=name).value)
    tokens_out = int(reg.counter("serve_tokens_out_total", policy=name).value)
    met = int(reg.counter("serve_slo_met_total", policy=name).value)
    last = reg.gauge("serve_last_finish_s", policy=name)
    makespan = last.max_value if last.max_value > -math.inf else 0.0
    rep = ReplayReport(
        policy=name, n_requests=len(trace), n_finished=n_finished,
        makespan_s=makespan, steps=len(reports), tokens_out=tokens_out,
        # empty-histogram percentiles are None (no requests finished);
        # the report's float fields keep the historical 0.0 convention
        ttft_p50_s=ttft_h.percentile(50) or 0.0,
        ttft_p95_s=ttft_h.percentile(95) or 0.0,
        ttft_p99_s=ttft_h.percentile(99) or 0.0,
        tpot_p50_s=tpot_h.percentile(50) or 0.0,
        tpot_p95_s=tpot_h.percentile(95) or 0.0,
        goodput_rps=met / makespan if makespan > 0 else 0.0,
        throughput_tok_s=tokens_out / makespan if makespan > 0 else 0.0,
        slo_met_fraction=met / n_finished if n_finished else 0.0,
        ttft_slo_s=ttft_slo_s, tpot_slo_s=tpot_slo_s,
        n_shed=int(reg.counter("serve_shed_total", policy=name).value),
        n_deadline_missed=int(
            reg.counter("serve_deadline_missed_total", policy=name).value))
    return rep, reports, reg


def replay(trace: Sequence[Request], cost: ServeCostModel,
           **kwargs) -> ReplayReport:
    """Replay ``trace`` under ``policy`` on a simulated clock; see
    :func:`replay_traced` (this is its report-only form)."""
    return replay_traced(trace, cost, **kwargs)[0]


def compare_policies(trace: Sequence[Request], cost: ServeCostModel, *,
                     policies: Sequence[str] = ("fifo", "model"),
                     scheduler_cfg: Optional[SchedulerConfig] = None,
                     step_budget_s: Optional[float] = None,
                     **slo) -> Dict[str, ReplayReport]:
    """Replay the same trace under each policy; same cost model, same
    SLOs (pinned from the first replay so the comparison is fair)."""
    out: Dict[str, ReplayReport] = {}
    for name in policies:
        rep = replay(trace, cost, policy=name,
                     scheduler_cfg=scheduler_cfg,
                     step_budget_s=step_budget_s, **slo)
        out[name] = rep
        slo.setdefault("ttft_slo_s", rep.ttft_slo_s)
        slo.setdefault("tpot_slo_s", rep.tpot_slo_s)
    return out


def replay_for(cfg_model, *, machine: Machine = CPU_HOST,
               trace_cfg: Optional[TraceConfig] = None,
               **kwargs) -> Dict[str, ReplayReport]:
    """One-call comparison: synthesize a trace for ``cfg_model`` on
    ``machine`` and replay it under every policy."""
    cost = cost_model_for(cfg_model, machine)
    trace = synthesize_trace(trace_cfg or TraceConfig())
    return compare_policies(trace, cost, **kwargs)
