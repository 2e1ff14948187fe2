"""Continuous-batching request scheduler driven by the serving cost model.

The scheduler owns the request lifecycle (rtp-llm's FIFOScheduler shape):
an admission queue gated by KV block capacity (:mod:`.kvblocks`), an
active set stepped by a batch-composition policy (:mod:`.policy`), and
per-step join/evict — new requests join the running batch between steps,
finished requests (EOS / stop token / max-tokens) are evicted and their
blocks freed immediately.  A step is a prefill micro-batch of chunked
prompt slices interleaved with one batched decode over every live stream.

Execution is pluggable:

* :class:`ModelBackend` runs the model's ``decode_step`` — each request
  owns its caches (so join/evict never perturbs another stream's state),
  its prefill runs alone, and the decode batch is one step over the
  requests' caches stacked along the batch dim, split back afterwards.
  Each row keeps its own length, so a request's tokens do not depend on
  the batch it is served in.
* :class:`SimBackend` advances a virtual clock by the cost model's
  predicted step times instead of executing — the trace-replay harness
  (:mod:`.trace`) schedules tens of thousands of requests this way.

With telemetry on, every real step emits a ``kind="serve_step"`` record
carrying measured prefill/decode phases *and* the prediction it was
scheduled under, so the telemetry residual/refit/drift loop covers the
scheduler path: ``telemetry.residuals.join`` self-joins these records,
``cost.refit_serving`` recalibrates the scales, and a drift-bumped
machine revision re-keys the cost table cache.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .cost import ServeCostModel, ServeStepCost, cost_model_for
from .kvblocks import BlockManager, blocks_for
from .policy import FIFOPolicy, Policy, StepPlan, make_policy
from .. import obs


def token_int(tok) -> int:
    """A generated token as a Python int, whether the backend produced a
    plain int (simulation) or a (1, 1) tensor (real decode)."""
    if isinstance(tok, int):
        return tok
    return int(tok.reshape(-1)[0].item())


@dataclasses.dataclass
class Request:
    """One submission.  ``prompt`` is a (1, S) int32 array for real
    execution, or None for cost-model-driven simulation (then
    ``prompt_len`` stands alone).  ``max_new_tokens`` bounds generation;
    EOS/stop tokens end it early."""

    rid: str
    prompt: Optional[Any] = None
    prompt_len: int = 0
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    stop_ids: Tuple[int, ...] = ()
    arrival_s: Optional[float] = None      # None: "now" (scheduler clock)
    memory: Optional[Any] = None           # cross-attention row (1, M, D)
    temperature: float = 0.0
    seed: int = 0
    output_len: Optional[int] = None       # sim: tokens until synthetic EOS
    deadline_s: Optional[float] = None     # seconds after arrival; expired
    #                                        requests are evicted, not served

    def __post_init__(self):
        if self.prompt is not None and not self.prompt_len:
            self.prompt_len = int(self.prompt.shape[-1])


class RequestState:
    """Scheduler-internal view of one request's progress."""

    def __init__(self, req: Request, token_budget: int):
        self.req = req
        self.token_budget = token_budget   # KV slots reserved at admission
        self.prefill_pos = 0
        self.out: List[Any] = []           # generated tokens (ints or 0-d arrays)
        self.admitted_s: float = float("nan")
        self.first_token_s: Optional[float] = None
        self.finish_s: Optional[float] = None
        self.finish_reason: Optional[str] = None

    # -- identity ----------------------------------------------------------
    @property
    def rid(self) -> str:
        return self.req.rid

    @property
    def arrival_s(self) -> float:
        return self.req.arrival_s or 0.0

    @property
    def prompt_len(self) -> int:
        return self.req.prompt_len

    @property
    def deadline_at(self) -> Optional[float]:
        """Absolute clock time this request expires (None = no deadline)."""
        if self.req.deadline_s is None:
            return None
        return self.arrival_s + self.req.deadline_s

    # -- progress ----------------------------------------------------------
    @property
    def prefill_remaining(self) -> int:
        return self.req.prompt_len - self.prefill_pos

    @property
    def decode_ready(self) -> bool:
        return (self.prefill_remaining == 0 and self.finish_s is None
                and len(self.out) < self.req.max_new_tokens)

    @property
    def context_len(self) -> int:
        return self.prefill_pos + len(self.out)

    def blocks_needed(self, block_size: int) -> int:
        return blocks_for(self.token_budget, block_size)

    def finish(self, clock: float, reason: str) -> None:
        self.finish_s = clock
        self.finish_reason = reason

    def metrics(self) -> Dict[str, float]:
        ft = self.first_token_s if self.first_token_s is not None \
            else self.finish_s
        n = len(self.out)
        return {
            "rid": self.rid, "prompt_len": self.prompt_len, "n_out": n,
            "arrival_s": self.arrival_s, "admitted_s": self.admitted_s,
            "first_token_s": ft, "finish_s": self.finish_s,
            "ttft_s": (ft - self.arrival_s) if ft is not None else None,
            "tpot_s": ((self.finish_s - ft) / (n - 1)
                       if ft is not None and self.finish_s is not None
                       and n > 1 else 0.0),
            "finish_reason": self.finish_reason,
        }


@dataclasses.dataclass
class StepExec:
    """What a backend did for one step: the new token per touched request
    plus measured wall phases (real backend; zeros for simulation)."""

    tokens: Dict[str, Any]
    prefill_s: float = 0.0
    decode_s: float = 0.0


@dataclasses.dataclass
class StepReport:
    step: int
    clock: float
    plan: StepPlan
    predicted: ServeStepCost
    measured_prefill_s: float
    measured_decode_s: float
    admitted: List[str]
    finished: List[str]
    # post-step system state (queue/KV/batch composition — what the obs
    # gauges and the serving trace's counter tracks are drawn from)
    queue_depth: int = 0
    active: int = 0
    kv_blocks_used: int = 0
    kv_blocks_total: int = 0
    prefill_tokens: int = 0
    decode_batch: int = 0


@dataclasses.dataclass
class SchedulerConfig:
    max_cache_len: int = 4096        # ring capacity per request (tokens)
    block_size: int = 16             # KV block granularity (tokens)
    num_blocks: Optional[int] = None  # pool size; default fits max_active rings
    max_batch: int = 16              # decode batch cap
    max_active: Optional[int] = None  # admission cap; default max_batch
    max_queue: Optional[int] = None  # waiting-queue bound; overflow is shed
    #                                  by predicted cost (None = unbounded)

    def resolve(self) -> "SchedulerConfig":
        out = dataclasses.replace(self)
        if out.max_active is None:
            out.max_active = out.max_batch
        if out.num_blocks is None:
            out.num_blocks = out.max_active * blocks_for(
                out.max_cache_len, out.block_size)
        return out


class Scheduler:
    def __init__(self, backend, cost: ServeCostModel,
                 cfg: Optional[SchedulerConfig] = None, *,
                 policy: Optional[Policy] = None,
                 phase_timer=None, metrics=None,
                 ttft_slo_s: Optional[float] = None,
                 tpot_slo_s: Optional[float] = None,
                 slo_watcher=None, degradation=None):
        self.backend = backend
        self.cost = cost
        self.cfg = (cfg or SchedulerConfig()).resolve()
        self.blocks = BlockManager(self.cfg.num_blocks, self.cfg.block_size)
        self.policy = policy if policy is not None else FIFOPolicy()
        self.waiting: List[RequestState] = []
        self.active: Dict[str, RequestState] = {}
        self.finished: Dict[str, RequestState] = {}
        self.clock = 0.0
        self.steps = 0
        self._arrivals: List[Tuple[float, int, RequestState]] = []  # heap
        self._seq = itertools.count()
        self._outer_pt = phase_timer      # engine-level serve record
        # metrics: an explicit registry wins; else the obs default when
        # tracing is on; else nothing (zero overhead)
        self.metrics = metrics
        self.ttft_slo_s = ttft_slo_s
        self.tpot_slo_s = tpot_slo_s
        # optional obs.watch.SLOWatcher: per-evict good/bad outcomes plus
        # a burn-rate check per step, on the scheduler's own clock (the
        # simulated clock under trace replay)
        self.slo_watcher = slo_watcher
        # optional policy.DegradationController: burn-rate alerts shrink
        # the policy's prefill step budget, healthy checks recover it
        self.degradation = degradation
        self._mh: Dict[str, object] = {}  # cached metric handles

    # -- submission ---------------------------------------------------------
    def submit(self, req: Request) -> str:
        if (req.rid in self.active or req.rid in self.finished
                or any(w.rid == req.rid for w in self.waiting)):
            raise KeyError(f"duplicate request id {req.rid!r}")
        if req.arrival_s is None:
            req = dataclasses.replace(req, arrival_s=self.clock)
        budget = min(req.prompt_len + req.max_new_tokens,
                     self.cfg.max_cache_len)
        rs = RequestState(req, budget)
        if req.arrival_s <= self.clock:
            self.waiting.append(rs)
        else:
            heapq.heappush(self._arrivals,
                           (req.arrival_s, next(self._seq), rs))
        return req.rid

    def _drain_arrivals(self) -> None:
        while self._arrivals and self._arrivals[0][0] <= self.clock:
            self.waiting.append(heapq.heappop(self._arrivals)[2])

    @property
    def idle(self) -> bool:
        return not (self.waiting or self.active or self._arrivals)

    # -- one step ------------------------------------------------------------
    def step(self) -> Optional[StepReport]:
        """Admit, compose, execute, account, evict.  Returns None when
        there is nothing at all left to do."""
        tr = obs.tracer() if obs.enabled() else None
        return self._step_impl(tr)

    def _step_impl(self, tr) -> Optional[StepReport]:
        self._drain_arrivals()
        self._enforce_deadlines()
        self._shed_overflow()
        # one logical step = one root span (the fast-forward recursion
        # below closes its own zero-duration marker first)
        sp = None
        if tr is not None:
            sp = tr.begin("serve:step", cat="serve_step",
                          args={"step": self.steps,
                                "policy": self.policy.name})
        try:
            t_adm = time.perf_counter()
            admitted = self._admit()
            if tr is not None:
                tr.complete("admit", time.perf_counter() - t_adm,
                            cat="serve",
                            args={"n_admitted": len(admitted),
                                  "queue_depth": len(self.waiting)})
            t_cmp = time.perf_counter()
            plan = self.policy.compose(list(self.active.values()), self.cost,
                                       max_batch=self.cfg.max_batch)
            if tr is not None:
                tr.complete(
                    "compose", time.perf_counter() - t_cmp, cat="serve",
                    args={"prefill_tokens": sum(n for _, n in plan.prefill),
                          "decode_batch": len(plan.decode)})
            if plan.empty:
                if self._arrivals:          # fast-forward to next arrival
                    if sp is not None:
                        sp.args["fast_forward"] = True
                        tr.end(sp, dur_s=0.0)
                        sp = None           # closed; recursion owns its own
                    self.clock = self._arrivals[0][0]
                    return self._step_impl(tr)
                if sp is not None:
                    sp.args["idle"] = True
                    tr.end(sp, dur_s=0.0)
                return None

            prefill_entries = [(n, self.active[rid].prefill_pos)
                               for rid, n in plan.prefill]
            decode_ctx = [self.active[rid].context_len for rid in plan.decode]
            predicted = self.cost.predict_step(prefill_entries, decode_ctx)

            timed = self._timed()
            t0 = time.perf_counter()
            ex = self.backend.execute(plan, self.active, timed=timed)
            wall = time.perf_counter() - t0

            # clock: measured wall for real execution, prediction for
            # simulation
            if self.backend.measures:
                advance = (ex.prefill_s + ex.decode_s) if timed else wall
            else:
                advance = predicted.total_s
            self.clock += advance

            # account prefill progress, then tokens / completions
            for rid, n in plan.prefill:
                rs = self.active[rid]
                rs.prefill_pos += n
                self.blocks.append_tokens(rid, n)
            finished: List[str] = []
            for rid, tok in ex.tokens.items():
                rs = self.active[rid]
                rs.out.append(tok)
                self.blocks.append_tokens(rid, 1)
                if rs.first_token_s is None:
                    rs.first_token_s = self.clock
                self._maybe_finish(rs, tok)
                if rs.finish_s is not None:
                    finished.append(rid)
            for rid in finished:
                self._evict(rid)

            self.steps += 1
            if self.slo_watcher is not None:
                self.slo_watcher.check(self.clock)
                if self.degradation is not None:
                    # feed the firing *level*, not check()'s edge-triggered
                    # alerts: the budget stays shrunk while the burn lasts
                    budget = self.degradation.update(
                        self.slo_watcher.firing())
                    reg = self._registry()
                    if reg is not None and budget is not None:
                        self._ensure_handles(reg)["budget"].set(budget)
            self._record(plan, predicted, ex, timed)
            rep = StepReport(
                self.steps - 1, self.clock, plan, predicted,
                ex.prefill_s, ex.decode_s,
                [r.rid for r in admitted], finished,
                queue_depth=len(self.waiting), active=len(self.active),
                kv_blocks_used=self.blocks.used_blocks,
                kv_blocks_total=self.blocks.num_blocks,
                prefill_tokens=sum(n for _, n in plan.prefill),
                decode_batch=len(plan.decode))
            self._observe_step(rep)
            if tr is not None:
                # per-phase children pair with the cost model's split; the
                # root pairs with the predicted step total.  Simulated
                # phases measure as their predictions (residual 0) — real
                # backends carry true residuals.
                meas = self.backend.measures
                pf = ex.prefill_s if meas else predicted.prefill_s
                dc = ex.decode_s if meas else predicted.decode_s
                if plan.prefill:
                    tr.complete("prefill", pf, cat="serve_step",
                                predicted_s=predicted.prefill_s,
                                args={"tokens": rep.prefill_tokens})
                if plan.decode:
                    tr.complete("decode", dc, cat="serve_step",
                                predicted_s=predicted.decode_s,
                                args={"batch": rep.decode_batch})
                sp.predicted_s = predicted.total_s
                sp.args.update(admitted=len(admitted),
                               finished=len(finished),
                               decode_batch=rep.decode_batch,
                               prefill_tokens=rep.prefill_tokens)
                tr.end(sp, dur_s=advance)
            return rep
        except BaseException:
            if sp is not None:
                tr.end(sp, error=True)
            raise

    def run(self, max_steps: Optional[int] = None) -> List[StepReport]:
        reports = []
        while max_steps is None or len(reports) < max_steps:
            rep = self.step()
            if rep is None:
                break
            reports.append(rep)
        return reports

    def request_metrics(self) -> List[Dict[str, float]]:
        return [rs.metrics() for rs in self.finished.values()]

    # -- robustness -----------------------------------------------------------
    def _drop_waiting(self, rs: RequestState, reason: str) -> None:
        """Retire a never-admitted request: it was not served, so it is a
        bad SLO outcome and does NOT count in ``serve_finished_total``
        (which tracks requests the scheduler actually ran)."""
        rs.finish(self.clock, reason)
        self.finished[rs.rid] = rs
        if self.slo_watcher is not None:
            self.slo_watcher.record_outcomes(self.clock, ttft=False,
                                             goodput=False)

    def _enforce_deadlines(self) -> None:
        """Evict every request whose absolute deadline has passed —
        waiting requests are dropped unserved, active ones are evicted
        mid-stream (their blocks freed for live work)."""
        expired = [rs for rs in self.waiting
                   if rs.deadline_at is not None
                   and self.clock > rs.deadline_at]
        reg = self._registry()
        for rs in expired:
            self.waiting.remove(rs)
            self._drop_waiting(rs, "deadline")
        n = len(expired)
        for rid in [rid for rid, rs in self.active.items()
                    if rs.deadline_at is not None
                    and self.clock > rs.deadline_at]:
            self.active[rid].finish(self.clock, "deadline")
            self._evict(rid)
            n += 1
        if n and reg is not None:
            self._ensure_handles(reg)["deadline"].inc(n)

    def _shed_overflow(self) -> None:
        """Predicted-cost-aware load shedding: when the admission queue
        overflows ``cfg.max_queue``, keep the cheapest requests (by the
        cost model's predicted prefill time, FIFO-tie-broken) and shed
        the expensive tail — bounding queue growth under overload at the
        smallest loss of predicted goodput."""
        mq = self.cfg.max_queue
        if mq is None or len(self.waiting) <= mq:
            return
        ranked = sorted(
            self.waiting,
            key=lambda rs: (self.cost.request_prefill_cost(rs.prompt_len),
                            rs.arrival_s, rs.rid))
        shed = ranked[mq:]
        keep = set(id(rs) for rs in ranked[:mq])
        self.waiting = [rs for rs in self.waiting if id(rs) in keep]
        for rs in shed:
            self._drop_waiting(rs, "shed")
        reg = self._registry()
        if reg is not None:
            self._ensure_handles(reg)["shed"].inc(len(shed))

    # -- internals ------------------------------------------------------------
    def _admit(self) -> List[RequestState]:
        chosen = self.policy.admit(
            self.waiting, self.blocks, self.cost, clock=self.clock,
            active=len(self.active), max_active=self.cfg.max_active)
        admitted = []
        for rs in chosen:
            if not self.blocks.can_admit(rs.token_budget):
                continue                   # policy raced capacity; re-queue
            self.blocks.allocate(rs.rid, rs.token_budget)
            rs.admitted_s = self.clock
            self.active[rs.rid] = rs
            self.waiting.remove(rs)
            self.backend.admit(rs)
            admitted.append(rs)
        return admitted

    def _maybe_finish(self, rs: RequestState, tok) -> None:
        req = rs.req
        if req.eos_id is not None or req.stop_ids:
            t = token_int(tok)      # host sync; only when stops configured
            if t == req.eos_id or t in req.stop_ids:
                rs.finish(self.clock, "stop")
                return
        if len(rs.out) >= req.max_new_tokens:
            rs.finish(self.clock, "length")

    def _evict(self, rid: str) -> None:
        rs = self.active.pop(rid)
        self.blocks.free(rid)
        self.backend.release(rid)
        self.finished[rid] = rs
        reg = self._registry()
        m = rs.metrics() if (reg is not None
                             or self.slo_watcher is not None) else None
        if reg is not None:
            h = self._ensure_handles(reg)
            h["finished"].inc()
            h["tokens"].inc(m["n_out"])
            h["last_finish"].set(rs.finish_s)
            if m["ttft_s"] is not None:
                h["ttft"].observe(m["ttft_s"])
            if m["n_out"] > 1:
                h["tpot"].observe(m["tpot_s"])
            if self.ttft_slo_s is not None:
                met = (m["ttft_s"] is not None
                       and m["ttft_s"] <= self.ttft_slo_s
                       and (m["n_out"] <= 1 or self.tpot_slo_s is None
                            or m["tpot_s"] <= self.tpot_slo_s))
                if met:
                    h["slo_met"].inc()
        if self.slo_watcher is not None:
            ttft_ok = (self.ttft_slo_s is None
                       or (m["ttft_s"] is not None
                           and m["ttft_s"] <= self.ttft_slo_s))
            tpot_ok = (self.tpot_slo_s is None or m["n_out"] <= 1
                       or m["tpot_s"] <= self.tpot_slo_s)
            self.slo_watcher.record_outcomes(
                self.clock, ttft=ttft_ok, tpot=tpot_ok,
                goodput=ttft_ok and tpot_ok)

    # -- metrics --------------------------------------------------------------
    def _registry(self):
        if self.metrics is not None:
            return self.metrics
        if obs.enabled():
            return obs.default_registry()
        return None

    def _ensure_handles(self, reg) -> Dict[str, object]:
        h = self._mh
        if h.get("_reg") is not reg:
            pol = self.policy.name
            h.clear()
            h["_reg"] = reg
            h["steps"] = reg.counter("serve_steps_total", policy=pol)
            h["finished"] = reg.counter("serve_finished_total", policy=pol)
            h["tokens"] = reg.counter("serve_tokens_out_total", policy=pol)
            h["slo_met"] = reg.counter("serve_slo_met_total", policy=pol)
            h["deadline"] = reg.counter("serve_deadline_missed_total",
                                        policy=pol)
            h["shed"] = reg.counter("serve_shed_total", policy=pol)
            h["budget"] = reg.gauge("serve_step_budget_s", policy=pol)
            h["queue"] = reg.gauge("serve_queue_depth", policy=pol)
            h["active"] = reg.gauge("serve_active_requests", policy=pol)
            h["kv_used"] = reg.gauge("serve_kv_blocks_used", policy=pol)
            h["kv_util"] = reg.gauge("serve_kv_utilization", policy=pol)
            h["batch"] = reg.gauge("serve_decode_batch", policy=pol)
            h["pf_tok"] = reg.gauge("serve_prefill_tokens", policy=pol)
            h["last_finish"] = reg.gauge("serve_last_finish_s", policy=pol)
            # keep_values: exact nearest-rank percentiles, so the replay
            # report and the obs summary agree by construction
            h["ttft"] = reg.histogram("serve_ttft_s", keep_values=True,
                                      policy=pol)
            h["tpot"] = reg.histogram("serve_tpot_s", keep_values=True,
                                      policy=pol)
        return h

    def _observe_step(self, rep: StepReport) -> None:
        reg = self._registry()
        if reg is None:
            return
        h = self._ensure_handles(reg)
        h["steps"].inc()
        h["queue"].set(rep.queue_depth)
        h["active"].set(rep.active)
        h["kv_used"].set(rep.kv_blocks_used)
        h["kv_util"].set(rep.kv_blocks_used / rep.kv_blocks_total
                         if rep.kv_blocks_total else 0.0)
        h["batch"].set(rep.decode_batch)
        h["pf_tok"].set(rep.prefill_tokens)

    def _timed(self) -> bool:
        if not self.backend.measures:
            return False
        if self._outer_pt is not None:
            return True
        from .. import telemetry
        return telemetry.enabled()

    def _record(self, plan: StepPlan, predicted: ServeStepCost,
                ex: StepExec, timed: bool) -> None:
        if self._outer_pt is not None:
            if ex.prefill_s > 0:
                self._outer_pt.add("prefill", ex.prefill_s)
            if ex.decode_s > 0:
                self._outer_pt.add("decode", ex.decode_s)
        if not (timed and self.backend.measures):
            return
        from .. import telemetry
        if not telemetry.enabled():
            return
        m = self.cost.machine
        pt = telemetry.PhaseTimer(
            "serve_step", variant=self.policy.name,
            n=sum(n for _, n in plan.prefill) + len(plan.decode),
            p=len(plan.decode) or 1, machine=m.name,
            fingerprint=m.fingerprint(), kind="serve_step",
            predicted={"prefill": predicted.prefill_s,
                       "decode": predicted.decode_s,
                       "total": predicted.total_s},
            meta={"prefill_tokens": sum(n for _, n in plan.prefill),
                  "decode_batch": len(plan.decode),
                  "arch": getattr(self.cost.cfg, "name", "")})
        if ex.prefill_s > 0:
            pt.add("prefill", ex.prefill_s)
        if ex.decode_s > 0:
            pt.add("decode", ex.decode_s)
        pt.emit()


# ---------------------------------------------------------------------------
# backends
# ---------------------------------------------------------------------------

class SimBackend:
    """Cost-model-driven execution: no arrays move; the scheduler's clock
    advances by predicted step time.  Token identity is synthetic (0), so
    requests end by ``max_new_tokens`` — trace replay sets that to the
    trace's output length (``Request.output_len`` is honored the same
    way when given, by emitting ``eos_id`` at the end)."""

    measures = False

    def admit(self, rs: RequestState) -> None:  # noqa: D401 - interface
        pass

    def release(self, rid: str) -> None:
        pass

    def execute(self, plan: StepPlan, states: Dict[str, RequestState],
                *, timed: bool = False) -> StepExec:
        tokens: Dict[str, Any] = {}
        for rid, n in plan.prefill:
            rs = states[rid]
            if rs.prefill_remaining - n <= 0:
                tokens[rid] = self._token(rs)
        for rid in plan.decode:
            tokens[rid] = self._token(states[rid])
        return StepExec(tokens=tokens)

    @staticmethod
    def _token(rs: RequestState):
        req = rs.req
        if (req.output_len is not None and req.eos_id is not None
                and len(rs.out) + 1 >= req.output_len):
            return req.eos_id
        return 0


class ModelBackend:
    """Real execution over per-request caches (see module docstring), under
    ``torch.inference_mode()``.  ``net`` is the model's module (the
    reference passes a parameter tree); caches go on its device."""

    measures = True

    def __init__(self, model, net, *, max_cache_len: int,
                 prefill_chunk: Optional[int] = None, tuner=None):
        self.model = model
        self.net = net
        self.device = next(net.parameters()).device
        self.max_cache_len = int(max_cache_len)
        self.prefill_chunk = prefill_chunk
        self._tuner = tuner
        self._state: Dict[str, Dict[str, Any]] = {}

    # -- lifecycle ----------------------------------------------------------
    def admit(self, rs: RequestState) -> None:
        import torch

        req = rs.req
        gen = None
        if req.temperature > 0:
            gen = torch.Generator(device=self.device).manual_seed(req.seed)
        self._state[rs.rid] = {
            "caches": self.model.init_cache(1, self.max_cache_len,
                                            device=self.device),
            "logits": None, "next_tok": None,
            "prompt": req.prompt.to(self.device),
            "memory": (None if req.memory is None
                       else req.memory.to(self.device)),
            "gen": gen,
        }

    def release(self, rid: str) -> None:
        self._state.pop(rid, None)

    # -- chunk sizing (engine semantics) -------------------------------------
    def chunk_granularity(self, seq_len: int) -> int:
        # architecture gate first: recurrent decode paths and sliding-window
        # ring buffers are strictly one-token, whatever the config asks for
        if not self.model.supports_chunked_prefill:
            return 1
        if self.prefill_chunk is not None:
            return max(1, self.prefill_chunk)
        if self._tuner is None:
            from ..tuner import default_tuner
            self._tuner = default_tuner()
        return self._tuner.prefill_chunk(seq_len)

    # -- execution ------------------------------------------------------------
    def execute(self, plan: StepPlan, states: Dict[str, RequestState],
                *, timed: bool = False) -> StepExec:
        import torch

        tokens: Dict[str, Any] = {}
        prefill_s = decode_s = 0.0
        with torch.inference_mode():
            if plan.prefill:
                t0 = time.perf_counter()
                for rid, n in plan.prefill:
                    self._prefill_one(states[rid], n, tokens)
                if timed:
                    self._sync()
                prefill_s = time.perf_counter() - t0

            if plan.decode:
                t0 = time.perf_counter()
                tokens.update(self._decode_batch(plan.decode, states))
                if timed:
                    self._sync()
                decode_s = time.perf_counter() - t0

        return StepExec(tokens=tokens, prefill_s=prefill_s,
                        decode_s=decode_s)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)

    def _step(self, tokens, caches, memory):
        return self.model.decode_step(self.net, tokens, caches, memory)

    def _prefill_one(self, rs: RequestState, n: int, tokens: Dict[str, Any]):
        """Advance one request's prefill by ``n`` prompt tokens: chunked at
        the engine granularity, ring-boundary-safe, per-token tail (the
        reference's stepping: a chunk is one MoE routing group, so a
        shorter tail chunk would route, and drop, differently)."""
        st = self._state[rs.rid]
        prompt = st["prompt"]
        chunk = self.chunk_granularity(rs.prompt_len)
        limit = self.max_cache_len
        i, end = rs.prefill_pos, rs.prefill_pos + n
        logits, caches = st["logits"], st["caches"]
        while chunk > 1 and end - i >= chunk and i + chunk <= limit:
            logits, caches = self._step(prompt[:, i:i + chunk], caches,
                                        st["memory"])
            i += chunk
        for j in range(i, end):
            logits, caches = self._step(prompt[:, j:j + 1], caches,
                                        st["memory"])
        st["logits"], st["caches"] = logits, caches
        if end >= rs.prompt_len:           # prompt done: first token now
            tok = self._sample(rs, logits)
            tokens[rs.rid] = tok
            st["next_tok"] = tok

    def _decode_batch(self, rids: Sequence[str],
                      states: Dict[str, RequestState]) -> Dict[str, Any]:
        import torch

        if any(self._state[r]["memory"] is not None for r in rids):
            # cross-attention rows may differ in width: the per-request
            # path, as the reference takes it
            out = {}
            for rid in rids:
                st = self._state[rid]
                logits, st["caches"] = self._step(st["next_tok"],
                                                  st["caches"], st["memory"])
                st["logits"] = logits
                out[rid] = st["next_tok"] = self._sample(states[rid], logits)
            return out

        toks = torch.cat([self._state[r]["next_tok"] for r in rids])
        logits, caches = self._step(
            toks, stack_caches([self._state[r]["caches"] for r in rids]),
            None)
        out = {}
        for i, rid in enumerate(rids):
            st = self._state[rid]
            st["caches"] = row_of(caches, i)
            st["logits"] = logits[i:i + 1]
            out[rid] = st["next_tok"] = self._sample(states[rid],
                                                     st["logits"])
        return out

    def _sample(self, rs: RequestState, logits):
        """Next token (1, 1) from the last position's logits: greedy, or
        drawn from the request's own generator when it asks for heat."""
        import torch

        req = rs.req
        last = logits[:, -1].float()
        if req.temperature > 0:
            probs = torch.softmax(last / req.temperature, dim=-1)
            return torch.multinomial(probs, 1,
                                     generator=self._state[rs.rid]["gen"])
        return torch.argmax(last, dim=-1, keepdim=True)


def stack_caches(caches_list):
    """Per-request caches (each of batch 1, one dict a layer) -> one cache
    whose rows are theirs, in order (copies)."""
    import torch

    return [{key: type(st)(*(torch.cat([c[li][key][f] for c in caches_list])
                             for f in range(len(st))))
             for key, st in layer.items()}
            for li, layer in enumerate(caches_list[0])]


def row_of(caches, i: int):
    """Row ``i`` of a batched cache, as a cache of batch 1 (views of it)."""
    return [{key: type(st)(*(t[i:i + 1] for t in st))
             for key, st in layer.items()} for layer in caches]


def build_scheduler(model=None, net=None, *, cfg_model=None,
                    machine=None, scheduler_cfg: Optional[SchedulerConfig] = None,
                    policy: str = "fifo", step_budget_s: Optional[float] = None,
                    backend: Optional[Any] = None, tuner=None,
                    phase_timer=None, metrics=None,
                    ttft_slo_s: Optional[float] = None,
                    tpot_slo_s: Optional[float] = None,
                    slo_watcher=None, degradation=None) -> Scheduler:
    """Convenience constructor.  With ``model``/``net``: real execution
    (:class:`ModelBackend`); without: cost-model simulation
    (:class:`SimBackend`).  ``cfg_model`` is the ModelConfig the cost
    model describes (defaults to ``model.cfg``)."""
    from ..core.machine import CPU_HOST

    mcfg = cfg_model if cfg_model is not None else getattr(model, "cfg", None)
    if mcfg is None:
        raise ValueError("need cfg_model (or a model with .cfg)")
    cost = cost_model_for(mcfg, machine or CPU_HOST)
    scfg = (scheduler_cfg or SchedulerConfig()).resolve()
    if backend is None:
        if model is not None:
            backend = ModelBackend(model, net,
                                   max_cache_len=scfg.max_cache_len,
                                   tuner=tuner)
        else:
            backend = SimBackend()
    pol = make_policy(policy, step_budget_s=step_budget_s, tuner=tuner)
    if degradation is True:
        from .policy import DegradationController
        degradation = DegradationController(pol)
    return Scheduler(backend, cost, scfg, policy=pol,
                     phase_timer=phase_timer, metrics=metrics,
                     ttft_slo_s=ttft_slo_s, tpot_slo_s=tpot_slo_s,
                     slo_watcher=slo_watcher, degradation=degradation)
