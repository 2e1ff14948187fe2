"""Batch-composition policies: what runs in the next scheduler step.

Two policies share one interface (``admit`` + ``compose``):

* :class:`FIFOPolicy` — the baseline every serving paper measures against
  (rtp-llm's FIFOScheduler lifecycle): requests are admitted strictly in
  arrival order, a pending prefill is run *whole* and ahead of decode, so
  a long prompt head-of-line-blocks both the queue behind it and the
  decode streams already running.

* :class:`ModelGuidedPolicy` — the paper's thesis applied online: the
  serving cost model (:mod:`repro_torch.serving.cost`) predicts what every
  candidate composition costs, and the policy (i) admits the cheapest
  predicted prefills first (aged so nothing starves), (ii) always keeps
  the decode batch running, and (iii) interleaves prefill *chunks* sized
  by ``Tuner.serve_chunk`` so the predicted step time stays inside the
  step budget — SLO-aware packing instead of arrival order.

Policies are deliberately stateful-but-tiny objects; the scheduler hands
them its live view (waiting queue, active set, block pool, cost model)
each step.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from .cost import ServeCostModel
from .kvblocks import BlockManager


@dataclasses.dataclass
class StepPlan:
    """One scheduler step: prefill chunk entries + the decode batch."""

    prefill: List[Tuple[str, int]]          # (rid, tokens this step)
    decode: List[str]                       # rids decoding one token

    @property
    def empty(self) -> bool:
        return not self.prefill and not self.decode


class Policy:
    """Interface; see module docstring."""

    name = "base"

    def admit(self, waiting: List, blocks: BlockManager,
              cost: ServeCostModel, *, clock: float,
              active: int, max_active: int) -> List:
        """Subset of ``waiting`` (scheduler RequestStates, arrival order)
        to admit now.  The scheduler verifies capacity again at
        allocation time; policies should only propose what fits."""
        raise NotImplementedError

    def compose(self, active: List, cost: ServeCostModel, *,
                max_batch: int) -> StepPlan:
        """The next step over the active set (RequestStates)."""
        raise NotImplementedError


class FIFOPolicy(Policy):
    """Arrival order; whole-prompt prefill ahead of decode."""

    name = "fifo"

    def admit(self, waiting, blocks, cost, *, clock, active, max_active):
        out = []
        free = blocks.free_blocks
        for r in sorted(waiting, key=lambda r: (r.arrival_s, r.rid)):
            if active + len(out) >= max_active:
                break
            need = r.blocks_needed(blocks.block_size)
            if need > free:
                break                      # strict FIFO: no bypass
            free -= need
            out.append(r)
        return out

    def compose(self, active, cost, *, max_batch):
        pending = [r for r in active if r.prefill_remaining > 0]
        if pending:
            r = min(pending, key=lambda r: (r.admitted_s, r.rid))
            return StepPlan(prefill=[(r.rid, r.prefill_remaining)], decode=[])
        ready = sorted((r for r in active if r.decode_ready),
                       key=lambda r: (r.admitted_s, r.rid))[:max_batch]
        return StepPlan(prefill=[], decode=[r.rid for r in ready])


class ModelGuidedPolicy(Policy):
    """Cost-model-driven SLO-aware packing (see module docstring).

    ``step_budget_s`` bounds the *predicted* step time; ``aging_s`` is
    the wait after which an expensive prefill outranks a cheap newcomer
    (halves its effective cost per multiple).  Prefill can never starve:
    each step grants it at least a budget floor proportional to the
    decode load (so prefill throughput tracks decode throughput even
    when the configured budget is too tight), and failing even that, one
    minimum-granularity chunk is forced through per step."""

    name = "model"

    def __init__(self, step_budget_s: float = 0.05, *, aging_s: float = 1.0,
                 tuner=None):
        self.step_budget_s = float(step_budget_s)
        self.aging_s = float(aging_s)
        self._tuner = tuner

    def _effective_cost(self, r, cost: ServeCostModel, clock: float) -> float:
        c = cost.request_prefill_cost(r.prompt_len)
        age = max(clock - r.arrival_s, 0.0) / self.aging_s
        return c / (1.0 + age)

    def admit(self, waiting, blocks, cost, *, clock, active, max_active):
        ranked = sorted(
            waiting,
            key=lambda r: (self._effective_cost(r, cost, clock),
                           r.arrival_s, r.rid))
        out, free = [], blocks.free_blocks
        for r in ranked:
            if active + len(out) >= max_active:
                break
            need = r.blocks_needed(blocks.block_size)
            if need <= free:               # cheapest-first, bypass allowed
                free -= need
                out.append(r)
        return out

    def compose(self, active, cost, *, max_batch):
        ready = sorted((r for r in active if r.decode_ready),
                       key=lambda r: (r.admitted_s, r.rid))[:max_batch]
        decode = [r.rid for r in ready]
        decode_ctx = [r.context_len for r in ready]
        pending = sorted((r for r in active if r.prefill_remaining > 0),
                         key=lambda r: (cost.request_prefill_cost(
                             r.prefill_remaining), r.admitted_s, r.rid))
        if not decode:
            # no TPOT to protect: run the cheapest pending prompt whole,
            # at full blocking efficiency (chunking would only cost
            # throughput here)
            if not pending:
                return StepPlan(prefill=[], decode=[])
            r = pending[0]
            return StepPlan(prefill=[(r.rid, r.prefill_remaining)], decode=[])

        decode_s = cost.decode_step(decode_ctx).decode_s
        # progress floor: prefill always earns at least the decode
        # micro-step's own time, whatever the configured budget says
        # (equal-share interleaving; prefill can never starve)
        budget = max(self.step_budget_s - decode_s, decode_s)
        prefill: List[Tuple[str, int]] = []
        chunks_ctx: List[Tuple[int, int]] = []
        for r in pending:
            n = self._chunk_within(cost, r, chunks_ctx, budget)
            if n <= 0:
                continue
            prefill.append((r.rid, n))
            chunks_ctx.append((n, r.prefill_pos))
            budget -= (cost.prefill_step(chunks_ctx).prefill_s
                       - cost.prefill_step(chunks_ctx[:-1]).prefill_s)

        if pending and not prefill:
            # last resort: one minimum chunk for the cheapest pending
            # prefill, budget or not — starvation is never an option
            r = pending[0]
            g = self._granularity(r)
            prefill = [(r.rid, min(g, r.prefill_remaining))]
        return StepPlan(prefill=prefill, decode=decode)

    # -- chunk sizing via the tuner -----------------------------------------
    def _granularity(self, r) -> int:
        if self._tuner is None:
            from ..tuner import default_tuner
            self._tuner = default_tuner()
        return max(1, self._tuner.prefill_chunk(r.prompt_len))

    def _chunk_within(self, cost, r, other_chunks, budget_s) -> int:
        if budget_s <= 0:
            return 0
        if self._tuner is None:
            from ..tuner import default_tuner
            self._tuner = default_tuner()
        base = cost.prefill_step(other_chunks).prefill_s if other_chunks \
            else 0.0
        return self._tuner.serve_chunk(
            r.prefill_remaining, ctx0=r.prefill_pos, cost=cost,
            budget_s=budget_s, base_prefill=other_chunks,
            base_prefill_s=base, granularity=self._granularity(r))


class DegradationController:
    """Graceful degradation: shrink the prefill step budget under SLO burn.

    Wraps a policy that exposes ``step_budget_s`` (the model-guided
    policy's predicted-step-time bound).  Each scheduler step hands the
    controller the current SLO burn-rate alerts
    (:meth:`repro_torch.obs.slo.SLOWatcher.check`); while any alert fires the
    budget shrinks multiplicatively (``shrink`` per step, floored at
    ``floor_frac`` of the configured budget), trading prefill throughput
    for decode latency exactly where the burn is.  When the alerts clear
    the budget recovers geometrically (``recover`` per step) back to the
    base — no oscillating bang-bang, no permanent penalty.

    For policies without a step budget (e.g. FIFO) the controller is a
    recording no-op: ``update`` returns None and changes nothing.
    """

    def __init__(self, policy: Policy, *, floor_frac: float = 0.25,
                 shrink: float = 0.5, recover: float = 1.2):
        if not 0.0 < floor_frac <= 1.0:
            raise ValueError("floor_frac must be in (0, 1]")
        if not 0.0 < shrink < 1.0:
            raise ValueError("shrink must be in (0, 1)")
        if recover <= 1.0:
            raise ValueError("recover must be > 1")
        self.policy = policy
        self.floor_frac = float(floor_frac)
        self.shrink = float(shrink)
        self.recover = float(recover)
        self.base_budget_s: Optional[float] = None
        budget = getattr(policy, "step_budget_s", None)
        if budget is not None:
            self.base_budget_s = float(budget)
        self.events: List[dict] = []

    @property
    def degraded(self) -> bool:
        cur = getattr(self.policy, "step_budget_s", None)
        return (self.base_budget_s is not None and cur is not None
                and cur < self.base_budget_s)

    def update(self, alerts) -> Optional[float]:
        """Apply one step of shrink/recover; returns the current budget
        (None when the policy has no step budget to govern)."""
        if self.base_budget_s is None:
            return None
        cur = float(self.policy.step_budget_s)
        if alerts:
            new = max(cur * self.shrink, self.base_budget_s * self.floor_frac)
        else:
            new = min(cur * self.recover, self.base_budget_s)
        if new != cur:
            self.events.append({
                "action": "shrink" if new < cur else "recover",
                "budget_s": new,
                "alerts": [getattr(a, "rule", str(a)) for a in alerts or ()]})
            self.policy.step_budget_s = new
        return new


def make_policy(name: str, *, step_budget_s: Optional[float] = None,
                tuner=None) -> Policy:
    """Factory: ``"fifo"`` or ``"model"``."""
    if name == "fifo":
        return FIFOPolicy()
    if name == "model":
        return ModelGuidedPolicy(step_budget_s if step_budget_s is not None
                                 else 0.05, tuner=tuner)
    raise ValueError(f"unknown policy {name!r} (fifo | model)")
