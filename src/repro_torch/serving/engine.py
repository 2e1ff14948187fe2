"""Single-call generation facade over the continuous-batching scheduler.

``Engine.generate`` is a thin wrapper: each prompt row becomes one
:class:`~.scheduler.Request`, the batch is submitted to a
:class:`~.scheduler.Scheduler` over a :class:`~.scheduler.ModelBackend`
(per-request caches, one batched decode step over their stacked rows), and
the scheduler's admission/compose/evict loop runs it to completion.  One
code path serves both the one-shot API and the streaming trace replay, so
the single-request semantics the tests pin down (greedy determinism,
chunked-prefill equivalence, ring-buffer safety) are exactly the semantics
of the continuous-batching engine.

Generation for a request ends at ``max_new_tokens`` or earlier on an EOS /
stop token (``ServeConfig.eos_id`` / ``stop_ids``); early-stopped rows are
right-padded so the output shape stays ``(B, S + max_new)``.  No decode
step runs after a request's last token: the scheduler evicts on completion
instead of stepping once more and discarding the logits.

With telemetry recording on (``REPRO_TELEMETRY=1`` /
``repro_torch.telemetry.enable()``) every ``generate`` call emits one
measured run (prefill and decode as separate phases, each ending in a
device synchronize), and the scheduler emits one ``serve_step`` record per
step with the cost model's prediction attached, feeding the refit loop.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ..distributed.sharding import use_mesh
from ..models import Model


@dataclasses.dataclass
class ServeConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0           # 0 = greedy
    max_cache_len: int = 4096
    prefill_chunk: Optional[int] = None  # None: ask the tuner; 1: per-token
    eos_id: Optional[int] = None       # generation stops when sampled
    stop_ids: Tuple[int, ...] = ()     # additional per-request stop tokens
    pad_id: Optional[int] = None       # fill for early-stopped rows
                                       # (default: eos_id, else 0)


def make_serve_step(model: Model, mesh=None):
    """The decode step: (net, tokens, caches, memory) -> (logits,
    new_caches), without autograd.  tokens is (B, 1) for generation or
    (B, chunk) during chunked prefill.  Under ``mesh`` the step runs as
    the rank's, under ``use_mesh(mesh)``: ``net`` and the caches are its
    blocks (``Model.shard``, ``Model.init_cache(..., mesh=)``) and the
    tokens its rows."""

    @torch.inference_mode()
    def serve_step(net, tokens, caches, memory=None):
        if mesh is None:
            return model.decode_step(net, tokens, caches, memory)
        with use_mesh(mesh):
            return model.decode_step(net, tokens, caches, memory)

    return serve_step


class Engine:
    """``Engine(model, net, cfg)``: ``net`` is the module
    ``model.init(...)`` built (the reference passes a parameter tree); the
    engine serves on its device."""

    def __init__(self, model: Model, net, cfg: Optional[ServeConfig] = None):
        self.model = model
        self.net = net
        self.cfg = cfg if cfg is not None else ServeConfig()
        self._backend = None           # built lazily, reused across calls

    def _prefill_chunk(self, seq_len: int) -> int:
        return self._model_backend().chunk_granularity(seq_len)

    def _model_backend(self):
        from .scheduler import ModelBackend
        if self._backend is None:
            self._backend = ModelBackend(
                self.model, self.net, max_cache_len=self.cfg.max_cache_len,
                prefill_chunk=self.cfg.prefill_chunk)
        return self._backend

    def _timer(self, seq_len: int):
        """A telemetry PhaseTimer tagged for this engine, or None when
        recording is off (the only cost paid on the fast path)."""
        from .. import telemetry
        if not telemetry.enabled():
            return None
        from ..devices import device_kind_of
        from ..tuner.plan import machine_fingerprint
        from ..tuner.registry import DEFAULT_REGISTRY, machine_for_platform
        dev = next(self.net.parameters()).device
        platform = dev.type
        name = machine_for_platform(platform)
        try:
            profile = DEFAULT_REGISTRY.machine(name).machine
        except KeyError:
            profile = name
        count = torch.cuda.device_count() if platform == "cuda" else 1
        fp = machine_fingerprint(profile, platform, device_kind_of(dev),
                                 count)
        arch = getattr(getattr(self.model, "cfg", None), "name",
                       type(self.model).__name__)
        return telemetry.PhaseTimer(
            "serve", variant=str(arch), n=seq_len, p=count, machine=name,
            fingerprint=fp, kind="serve",
            meta={"max_new_tokens": self.cfg.max_new_tokens})

    def _make_scheduler(self, batch: int, phase_timer):
        from ..core.machine import CPU_HOST
        from .cost import cost_model_for
        from .policy import FIFOPolicy
        from .scheduler import Scheduler, SchedulerConfig

        cost = cost_model_for(self.model.cfg, CPU_HOST)
        scfg = SchedulerConfig(max_cache_len=self.cfg.max_cache_len,
                               max_batch=max(batch, 1),
                               max_active=max(batch, 1))
        return Scheduler(self._model_backend(), cost, scfg,
                         policy=FIFOPolicy(),
                         phase_timer=phase_timer)

    def generate(self, prompts: torch.Tensor, *,
                 batch_inputs: Optional[Dict[str, Any]] = None,
                 seed: int = 0) -> torch.Tensor:
        """prompts: (B, S) integer tensor.  Returns (B, S + max_new) tokens
        on the prompts' device; rows that hit an EOS / stop token early are
        padded to shape."""
        from .scheduler import Request

        b, s = prompts.shape
        cfg = self.cfg
        if cfg.max_new_tokens <= 0:
            return prompts
        pt = self._timer(s)
        memory = None
        if batch_inputs:
            with torch.inference_mode():
                memory = self.model.encode_memory(self.net, batch_inputs)

        sched = self._make_scheduler(b, pt)
        rids = []
        for i in range(b):
            rids.append(sched.submit(Request(
                rid=f"g{i}", prompt=prompts[i:i + 1],
                max_new_tokens=cfg.max_new_tokens,
                eos_id=cfg.eos_id, stop_ids=tuple(cfg.stop_ids),
                memory=None if memory is None else memory[i:i + 1],
                temperature=cfg.temperature, seed=seed + i)))
        sched.run()
        if pt is not None:
            pt.emit()

        pad = cfg.pad_id if cfg.pad_id is not None \
            else (cfg.eos_id if cfg.eos_id is not None else 0)
        out = torch.full((b, cfg.max_new_tokens), pad, dtype=prompts.dtype,
                         device=prompts.device)
        for i, rid in enumerate(rids):
            toks = sched.finished[rid].out
            out[i, :len(toks)] = torch.cat(toks, dim=1)[0].to(out)
        return torch.cat([prompts, out], dim=1)
