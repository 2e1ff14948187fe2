"""Per-request serving cost predictions — the scheduler's brain.

Exactly the paper's §IV recipe applied to a serve step instead of a
factorization step: walk what the step executes and charge each part to
the machine description.  A step is (i) optional chunked-prefill work —
dense matmuls over the chunk plus attention against the cache so far —
and (ii) one batched decode — dense matmuls over one token per live
request plus attention against each request's context — and the step
time is the roofline max of the flop term (at the efficiency the
blocking earns, paper Fig. 1 curves) and the HBM traffic term (weights
read once per step *shared by the whole batch* — the economy of scale
continuous batching exists to exploit), plus a fixed per-step dispatch
overhead.

Calibration mirrors the telemetry refit: predictions carry multiplicative
phase scales plus the overhead constant (:class:`ServeScales`), re-fitted
from telemetry ``serve_step`` records by :func:`refit_serving` and cached per
``machine.fingerprint()`` — a telemetry refit or drift-detected
``revision`` bump re-keys the fingerprint, so stale scheduler cost
tables are invalidated exactly the way stale tuner plans are.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from ..configs.base import ModelConfig
from ..core.machine import CPU_HOST, Machine
from ..core.perfmodel import HOPPER_EFFICIENCY, TPU_EFFICIENCY

_ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}

#: seed per-step dispatch overhead [s] per machine name (refit_serving
#: replaces it with the measured intercept).
_DEFAULT_OVERHEAD = {"cpu-host": 3e-4, "tpu-v5e": 5e-5}


@dataclasses.dataclass(frozen=True)
class ServeScales:
    """Calibration state of a serving cost model (never mutated in place)."""

    prefill_scale: float = 1.0
    decode_scale: float = 1.0
    overhead_s: float = 1e-4

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ServeStepCost:
    """Predicted composition of one scheduler step."""

    prefill_s: float
    decode_s: float
    flops: float
    hbm_bytes: float

    @property
    def total_s(self) -> float:
        return self.prefill_s + self.decode_s

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["total_s"] = self.total_s
        return d


def _efficiency_for(machine: Machine):
    return TPU_EFFICIENCY if machine.name.startswith("tpu") \
        else HOPPER_EFFICIENCY


class ServeCostModel:
    """Prefill/decode step-time predictions for one (model cfg, machine)."""

    def __init__(self, cfg: ModelConfig, machine: Machine = CPU_HOST,
                 scales: Optional[ServeScales] = None):
        self.cfg = cfg
        self.machine = machine
        self.efficiency = _efficiency_for(machine)
        self.scales = scales or ServeScales(
            overhead_s=_DEFAULT_OVERHEAD.get(machine.name, 1e-4))
        self._itemsize = _ITEMSIZE.get(cfg.dtype, 4)
        self._params = float(cfg.active_param_count())
        self._param_bytes = self._params * self._itemsize
        kv_hd = cfg.n_kv_heads * cfg.hd
        self._kv_bytes_per_tok = 2.0 * cfg.n_layers * kv_hd * self._itemsize

    # -- raw work summaries (no scales) -------------------------------------
    def _ctx(self, c: float) -> float:
        w = self.cfg.sliding_window
        return min(float(c), float(w)) if w else float(c)

    def _work(self, tokens: float, ctx_avg: float) -> Tuple[float, float]:
        """(flops, kv_bytes) of running ``tokens`` positions with mean
        attended context ``ctx_avg`` for one request."""
        cfg = self.cfg
        dense = 2.0 * self._params * tokens
        attn = 4.0 * cfg.n_layers * cfg.d_model * tokens * self._ctx(ctx_avg)
        # KV traffic: read the attended cache once, write the new tokens
        kv_bytes = self._kv_bytes_per_tok * (self._ctx(ctx_avg) + tokens)
        return dense + attn, kv_bytes

    def _roofline(self, flops: float, bytes_: float, block: float) -> float:
        # the efficiency argument is the *skinny* GEMM dimension of the
        # step: token rows beyond d_model earn nothing (the weight matrix
        # side already limits the blocking), so a >= d_model prefill
        # chunk runs at whole-prompt efficiency — chunking costs only
        # the per-step overhead, which is what makes budget-bounded
        # interleaving competitive with monolithic prefill
        m = self.machine
        eff = self.efficiency["dgemm"](
            max(min(block, float(self.cfg.d_model)), 1.0))
        t_flop = flops / (m.peak_flops_per_unit * eff)
        t_mem = bytes_ / (m.hbm_bandwidth or m.contention_free_bandwidth())
        return max(t_flop, t_mem)

    # -- step phases ---------------------------------------------------------
    def prefill_step(self, chunks: Sequence[Tuple[int, int]]) -> ServeStepCost:
        """One prefill micro-step: ``chunks`` is [(tokens, ctx0), ...] per
        participating request (ctx0 = cache length before the chunk)."""
        if not chunks:
            return ServeStepCost(0.0, 0.0, 0.0, 0.0)
        flops = 0.0
        bytes_ = self._param_bytes          # weights read once, shared
        widest = 1.0
        for t, c0 in chunks:
            f, kv = self._work(float(t), c0 + (float(t) + 1.0) / 2.0)
            flops += f
            bytes_ += kv
            widest = max(widest, float(t))
        t = self._roofline(flops, bytes_, widest) * self.scales.prefill_scale
        return ServeStepCost(t + self.scales.overhead_s, 0.0, flops, bytes_)

    def decode_step(self, contexts: Sequence[int]) -> ServeStepCost:
        """One batched decode micro-step over live contexts (one new token
        per request; the weight read is amortized over the whole batch)."""
        if len(contexts) == 0:
            return ServeStepCost(0.0, 0.0, 0.0, 0.0)
        flops = 0.0
        bytes_ = self._param_bytes
        for c in contexts:
            f, kv = self._work(1.0, float(c))
            flops += f
            bytes_ += kv
        t = self._roofline(flops, bytes_, float(len(contexts))) \
            * self.scales.decode_scale
        return ServeStepCost(0.0, t + self.scales.overhead_s, flops, bytes_)

    def predict_step(self, prefill: Sequence[Tuple[int, int]],
                     decode_contexts: Sequence[int]) -> ServeStepCost:
        """Full scheduler step = prefill micro-step + decode micro-step."""
        pf = self.prefill_step(prefill)
        dc = self.decode_step(decode_contexts)
        return ServeStepCost(pf.prefill_s, dc.decode_s,
                             pf.flops + dc.flops, pf.hbm_bytes + dc.hbm_bytes)

    # -- whole-request aggregates (policy ordering / SLO math) ---------------
    def request_prefill_cost(self, prompt_len: int,
                             chunk: Optional[int] = None) -> float:
        """Predicted seconds to prefill a whole prompt, chunked."""
        chunk = int(chunk or prompt_len) or 1
        total, done = 0.0, 0
        while done < prompt_len:
            t = min(chunk, prompt_len - done)
            total += self.prefill_step([(t, done)]).prefill_s
            done += t
        return total

    def request_decode_cost(self, prompt_len: int, new_tokens: int,
                            batch: int = 1) -> float:
        """Predicted seconds of decode for one request riding in a batch of
        ``batch`` peers (its share of each step)."""
        if new_tokens <= 1:
            return 0.0
        total = 0.0
        for i in range(new_tokens - 1):
            step = self.decode_step([prompt_len + 1 + i] * max(batch, 1))
            total += step.decode_s / max(batch, 1)
        return total

    def with_scales(self, scales: ServeScales) -> "ServeCostModel":
        return ServeCostModel(self.cfg, self.machine, scales)


def predict_serve_step(cfg: ModelConfig, *,
                       prefill: Sequence[Tuple[int, int]] = (),
                       decode_contexts: Sequence[int] = (),
                       machine: Machine = CPU_HOST,
                       scales: Optional[ServeScales] = None) -> ServeStepCost:
    """One-shot API: predicted cost of a serve step composed of chunked
    prefill entries ``(tokens, ctx0)`` and a decode batch at the given
    per-request context lengths."""
    return ServeCostModel(cfg, machine, scales).predict_step(
        prefill, decode_contexts)


# ---------------------------------------------------------------------------
# fingerprint-keyed cost-table cache (the scheduler's analog of the tuner
# plan cache): refits install fitted scales under the machine fingerprint,
# drift's revision bump re-keys the fingerprint and so starts clean.
# ---------------------------------------------------------------------------

_CACHE: Dict[tuple, ServeCostModel] = {}
_CACHE_LOCK = threading.Lock()


def _cfg_key(cfg: ModelConfig) -> tuple:
    return (cfg.name, cfg.n_layers, cfg.d_model, cfg.n_heads,
            cfg.n_kv_heads, cfg.vocab_size, cfg.dtype)


def cost_model_for(cfg: ModelConfig,
                   machine: Machine = CPU_HOST) -> ServeCostModel:
    """The cached cost model for (cfg, machine-at-current-revision)."""
    key = (machine.fingerprint(), _cfg_key(cfg))
    with _CACHE_LOCK:
        cm = _CACHE.get(key)
        if cm is None:
            cm = ServeCostModel(cfg, machine)
            _CACHE[key] = cm
        return cm


def install_scales(cfg: ModelConfig, machine: Machine,
                   scales: ServeScales) -> ServeCostModel:
    """Install refit scales for (cfg, machine) under the current
    fingerprint; returns the new cached model."""
    key = (machine.fingerprint(), _cfg_key(cfg))
    cm = ServeCostModel(cfg, machine, scales)
    with _CACHE_LOCK:
        _CACHE[key] = cm
    return cm


def cost_cache_keys() -> List[tuple]:
    with _CACHE_LOCK:
        return list(_CACHE)


# ---------------------------------------------------------------------------
# refit from telemetry serve_step records (the telemetry refit, serving tier)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ServingRefit:
    scales: ServeScales
    n_rows: int
    mean_rel_err_before: float
    mean_rel_err_after: float

    def to_dict(self) -> dict:
        return {"scales": self.scales.to_dict(), "n_rows": self.n_rows,
                "mean_rel_err_before": self.mean_rel_err_before,
                "mean_rel_err_after": self.mean_rel_err_after}


def _phase_rows(records: Iterable, phase: str) -> List[Tuple[float, float]]:
    rows = []
    for r in records:
        if getattr(r, "kind", "") != "serve_step":
            continue
        meas = r.phases.get(phase)
        pred = (r.predicted or {}).get(phase)
        if meas and pred and meas > 0 and pred > 0:
            rows.append((float(pred), float(meas)))
    return rows


def _fit_affine(rows: List[Tuple[float, float]]) -> Tuple[float, float]:
    """measured ~= a * predicted + b, robust to a few outliers: try the
    plain ratio (a = exp(median log-ratio), b = 0) and the ridge affine
    fit, keep whichever has lower mean relative error."""
    import numpy as np

    from ..core.fitting import ridge_lstsq

    pred = np.array([p for p, _ in rows])
    meas = np.array([m for _, m in rows])
    a_ratio = float(np.exp(np.median(np.log(meas / pred))))
    cands = [(a_ratio, 0.0)]
    if len(rows) >= 8 and float(pred.std()) > 1e-12 * float(pred.mean()):
        A = np.stack([pred, np.ones_like(pred)], axis=1)
        a, b = ridge_lstsq(A, meas, lam=1e-12)
        if a > 0:
            cands.append((float(a), float(max(b, 0.0))))

    def err(ab):
        a, b = ab
        return float(np.mean(np.abs(a * pred + b - meas) / meas))

    return min(cands, key=err)


def refit_serving(records: Iterable, cost_model: ServeCostModel,
                  *, install: bool = False) -> ServingRefit:
    """Fit per-phase scales from recorded (predicted, measured) serve
    steps and return the calibrated model state.

    The fit composes with whatever scales produced the recorded
    predictions: measured ~= a * pred + b updates ``scale' = a * scale``
    and ``overhead' = a * overhead + b`` per phase (the overhead constant
    is shared; the decode fit wins it since decode steps dominate).
    ``install=True`` also caches the result under the current machine
    fingerprint (:func:`install_scales`)."""
    import numpy as np

    recs = list(records)
    old = cost_model.scales
    fits = {}
    all_rows: List[Tuple[float, float]] = []
    for phase in ("prefill", "decode"):
        rows = _phase_rows(recs, phase)
        all_rows.extend(rows)
        if len(rows) >= 3:
            fits[phase] = _fit_affine(rows)
    if not all_rows:
        return ServingRefit(old, 0, float("nan"), float("nan"))

    a_pf, b_pf = fits.get("prefill", (1.0, 0.0))
    a_dc, b_dc = fits.get("decode", fits.get("prefill", (1.0, 0.0)))
    new = ServeScales(
        prefill_scale=old.prefill_scale * a_pf,
        decode_scale=old.decode_scale * a_dc,
        overhead_s=max(a_dc * old.overhead_s + b_dc, 0.0))

    pred = np.array([p for p, _ in all_rows])
    meas = np.array([m for _, m in all_rows])
    before = float(np.mean(np.abs(pred - meas) / meas))

    def after_err(phase, a, b):
        rows = _phase_rows(recs, phase)
        if not rows:
            return []
        p = np.array([x for x, _ in rows])
        m = np.array([x for _, x in rows])
        return list(np.abs(a * p + b - m) / m)

    errs = after_err("prefill", a_pf, b_pf) + after_err("decode", a_dc, b_dc)
    after = float(np.mean(errs)) if errs else before
    if install:
        install_scales(cost_model.cfg, cost_model.machine, new)
    return ServingRefit(new, len(all_rows), before, after)
