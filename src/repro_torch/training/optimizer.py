"""AdamW and Adafactor at the reference's leaf granularity.

The reference updates the leaves of its parameter tree, in which each
group's layers are stacked on a leading axis, and three of its rules read a
leaf's shape: weight decay applies to leaves of two or more dimensions (so
every stacked per-layer norm scale and bias is decayed), Adafactor factors
a leaf whose last two dimensions are at least 8 (a stacked (L, D) scale
when L >= 8), and Adafactor's RMS update clip is taken over the whole leaf.
The port keeps one module a layer, so these functions take the reference's
leaves: mappings ``{path: tensor}`` of stacked tensors
(``models/convert.py::reference_leaves`` names the rows; the trainer stacks
them and writes the rows back).

The update runs in place on the tensors given (the reference donates its
buffers) and returns them.  AdamW's elementwise math runs a block of rows
of a leaf at a time, which rounds as the whole leaf would and bounds its
fp32 temporaries.

ZeRO-1 under a mesh (the reference's ``_zero_constrain``): AdamW's moments
are kept per ``zero_spec`` of the stacked leaf's spec, the ``data`` axis
added on one replicated dimension, so each rank holds its ``data`` slice of
its ``model`` block (:func:`zero_slice`); the update runs on that slice and
the updated parameter slices are all-gathered over ``data``
(:func:`zero_unslice`).  Adafactor's statistics are not reached by the
reference's constraint and stay whole on every rank.
:func:`sharded_global_norm` counts each leaf's distinct blocks once.
"""

from __future__ import annotations

import dataclasses
import math
from typing import (Any, Iterable, Mapping, NamedTuple, Optional, Tuple,
                    Union)

import torch

from ..distributed import process_group as pg
from ..distributed.sharding import dims_over

_STATE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
#: elements of a leaf that AdamW's math takes at once (whole rows)
_BLOCK = 1 << 26


class AdamState(NamedTuple):
    step: torch.Tensor      # () int32
    mu: Any                 # {path: tensor}; None for Adafactor
    nu: Any                 # {path: tensor}; Adafactor: {path: {"vr", "vc"}
    #                         or {"v"}}


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    zero_sharding: bool = True
    # "adamw" | "adafactor": factored second moment (Shazeer & Stern), no
    # first moment
    kind: str = "adamw"


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_ratio``; fp32, on the
    step's device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] >= 8 and shape[-2] >= 8


def init_adamw(cfg: AdamWConfig, params: Mapping[str, torch.Tensor]
               ) -> AdamState:
    """Zero moments shaped like ``params`` (only their shapes and devices
    are read), and step 0 on the first leaf's device."""
    device = next(iter(params.values())).device
    step = torch.zeros((), dtype=torch.int32, device=device)
    if cfg.kind == "adafactor":
        def fstate(p):
            if _factored(p.shape):
                return {"vr": torch.zeros(p.shape[:-1], device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          device=p.device)}
            return {"v": torch.zeros(p.shape, device=p.device)}
        return AdamState(step, None, {k: fstate(p) for k, p in params.items()})
    dt = _STATE_DTYPES[cfg.state_dtype]
    mu = {k: torch.zeros(p.shape, dtype=dt, device=p.device)
          for k, p in params.items()}
    nu = {k: torch.zeros_like(m) for k, m in mu.items()}
    return AdamState(step, mu, nu)


def global_norm(tensors: Union[Mapping[str, torch.Tensor],
                               Iterable[torch.Tensor]]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32."""
    if isinstance(tensors, Mapping):
        tensors = tensors.values()
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tensors))


def sharded_global_norm(blocks: Iterable[Tuple[torch.Tensor, bool]],
                        mesh) -> torch.Tensor:
    """The global norm of a model held in blocks: ``blocks`` yields (a
    gradient block, whether its leaf is cut over ``model``).  The squares
    of a leaf replicated over ``model`` are counted on the first
    ``model`` rank only, then the sum is all-reduced over ``model`` (the
    ``data`` ranks hold the same averaged gradients)."""
    first = mesh.coords.get("model", 0) == 0
    total = None
    for g, cut in blocks:
        if not (cut or first):
            continue
        sq = torch.sum(torch.square(g.to(torch.float32)))
        total = sq if total is None else total + sq
    if total is None:
        raise ValueError("no gradient blocks")
    group = mesh.group("model")
    if group is not None:
        total = pg.all_reduce(total, group)
    return torch.sqrt(total)


def zero_dim(zspec) -> Optional[int]:
    """The dimension a ZeRO-1 spec cuts over ``data``, or None."""
    dims = dims_over(zspec, "data")
    return dims[0] if dims else None


def zero_slice(x: torch.Tensor, zspec, mesh) -> torch.Tensor:
    """This rank's ``data`` slice of ``x`` (its ``model`` block of a
    stacked leaf) under the ZeRO-1 spec ``zspec``: a view, ``x`` itself
    where the spec does not cut over ``data``."""
    dim = zero_dim(zspec)
    if dim is None:
        return x
    n = mesh.shape["data"]
    size = x.shape[dim] // n
    return x.narrow(dim, mesh.coords["data"] * size, size)


def zero_unslice(part: torch.Tensor, zspec, mesh) -> torch.Tensor:
    """The ``model`` block from every ``data`` rank's slice: the inverse
    of :func:`zero_slice`, an all-gather over ``data``."""
    dim = zero_dim(zspec)
    group = mesh.group("data") if dim is not None else None
    if group is None:
        return part
    return pg.all_gather(part, group, dim=dim)


class AdamStep(NamedTuple):
    """The scalars of one AdamW step, shared by every leaf."""
    step: torch.Tensor
    lr: torch.Tensor
    scale: torch.Tensor      # the global-norm clip, in the math's type
    lr_t: torch.Tensor
    bc1: torch.Tensor
    bc2: torch.Tensor
    mdt: torch.dtype


def adamw_begin(cfg: AdamWConfig, state: AdamState,
                gnorm: torch.Tensor) -> AdamStep:
    """The step's count, learning rate, clip and bias corrections.  When
    the moments are bf16 the math runs in bf16 too, as in the reference."""
    step = state.step + 1
    mdt = torch.bfloat16 if cfg.state_dtype == "bfloat16" else torch.float32
    scale = (torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
             if cfg.grad_clip else torch.ones((), device=gnorm.device))
    lr = lr_at(cfg, step)
    stepf = step.to(torch.float32)
    return AdamStep(step, lr, scale.to(mdt), lr.to(mdt),
                    (1 - cfg.b1 ** stepf).to(mdt),
                    (1 - cfg.b2 ** stepf).to(mdt), mdt)


def adamw_leaf(cfg: AdamWConfig, st: AdamStep, p: torch.Tensor,
               g: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor) -> None:
    """One leaf's update, in place on p, mu and nu; weight decay where the
    leaf has two or more dimensions."""
    decay = cfg.weight_decay and p.ndim >= 2
    rows = max(1, _BLOCK // max(p[0].numel(), 1)) if p.ndim else 1
    blocks = (range(0, p.shape[0], rows) if p.ndim else [None])
    for r0 in blocks:
        sl = slice(None) if r0 is None else slice(r0, r0 + rows)
        pb, mb, nb = p[sl], mu[sl], nu[sl]
        gb = g[sl].to(st.mdt) * st.scale
        mu_n = mb.to(st.mdt) * cfg.b1 + (1.0 - cfg.b1) * gb
        nu_n = nb.to(st.mdt) * cfg.b2 + (1.0 - cfg.b2) * gb * gb
        delta = (mu_n / st.bc1) / (torch.sqrt(nu_n / st.bc2) + cfg.eps)
        if decay:
            delta = delta + cfg.weight_decay * pb.to(st.mdt)
        pb.copy_(pb.to(st.mdt) - st.lr_t * delta)
        mb.copy_(mu_n)
        nb.copy_(nu_n)


def adafactor_begin(cfg: AdamWConfig, state: AdamState):
    """(step, lr, b2) of one Adafactor step: b2 = 1 - (step + 1)^-0.8."""
    step = state.step + 1
    return step, lr_at(cfg, step), 1.0 - (step.to(torch.float32) + 1.0) ** -0.8


def adafactor_leaf(cfg: AdamWConfig, lr, b2, p: torch.Tensor,
                   g: torch.Tensor, v: dict) -> None:
    """One leaf's Adafactor update (factored second moment, no first
    moment, the update clipped at RMS 1 over the whole leaf), in place on
    p and the accumulators in ``v``.  The full-size math runs in the
    parameter's type when that is bf16, else fp32; the accumulators are
    fp32."""
    eps = 1e-30
    mdt = p.dtype if p.dtype == torch.bfloat16 else torch.float32
    g2 = torch.square(g.to(torch.float32))
    if "vr" in v:
        vr = v["vr"] * b2 + (1 - b2) * (torch.mean(g2, dim=-1) + eps)
        vc = v["vc"] * b2 + (1 - b2) * (torch.mean(g2, dim=-2) + eps)
        r = torch.rsqrt(torch.clamp(
            vr / torch.clamp(vr.mean(dim=-1, keepdim=True), min=eps),
            min=eps))
        c = torch.rsqrt(torch.clamp(vc, min=eps))
        u = g.to(mdt) * r[..., :, None].to(mdt) * c[..., None, :].to(mdt)
        v["vr"].copy_(vr)
        v["vc"].copy_(vc)
    else:
        vfull = v["v"] * b2 + (1 - b2) * g2
        u = g.to(mdt) * torch.rsqrt(torch.clamp(vfull, min=eps)).to(mdt)
        v["v"].copy_(vfull)
    rms = torch.sqrt(torch.mean(torch.square(u.to(torch.float32))) + eps)
    u = u / torch.clamp(rms, min=1.0).to(mdt)
    if cfg.weight_decay and p.ndim >= 2:
        u = u + cfg.weight_decay * p.to(mdt)
    p.copy_(p.to(mdt) - lr.to(mdt) * u)


def adafactor_update(cfg: AdamWConfig, grads: Mapping[str, torch.Tensor],
                     state: AdamState, params: Mapping[str, torch.Tensor]):
    """Adafactor on the reference's leaves, in place.  Returns (params,
    state, {"grad_norm", "lr"})."""
    step, lr, b2 = adafactor_begin(cfg, state)
    for k, p in params.items():
        adafactor_leaf(cfg, lr, b2, p, grads[k], state.nu[k])
    return params, AdamState(step, None, state.nu), {
        "grad_norm": global_norm(grads), "lr": lr}


def adamw_update(cfg: AdamWConfig, grads: Mapping[str, torch.Tensor],
                 state: AdamState, params: Mapping[str, torch.Tensor]):
    """AdamW (or Adafactor, by ``cfg.kind``) on the reference's leaves, in
    place.  Returns (params, state, {"grad_norm", "lr"})."""
    if cfg.kind == "adafactor":
        return adafactor_update(cfg, grads, state, params)
    gnorm = global_norm(grads)
    st = adamw_begin(cfg, state, gnorm)
    for k, p in params.items():
        adamw_leaf(cfg, st, p, grads[k], state.mu[k], state.nu[k])
    return params, AdamState(st.step, state.mu, state.nu), {
        "grad_norm": gnorm, "lr": st.lr}
