"""The training loop: the train step (the loss, its gradients, and AdamW
or Adafactor at the reference's leaf granularity) wired to the data
pipeline, checkpoints, the straggler monitor and the restartable loop.

    tr = Trainer(TrainConfig(model=cfg, opt=AdamWConfig(), data=DataConfig(
        vocab_size=cfg.vocab_size, seq_len=4096, global_batch=1)))
    report = tr.run()            # on the current GPU; device="cpu" to name it

The network keeps one module a layer; the optimizer's moments are kept as
the reference keeps them, one tensor a leaf of its tree with each group's
layers stacked (``models/convert.py::reference_leaves``), so the update
applies the reference's shape rules and the checkpoints are the
reference's.  A step stacks one leaf's parameters and gradients at a time,
updates them, and writes the rows back.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import torch

from ..configs.base import ModelConfig
from ..devices import canonical, default_devices
from ..models import build_model
from ..models.convert import (load_leaves, reference_leaves, to_reference,
                              write_rows)
from . import checkpoint as ckpt
from .data import DataConfig, DataPipeline
from .fault import (FaultInjector, RestartableLoop, RestartPolicy,
                    StragglerMonitor)
from .optimizer import (AdamState, AdamWConfig, adafactor_begin,
                        adafactor_leaf, adamw_begin, adamw_leaf, global_norm,
                        init_adamw)


@dataclasses.dataclass
class TrainConfig:
    model: ModelConfig
    opt: AdamWConfig
    data: DataConfig
    n_steps: int = 100
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 50
    log_every: int = 10


def leaf_templates(net) -> Dict[str, torch.Tensor]:
    """``{reference leaf path: a tensor of the leaf's shape, type and
    device}``: for a stacked leaf its first row expanded (a view, no
    copy)."""
    params = dict(net.named_parameters())
    out = {}
    for path, leaf in reference_leaves(net).items():
        p = params[leaf.names[0]].detach()
        out[path] = p.expand(len(leaf.names), *p.shape) if leaf.stacked else p
    return out


def _gradients(model, net, batch, microbatches: int, accum_dtype):
    """(loss, {"ce", "aux"}, {name: gradient}) of the batch, split into
    ``microbatches`` on the leading axis with the gradients summed in an
    accumulator (fp32 for bf16 parameters unless ``accum_dtype``)."""
    names, params = zip(*net.named_parameters())
    device = params[0].device

    def grads_of(b):
        # the parameters' device is the default one in the forward, so that
        # what torch.utils.checkpoint allocates for its own bookkeeping
        # (empty tensors, made without a device) stays off the host
        with torch.device(device):
            loss, metrics = model.loss(net, b)
        gs = torch.autograd.grad(loss, params, allow_unused=True)
        gs = [torch.zeros_like(p) if g is None else g
              for p, g in zip(params, gs)]
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, gs

    if microbatches == 1:
        loss, metrics, gs = grads_of(batch)
        return loss, metrics, dict(zip(names, gs))
    n = next(iter(batch.values())).shape[0] // microbatches
    acc = [torch.zeros(p.shape, device=p.device, dtype=accum_dtype or (
        torch.float32 if p.dtype == torch.bfloat16 else p.dtype))
        for p in params]
    loss = 0.0
    metrics: Dict[str, Any] = {}
    for i in range(microbatches):
        part = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
        l, m, gs = grads_of(part)
        for a, g in zip(acc, gs):
            a.add_(g.to(a.dtype))
        loss = loss + l
        for k, v in m.items():
            metrics[k] = metrics.get(k, 0.0) + v
        del gs
    grads = {name: a / microbatches for name, a in zip(names, acc)}
    return (loss / microbatches,
            {k: v / microbatches for k, v in metrics.items()}, grads)


@torch.no_grad()
def apply_update(opt_cfg: AdamWConfig, net, grads: Dict[str, torch.Tensor],
                 state: AdamState):
    """The optimizer step on ``net``'s parameters, one leaf of the
    reference's tree at a time (stacked, updated, written back); the
    gradients are dropped as their leaf is done.  Returns (new state,
    {"grad_norm", "lr"})."""
    params = dict(net.named_parameters())
    gnorm = global_norm(grads.values())
    if opt_cfg.kind == "adafactor":
        step, lr, b2 = adafactor_begin(opt_cfg, state)
    else:
        st = adamw_begin(opt_cfg, state, gnorm)
        step, lr = st.step, st.lr
    for path, leaf in reference_leaves(net).items():
        if leaf.stacked:
            p = torch.stack([params[n].detach() for n in leaf.names])
            g = torch.stack([grads.pop(n) for n in leaf.names])
        else:
            p, g = params[leaf.names[0]].detach(), grads.pop(leaf.names[0])
        if opt_cfg.kind == "adafactor":
            adafactor_leaf(opt_cfg, lr, b2, p, g, state.nu[path])
        else:
            adamw_leaf(opt_cfg, st, p, g, state.mu[path], state.nu[path])
        if leaf.stacked:
            write_rows(params, leaf, p)
        del p, g
    return AdamState(step, state.mu, state.nu), {"grad_norm": gnorm,
                                                  "lr": lr}


def make_train_step(model, opt_cfg: AdamWConfig, *, microbatches: int = 1,
                    accum_dtype=None):
    """``train_step(net, opt_state, batch) -> (net, opt_state, metrics)``:
    one optimizer step, ``net``'s parameters updated in place.
    ``microbatches`` > 1 splits the batch on its leading axis and
    accumulates the gradients (the activations shrink by that factor);
    ``accum_dtype`` defaults to fp32 for bf16 parameters.  The metrics
    ("loss", "ce", "aux", "grad_norm", "lr") are 0-d tensors on the
    parameters' device."""

    def train_step(net, opt_state: AdamState, batch: Mapping[str, Any]):
        loss, metrics, grads = _gradients(model, net, batch, microbatches,
                                          accum_dtype)
        opt_state, opt_metrics = apply_update(opt_cfg, net, grads, opt_state)
        return net, opt_state, {"loss": loss, **metrics, **opt_metrics}

    return train_step


class Trainer:
    """``Trainer(cfg, seed=, device=)``: the network drawn from ``seed`` on
    ``device`` (default: the current GPU; without one it raises unless the
    CPU is named), the optimizer's state, the data pipeline; ``run`` trains
    ``cfg.n_steps`` steps through the restartable loop, checkpointing into
    ``cfg.checkpoint_dir`` every ``cfg.checkpoint_every`` steps."""

    def __init__(self, cfg: TrainConfig, *, seed: int = 0, device=None):
        self.cfg = cfg
        self.device = (default_devices()[0] if device is None
                       else canonical(device))
        self.model = build_model(cfg.model)
        self.data = DataPipeline(cfg.data)
        self.net = self.model.init(seed, device=self.device)
        self.opt_state = init_adamw(cfg.opt, leaf_templates(self.net))
        self._step_fn = make_train_step(self.model, cfg.opt)
        self.step = 0
        self.monitor = StragglerMonitor()

    # -- checkpoint glue ------------------------------------------------------
    def save(self, step: int):
        if not self.cfg.checkpoint_dir:
            return
        params = to_reference(dict(self.net.named_parameters()), self.net)
        ckpt.save(self.cfg.checkpoint_dir, step,
                  {"params": params, "opt": self.opt_state},
                  cursor=self.data.cursor(step),
                  extra_meta={"model": self.cfg.model.name})

    def restore(self) -> int:
        if not self.cfg.checkpoint_dir:
            return self.step
        step = ckpt.latest_step(self.cfg.checkpoint_dir)
        if step is None:
            return 0
        trees, manifest = ckpt.restore(
            self.cfg.checkpoint_dir,
            {"params": leaf_templates(self.net), "opt": self.opt_state})
        load_leaves(self.net, trees["params"])
        self.opt_state = trees["opt"]
        self.step = manifest["cursor"].get("step", step)
        return self.step

    # -- loop ----------------------------------------------------------------
    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        """The pipeline's batch of ``step`` on the trainer's device."""
        return {k: v.to(self.device, non_blocking=True)
                for k, v in self.data.batch_at(step).items()}

    def train_step(self, batch: Mapping[str, torch.Tensor]) -> dict:
        """One optimizer step on ``batch``; returns its metrics (tensors)."""
        self.net, self.opt_state, metrics = self._step_fn(
            self.net, self.opt_state, batch)
        return metrics

    def run(self, fault_injector: Optional[FaultInjector] = None) -> dict:
        history = []

        def step_fn(step: int) -> Dict[str, Any]:
            if fault_injector is not None:
                fault_injector.maybe_fail(step)
            metrics = self.train_step(self.batch_at(step))
            out = {k: float(v) for k, v in metrics.items()}
            if step % self.cfg.log_every == 0:
                history.append({"step": step, **out})
            return out

        loop = RestartableLoop(RestartPolicy(max_restarts=5),
                               monitor=self.monitor,
                               checkpoint_every=self.cfg.checkpoint_every)
        report = loop.run(n_steps=self.cfg.n_steps, step_fn=step_fn,
                          save_fn=self.save, restore_fn=self.restore)
        report["logged"] = history
        return report
