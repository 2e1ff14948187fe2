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

With a mesh (``launch/mesh.py::make_mesh`` over a ``torch.distributed``
group), ``Trainer(cfg, mesh=mesh)`` draws the whole network from the seed,
as without one, then cuts it to this rank's blocks (``Model.shard``), so a
sharded and an unsharded run start from the same weights.  Each rank takes
the batch rows at its ``("pod", "data")`` coordinate; the gradients are
averaged over those ranks at full precision (as the reference's trainer,
this one does not compress them); AdamW's moments are ZeRO-1 slices
(``optimizer.zero_slice``), and the updated slices are all-gathered over
``data``.  Checkpoints hold the reference's whole leaves: ``save``
gathers them (rank 0 writes), ``restore`` cuts them to the current mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..configs.base import ModelConfig
from ..devices import canonical, default_devices
from ..distributed import process_group as pg
from ..distributed.sharding import (P, Mesh, block_shape, dims_over,
                                    gather, leaf_zero_spec, shard_of,
                                    use_mesh)
from ..models import build_model, moe
from ..models.convert import (host_array, load_leaves, nest,
                              reference_leaves, write_rows)
from . import checkpoint as ckpt
from .data import DataConfig, DataPipeline
from .fault import (FaultInjector, RestartableLoop, RestartPolicy,
                    StragglerMonitor)
from .optimizer import (AdamState, AdamWConfig, adafactor_begin,
                        adafactor_leaf, adamw_begin, adamw_leaf, init_adamw,
                        sharded_global_norm, zero_slice, zero_unslice)


@dataclasses.dataclass
class TrainConfig:
    model: ModelConfig
    opt: AdamWConfig
    data: DataConfig
    n_steps: int = 100
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 50
    log_every: int = 10


class Layout(NamedTuple):
    """A network's layout on a mesh: the mesh, and for each reference
    leaf path its whole (stacked) shape, its spec and its moments' ZeRO-1
    spec."""
    mesh: Any
    shapes: Dict[str, tuple]
    specs: Dict[str, P]
    zero: Dict[str, P]

    def cut(self, path: str) -> bool:
        """True when the leaf is cut over ``model``."""
        return bool(dims_over(self.specs[path], "model"))


def whole_layout(net) -> Layout:
    """The layout of ``net`` held whole by one rank: a mesh of no axes,
    nothing cut."""
    shapes = {path: tuple(t.shape) for path, t in leaf_templates(net).items()}
    whole = {path: P() for path in shapes}
    return Layout(Mesh({}), shapes, whole, whole)


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
                 state: AdamState, layout: Optional[Layout] = None):
    """The optimizer step on ``net``'s parameters, one leaf of the
    reference's tree at a time (stacked, updated, written back); the
    gradients are dropped as their leaf is done.  The parameters and
    gradients are this rank's blocks under ``layout`` (default: whole, on
    one rank): AdamW updates the rank's ZeRO-1 slice and gathers the
    slices over ``data``; Adafactor gathers the leaf over ``model``,
    updates it whole and cuts it again.  Returns (new state,
    {"grad_norm", "lr"})."""
    layout = layout or whole_layout(net)
    mesh = layout.mesh
    params = dict(net.named_parameters())
    leaves = reference_leaves(net)
    gnorm = sharded_global_norm(
        ((grads[n], layout.cut(path)) for path, leaf in leaves.items()
         for n in leaf.names), mesh)
    if opt_cfg.kind == "adafactor":
        step, lr, b2 = adafactor_begin(opt_cfg, state)
    else:
        st = adamw_begin(opt_cfg, state, gnorm)
        step, lr = st.step, st.lr
    for path, leaf in leaves.items():
        if leaf.stacked:
            p = torch.stack([params[n].detach() for n in leaf.names])
            g = torch.stack([grads.pop(n) for n in leaf.names])
        else:
            p, g = params[leaf.names[0]].detach(), grads.pop(leaf.names[0])
        held = p
        if opt_cfg.kind == "adafactor":
            spec = layout.specs[path]
            full, gfull = gather(p, spec, mesh), gather(g, spec, mesh)
            adafactor_leaf(opt_cfg, lr, b2, full, gfull, state.nu[path])
            p = shard_of(full, spec, mesh)
            del full, gfull
        else:
            zspec = layout.zero[path]
            part = zero_slice(p, zspec, mesh)
            adamw_leaf(opt_cfg, st, part, zero_slice(g, zspec, mesh),
                       state.mu[path], state.nu[path])
            p = zero_unslice(part, zspec, mesh)
        # an unstacked leaf updated in place is the parameter already
        if leaf.stacked or p is not held:
            write_rows(params, leaf, p)
        del p, g, held
    return AdamState(step, state.mu, state.nu), {"grad_norm": gnorm,
                                                  "lr": lr}


#: the most elements :func:`average_over` reduces in one all-reduce
AVERAGE_BUCKET = 1 << 26


def average_over(tensors: Dict[str, torch.Tensor], group
                 ) -> Dict[str, torch.Tensor]:
    """Each tensor's mean over the ranks of ``group``, in fp32 (full
    precision), in its own type again: the tensors go flattened into
    buckets of at most ``AVERAGE_BUCKET`` elements, one all-reduce a
    bucket.  The tensors are taken out of ``tensors`` as their bucket is
    done."""
    if group is None:
        return tensors
    out, names, size = {}, [], 0

    def flush():
        flat = torch.cat([tensors[n].reshape(-1).to(torch.float32)
                          for n in names])
        flat = pg.all_reduce(flat, group, op="mean")
        off = 0
        for n in names:
            t = tensors.pop(n)
            out[n] = flat[off:off + t.numel()].view(t.shape).to(t.dtype)
            off += t.numel()

    for name, t in list(tensors.items()):
        if names and size + t.numel() > AVERAGE_BUCKET:
            flush()
            names, size = [], 0
        names.append(name)
        size += t.numel()
    if names:
        flush()
    return out


def make_train_step(model, opt_cfg: AdamWConfig, *, microbatches: int = 1,
                    accum_dtype=None):
    """``train_step(net, opt_state, batch, layout=None) -> (net,
    opt_state, metrics)``: one optimizer step, ``net``'s parameters
    updated in place.  ``microbatches`` > 1 splits the batch on its
    leading axis and accumulates the gradients (the activations shrink by
    that factor); ``accum_dtype`` defaults to fp32 for bf16 parameters.
    The metrics ("loss", "ce", "aux", "grad_norm", "lr") are 0-d tensors
    on the parameters' device.  Under a sharded ``Layout`` (``Trainer``
    with a mesh) ``batch`` is this rank's rows; the step averages the
    gradients and the metrics over the batch ranks and runs the sharded
    update."""

    def train_step(net, opt_state: AdamState, batch: Mapping[str, Any],
                   layout: Optional[Layout] = None):
        layout = layout or whole_layout(net)
        mesh = layout.mesh
        with use_mesh(mesh):
            loss, metrics, grads = _gradients(model, net, batch,
                                              microbatches, accum_dtype)
        group = mesh.group(mesh.batch_axes)
        grads = average_over(grads, group)
        means = average_over({"loss": loss, **metrics}, group)
        opt_state, opt_metrics = apply_update(opt_cfg, net, grads, opt_state,
                                              layout)
        return net, opt_state, {**means, **opt_metrics}

    return train_step


def _expanded(shape, dtype, device) -> torch.Tensor:
    """A template of ``shape`` that holds one element (a zero-stride view):
    what ``init_adamw`` and ``checkpoint.restore`` read of a leaf."""
    return torch.zeros((), dtype=dtype, device=device).expand(*shape)


class Trainer:
    """``Trainer(cfg, mesh=None, seed=, device=)``: the network drawn from
    ``seed`` on ``device`` (default: the current GPU; without one it raises
    unless the CPU is named), the optimizer's state, the data pipeline;
    ``run`` trains ``cfg.n_steps`` steps through the restartable loop,
    checkpointing into ``cfg.checkpoint_dir`` every
    ``cfg.checkpoint_every`` steps.  The network, the moments and the
    batch are this rank's shares under ``mesh`` (``layout``); without one
    the mesh has no axes and the shares are the whole."""

    def __init__(self, cfg: TrainConfig, *, mesh=None, seed: int = 0,
                 device=None):
        self.cfg = cfg
        self.device = (default_devices()[0] if device is None
                       else canonical(device))
        self.model = build_model(cfg.model)
        self.data = DataPipeline(cfg.data)
        self.mesh = Mesh({}) if mesh is None else mesh
        self.net = self.model.init(seed, device=self.device)
        #: the reference's expert-parallel test on the mesh given (MoE only)
        self.ep_works = None
        if mesh is not None and cfg.model.moe:
            with use_mesh(mesh):
                self.ep_works = moe.ep_works(cfg.model)
        templates = leaf_templates(self.net)
        shapes = {path: tuple(t.shape) for path, t in templates.items()}
        specs = self.model.shard(self.net, self.mesh)
        zero = {path: leaf_zero_spec(path, shape, self.mesh)
                for path, shape in shapes.items()}
        self.layout = Layout(self.mesh, shapes, specs, zero)
        # AdamW's moments are ZeRO-1 blocks; Adafactor's statistics, which
        # the reference's constraint does not reach, stay whole
        whole = cfg.opt.kind == "adafactor"
        self.opt_state = init_adamw(cfg.opt, {path: _expanded(
            shapes[path] if whole else block_shape(shapes[path], zero[path],
                                                   self.mesh),
            t.dtype, t.device) for path, t in templates.items()})
        self._step_fn = make_train_step(self.model, cfg.opt)
        self.step = 0
        self.monitor = StragglerMonitor()

    @property
    def rank(self) -> int:
        return self.mesh.rank

    # -- checkpoint glue ------------------------------------------------------
    def _whole_leaves(self):
        """(params, mu, nu) as ``{path: numpy array}`` of whole leaves,
        gathered over the mesh (every rank takes part)."""
        lay = self.layout
        named, params = dict(self.net.named_parameters()), {}
        for path, leaf in reference_leaves(self.net).items():
            # a layer's row at a time, stacked on the host
            spec = lay.specs[path][leaf.stacked:]
            rows = [host_array(gather(named[n].detach(), spec, lay.mesh))
                    for n in leaf.names]
            params[path] = np.stack(rows) if leaf.stacked else rows[0]
        if self.opt_state.mu is None:
            return params, None, self.opt_state.nu
        mu, nu = ({path: host_array(gather(t, lay.zero[path], lay.mesh))
                   for path, t in tree.items()}
                  for tree in (self.opt_state.mu, self.opt_state.nu))
        return params, mu, nu

    def save(self, step: int):
        """Write the reference's whole leaves (rank 0 writes; every rank
        takes part in the gathers), the mesh in the manifest."""
        if not self.cfg.checkpoint_dir:
            return
        flat, mu, nu = self._whole_leaves()
        if self.rank == 0:
            ckpt.save(self.cfg.checkpoint_dir, step,
                      {"params": nest(flat),
                       "opt": AdamState(self.opt_state.step, mu, nu)},
                      cursor=self.data.cursor(step),
                      extra_meta={"model": self.cfg.model.name,
                                  "mesh": dict(self.mesh.shape)})
        if self.mesh.groups is not None:
            dist.barrier()

    def restore(self) -> int:
        """Read the latest checkpoint's whole leaves on the host and cut
        them to this rank's blocks and ZeRO-1 slices: the elastic reshard
        onto the current mesh."""
        if not self.cfg.checkpoint_dir:
            return self.step
        step = ckpt.latest_step(self.cfg.checkpoint_dir)
        if step is None:
            return 0
        lay, cpu = self.layout, torch.device("cpu")
        dtypes = {path: t.dtype for path, t in leaf_templates(self.net).items()}
        whole = {path: _expanded(shape, dtypes[path], cpu)
                 for path, shape in lay.shapes.items()}
        st = self.opt_state
        if st.mu is None:
            opt = AdamState(st.step, None, st.nu)
        else:
            opt = AdamState(st.step, *({path: _expanded(lay.shapes[path],
                                                        t.dtype, cpu)
                                        for path, t in tree.items()}
                                       for tree in (st.mu, st.nu)))
        trees, manifest = ckpt.restore(self.cfg.checkpoint_dir,
                                       {"params": whole, "opt": opt},
                                       step=step)
        load_leaves(self.net, {path: shard_of(full, lay.specs[path],
                                              lay.mesh)
                               for path, full in trees["params"].items()})
        got = trees["opt"]
        if got.mu is None:
            self.opt_state = got
        else:
            mu, nu = ({path: shard_of(full, lay.zero[path],
                                      lay.mesh).to(self.device)
                       for path, full in tree.items()}
                      for tree in (got.mu, got.nu))
            self.opt_state = AdamState(got.step, mu, nu)
        self.step = manifest["cursor"].get("step", step)
        return self.step

    # -- loop ----------------------------------------------------------------
    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        """The pipeline's batch of ``step`` on the trainer's device; under
        a mesh, this rank's rows of it."""
        return {k: v.to(self.device, non_blocking=True)
                for k, v in self.rows(self.data.batch_at(step)).items()}

    def rows(self, batch: Mapping[str, Any]) -> Dict[str, Any]:
        """This rank's share of a global batch: the rows at its
        ``("pod", "data")`` coordinate (all of them without a mesh)."""
        if not self.mesh.batch_axes:
            return dict(batch)
        axes = self.mesh.batch_axes
        n, i = self.mesh.axis_size(axes), self.mesh.axis_index(axes)
        out = {}
        for k, v in batch.items():
            if v.shape[0] % n:
                raise ValueError(f"batch of {v.shape[0]} rows does not split "
                                 f"over {n} batch ranks")
            size = v.shape[0] // n
            out[k] = v[i * size:(i + 1) * size]
        return out

    def train_step(self, batch: Mapping[str, torch.Tensor]) -> dict:
        """One optimizer step on ``batch`` (this rank's rows under a mesh:
        ``batch_at``, ``rows``); returns its metrics (tensors)."""
        self.net, self.opt_state, metrics = self._step_fn(
            self.net, self.opt_state, batch, self.layout)
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
