"""One rank's step of every (arch x shape) dry-run cell, and its arguments.

``step_and_specs(arch, shape, mesh)`` returns, as the reference's does:

    step_fn     -- the function to run: ``step_fn(*args)``
    args        -- this rank's arguments, tensors on ``device`` (``meta`` by
                   default: shapes and types, no memory): its parameter
                   blocks, its optimizer state (ZeRO-1 AdamW moments or
                   Adafactor's statistics) and its batch rows
    model_flops -- 6*N_active*D for train, 2*N_active*D for inference cells
    meta        -- notes (precision policy, FSDP, microbatches, ...)

The rank's network and optimizer state are built by the code the
``Trainer`` builds them with (``training/trainer.py::rank_state``), with no
weights drawn, and cut to the rank's blocks on ``mesh`` (a
``launch/mesh.py::counting_mesh`` in the dry run).  A decode cell's step is
``serving/engine.py::make_serve_step`` on the mesh: the rank's network, its
blocks of the decode caches at ``cache_len`` slots (``min(seq, window)``
for a windowed arch, as the reference's) and one new token a row of its
batch, with the cross-attention memory (the encoder's states, the image
embeddings; rows over the batch axes) where the arch has one.

Profiles (:data:`PROFILES`, the reference's dicts): the mesh carries the
profile's rules (``Mesh.rules``; the dry run builds its mesh with
``rules_for(arch, profile)``), and the rank's layout and step follow them.
``baseline`` is tensor (and expert) parallelism over ``model`` with the
batch over ``("pod", "data")``; ``dp_sp`` cuts nothing over ``model`` but
the batch (over ``("pod", "data", "model")`` where it divides) and the
ZeRO-1 / FSDP blocks (over ``("data", "model")``), with FSDP required
where the whole parameters take more than 4 GB a rank; ``seq_sp`` is the
baseline with the residual stream cut on the sequence over ``model``
between blocks (Megatron-SP; a decode step's one position does not divide
and runs as under ``baseline``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch

from ..configs import SHAPES, get
from ..configs.base import ModelConfig, ShapeConfig
from ..distributed.sharding import use_mesh
from ..launch.prefill import make_prefill_step, stub_shapes
from ..models import build_model
from ..models.layers import dtype_of
from ..serving.engine import make_serve_step
from ..training.optimizer import AdamWConfig
from ..training.trainer import make_train_step, rank_state

def wants_fsdp(cfg: ModelConfig, mesh) -> bool:
    """FSDP is *required* (parameters sharded over the data axes too, the
    ZeRO-3 / 2.5D-style trade of communication for memory) when tensor
    parallelism alone leaves > 4 GB a rank of parameters."""
    model_ways = mesh.shape.get("model", 1)
    per_dev = cfg.param_count() * 2 / model_ways
    return per_dev > 4e9


def choose_fsdp(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                required: bool) -> bool:
    """The layout choice routed through the tuner: FSDP when memory
    requires it, else, for train shapes, when the LM-step model predicts
    the per-layer all-gathers pay for themselves (cached in the plan cache
    like any linalg plan).  Serving shapes get FSDP only when required:
    the model prices a training step."""
    if shape.kind != "train":
        return required
    from ..tuner import default_tuner
    try:
        return default_tuner().recommend_fsdp(cfg, shape, dict(mesh.shape),
                                              required=required)
    except Exception:  # the model consult must never break a dry run
        return required


#: sharding profiles (the reference's), applied as a mesh's rules
PROFILES = {
    # the default TP(+EP) x DP layout
    "baseline": lambda cfg: {},
    # pure data / fully-sharded parallelism: no tensor parallelism; the
    # batch over every axis, the ZeRO-1 (and FSDP) blocks over data and
    # model
    "dp_sp": lambda cfg: {"batch": ("pod", "data", "model"), "heads": None,
                          "kv_heads": None, "ff": None, "vocab": None,
                          "experts": None, "zero": ("data", "model")},
    # Megatron-SP: the residual stream sequence-cut over 'model' between
    # blocks, the whole sequence gathered into each block
    "seq_sp": lambda cfg: {"seq": "model"},
}


def rules_for(arch: str, profile: str = "baseline") -> dict:
    return PROFILES[profile](get(arch))


def opt_config_for(cfg: ModelConfig) -> AdamWConfig:
    """Optimizer and precision policy by scale: below 80B parameters AdamW
    with fp32 moments; 80-250B AdamW with bf16 moments; from 250B
    Adafactor (a factored second moment)."""
    n = cfg.param_count()
    if n >= 250e9:
        return AdamWConfig(kind="adafactor")
    return AdamWConfig(state_dtype="bfloat16" if n >= 80e9 else "float32")


def microbatches(cfg: ModelConfig, shape: ShapeConfig, mesh) -> int:
    """At most ~2 GB a rank of rematerialization stash: the batch split
    in powers of two until it fits."""
    chips = 1
    for v in mesh.shape.values():
        chips *= v
    stash = (cfg.n_layers * shape.global_batch * shape.seq_len
             * cfg.d_model * 2 / chips)
    micro = 1
    while stash / micro > 2.2e9 and micro < shape.global_batch:
        micro *= 2
    return micro


def cell_meta(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """(meta, model_flops) of a cell: what the reference's
    ``step_and_specs`` records, without building anything."""
    meta: Dict[str, Any] = {"arch": cfg.name, "shape": shape.name,
                            "kind": shape.kind}
    # without tensor parallelism (dp_sp) every rank holds the whole
    # parameters: FSDP where they take more than 4 GB
    no_tp = mesh.rules.get("heads") is None
    meta["fsdp"] = choose_fsdp(cfg, shape, mesh, required=wants_fsdp(
        cfg, mesh) or (no_tp and cfg.param_count() * 2 > 4e9))
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        opt_cfg = opt_config_for(cfg)
        meta["opt_state_dtype"] = opt_cfg.state_dtype
        meta["microbatches"] = microbatches(cfg, shape, mesh)
        meta["grad_accum_dtype"] = opt_cfg.state_dtype
        model_flops = 6.0 * n_active * tokens
    elif shape.kind == "prefill":
        model_flops = 2.0 * n_active * tokens
    else:
        meta["cache_len"] = (min(shape.seq_len, cfg.sliding_window)
                             if cfg.sliding_window else shape.seq_len)
        model_flops = 2.0 * n_active * shape.global_batch
    meta["params"] = int(cfg.param_count())
    meta["active_params"] = int(n_active)
    return meta, model_flops


def batch_rows(shape: ShapeConfig, mesh) -> int:
    """This rank's rows of the global batch: split over the rules' batch
    axes that ``valid_spec`` keeps on it (``Mesh.for_batch``), the others
    holding the same rows."""
    rows = mesh.for_batch(shape.global_batch)
    return shape.global_batch // rows.axis_size(rows.batch_axes)


def rank_batch(cfg: ModelConfig, shape: ShapeConfig, mesh, device
               ) -> Dict[str, torch.Tensor]:
    """This rank's batch, zeros on ``device``: tokens (and labels for
    train) of the cell's length (one token for decode), and the stub
    inputs the arch takes (for decode: the memory its cross-attention
    reads, of the stub's shape)."""
    rows = batch_rows(shape, mesh)
    z = dict(dtype=torch.int32, device=device)
    seq = 1 if shape.kind == "decode" else shape.seq_len
    out = {"tokens": torch.zeros((rows, seq), **z)}
    if shape.kind == "train":
        out["labels"] = torch.zeros((rows, shape.seq_len), **z)
    for name, tail in stub_shapes(cfg).items():
        out[name] = torch.zeros((rows, *tail), dtype=dtype_of(cfg.dtype),
                                device=device)
    return out


def step_and_specs(arch: str, shape_name: str, mesh, *, device="meta",
                   layers: Optional[int] = None):
    """(step_fn, args, model_flops, meta) of rank ``mesh.rank``'s step of
    the cell (module docstring), under the mesh's rules.  ``layers`` cuts
    the depth (the record says so in ``meta["layers"]``)."""
    cfg = get(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    shape = SHAPES[shape_name]
    meta, model_flops = cell_meta(cfg, shape, mesh)
    mesh = mesh.for_batch(shape.global_batch)
    meta["layers"] = cfg.n_layers
    model = build_model(cfg)
    device = torch.device(device)
    opt_cfg = opt_config_for(cfg) if shape.kind == "train" else None
    net, layout, opt_state = rank_state(model, opt_cfg, mesh, seed=None,
                                        device=device, fsdp=meta["fsdp"])
    batch = rank_batch(cfg, shape, mesh, device)
    meta["rank"] = mesh.rank
    meta["batch_rows"] = batch["tokens"].shape[0]
    if shape.kind == "train":
        accum = (torch.bfloat16 if opt_cfg.state_dtype == "bfloat16"
                 else None)
        # the reference's microbatches split the global batch; the rank
        # runs as many as divide its rows (dp_sp: one row, one microbatch)
        meta["microbatches_run"] = math.gcd(meta["microbatches"],
                                            meta["batch_rows"])
        train = make_train_step(model, opt_cfg,
                                microbatches=meta["microbatches_run"],
                                accum_dtype=accum)

        def step_fn(net, opt_state, batch):
            return train(net, opt_state, batch, layout)

        return step_fn, (net, opt_state, batch), model_flops, meta
    if shape.kind == "decode":
        caches = model.init_cache(shape.global_batch, meta["cache_len"],
                                  device=device, mesh=mesh)
        memory = next((v for k, v in batch.items() if k != "tokens"), None)
        serve = make_serve_step(model, mesh)

        def step_fn(net, tokens, caches, memory=None):
            return serve(net, tokens, caches, memory)

        return (step_fn, (net, batch["tokens"], caches, memory), model_flops,
                meta)
    prefill = make_prefill_step(model)

    def step_fn(net, batch):
        with use_mesh(mesh):
            return prefill(net, batch["tokens"],
                           **{k: v for k, v in batch.items()
                              if k != "tokens"})

    return step_fn, (net, batch), model_flops, meta
