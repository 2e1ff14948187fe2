"""Checkpoints with an atomic commit, in the reference's layout.

Layout (one directory a step):

    <dir>/step_00000123/
        manifest.json     step, arrays (shape, dtype), cursor, process count
        arrays.npz        {"<tree>::<path>": host array}
    <dir>/LATEST          the name of the newest committed step directory

A save writes into ``step_X.tmp``, syncs the manifest, renames the
directory to ``step_X`` and then replaces LATEST, so a crash at any point
leaves a consistent store (rename is atomic on POSIX); ``keep`` bounds the
committed steps kept.  Keys are ``"<tree>::<path>"`` with the reference's
'/'-joined tree paths (``models/convert.py::tree_paths``), and the trainer
saves the reference's stacked trees, so each package restores the other's
``params`` and ``opt``.  numpy has no bf16: a bf16 tensor is written as
fp32 (exactly), and a bf16 array the reference wrote (2-byte records when
read back without its dtype library) is read as bf16 bits; either is cast
to the template's type on restore.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..models.convert import host_array, tree_paths


def save(directory: str, step: int, trees: Dict[str, Any], *,
         cursor: Optional[dict] = None, keep: int = 3,
         extra_meta: Optional[dict] = None) -> str:
    """trees: {"params": ..., "opt": ..., ...}, trees of tensors or numpy
    arrays.  Returns the committed step's directory."""
    os.makedirs(directory, exist_ok=True)
    name = f"step_{step:08d}"
    tmp = os.path.join(directory, name + ".tmp")
    final = os.path.join(directory, name)
    if os.path.exists(final):          # already committed: idempotent
        return final
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    flat: Dict[str, np.ndarray] = {}
    meta_arrays = {}
    for tree_name, tree in trees.items():
        for path, leaf in tree_paths(tree):
            key = f"{tree_name}::{path}"
            arr = host_array(leaf)
            flat[key] = arr
            meta_arrays[key] = {"shape": list(arr.shape),
                                "dtype": str(arr.dtype)}
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    manifest = {
        "step": step,
        "time": time.time(),
        "arrays": meta_arrays,
        "cursor": cursor or {},
        "process_count": 1,
        "extra": extra_meta or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, final)
    with open(os.path.join(directory, "LATEST.tmp"), "w") as f:
        f.write(name)
        f.flush()
        os.fsync(f.fileno())
    os.replace(os.path.join(directory, "LATEST.tmp"),
               os.path.join(directory, "LATEST"))
    _gc(directory, keep)
    return final


def _gc(directory: str, keep: int):
    steps = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    latest = os.path.join(directory, "LATEST")
    if not os.path.exists(latest):
        return None
    with open(latest) as f:
        name = f.read().strip()
    if not os.path.exists(os.path.join(directory, name, "manifest.json")):
        return None
    return int(name.split("_")[1])


def _like(arr: np.ndarray, template):
    """``arr`` in the template leaf's type: a tensor on its device for a
    tensor template, else a numpy array."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:      # bf16 bits
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    if isinstance(template, torch.Tensor):
        return t.to(device=template.device, dtype=template.dtype)
    return host_array(t).astype(np.asarray(template).dtype)


def restore(directory: str, templates: Dict[str, Any], *,
            step: Optional[int] = None):
    """templates: {"params": tree of tensors or arrays (structure, shapes
    and types), ...}.  Returns (trees rebuilt like the templates, with each
    leaf in its template's type and on its device, manifest).  A key
    missing from the checkpoint, or a shape that differs, raises."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    out = {}
    with np.load(os.path.join(d, "arrays.npz")) as data:
        for tree_name, template in templates.items():
            loaded = {}
            for path, leaf in tree_paths(template):
                key = f"{tree_name}::{path}"
                if key not in data:
                    raise KeyError(f"checkpoint missing {key}")
                arr = data[key]
                want_shape = tuple(leaf.shape)
                if tuple(arr.shape) != want_shape:
                    raise ValueError(f"{key}: shape {arr.shape} != "
                                     f"{want_shape}")
                loaded[path] = _like(arr, leaf)
            out[tree_name] = _rebuild_like(template, loaded)
    return out, manifest


def _rebuild_like(template, flat: Dict[str, Any], prefix=""):
    if isinstance(template, dict):
        return {k: _rebuild_like(v, flat, f"{prefix}/{k}" if prefix else str(k))
                for k, v in template.items()}
    if hasattr(template, "_fields"):
        return type(template)(*(
            _rebuild_like(getattr(template, k), flat,
                          f"{prefix}/{k}" if prefix else str(k))
            for k in template._fields))
    if isinstance(template, (list, tuple)):
        return type(template)(
            _rebuild_like(v, flat, f"{prefix}/{i}" if prefix else str(i))
            for i, v in enumerate(template))
    if template is None:
        return None
    return flat[prefix]
