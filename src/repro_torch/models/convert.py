"""Carry the reference's parameters across into the port's decoder.

The reference keeps its parameters as a nested tree of dicts, with the
layers of each ``stack_plan`` group stacked along a leading axis (one unit
of ``inner_kinds`` per row).  ``load_reference_params`` takes that tree
with numpy arrays at its leaves, unstacks each group into the port's
``layers.<i>`` modules, and copies every leaf into the parameter of the
same dotted name: the port's modules use the reference's names (``w``,
``b``, ``scale``) and layouts, so nothing is renamed or transposed.  A key
missing on either side, or a shape or type that differs, raises.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from .transformer import Decoder, stack_plan


def _leaves(tree, prefix: str) -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _leaves(sub, f"{prefix}.{key}" if prefix else key)
    else:
        yield prefix, tree


def flatten_reference(params, cfg) -> Dict[str, np.ndarray]:
    """The reference's tree as ``{port parameter name: array}``, with the
    stacked groups split into one entry per layer."""
    out = {}
    for name, leaf in _leaves({k: v for k, v in params.items()
                               if k != "groups"}, ""):
        out[name] = leaf
    plan = stack_plan(cfg)
    groups = params.get("groups", [])
    if len(groups) != len(plan):
        raise KeyError(f"reference has {len(groups)} layer groups, the "
                       f"config's stack plan {len(plan)}")
    offset = 0
    for (_, n, kinds), unit in zip(plan, groups):
        if len(unit) != len(kinds):
            raise KeyError(f"reference unit has {len(unit)} layers, the "
                           f"stack plan {len(kinds)} ({kinds})")
        for u, stacked in enumerate(unit):
            for name, leaf in _leaves(stacked, ""):
                arr = np.asarray(leaf)
                if arr.shape[:1] != (n,):
                    raise ValueError(f"group leaf {name} has shape "
                                     f"{arr.shape}, expected {n} layers "
                                     "on its leading axis")
                for i in range(n):
                    out[f"layers.{offset + i * len(kinds) + u}.{name}"] = \
                        arr[i]
        offset += n * len(kinds)
    return out


def _to_tensor(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":     # numpy has no bf16; exact via fp32
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.tensor(arr)


@torch.no_grad()
def load_reference_params(net: Decoder, params) -> Decoder:
    """Copy the reference's parameters (numpy leaves) into ``net`` in place,
    onto each parameter's device.  Returns ``net``."""
    flat = flatten_reference(params, net.cfg)
    own = dict(net.named_parameters())
    missing = sorted(set(own) - set(flat))
    extra = sorted(set(flat) - set(own))
    if missing or extra:
        raise KeyError(f"parameter names differ: missing from the reference "
                       f"{missing[:8]}, not in the port {extra[:8]}")
    for name, p in own.items():
        src = _to_tensor(flat[name])
        if tuple(src.shape) != tuple(p.shape):
            raise ValueError(f"{name}: reference shape {tuple(src.shape)}, "
                             f"port shape {tuple(p.shape)}")
        if src.dtype != p.dtype:
            raise TypeError(f"{name}: reference type {src.dtype}, port type "
                            f"{p.dtype}")
        p.copy_(src.to(device=p.device))
    return net
