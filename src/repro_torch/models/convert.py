"""Carry the reference's parameters across into the port's network.

The reference keeps its parameters as a nested tree of dicts, with the
layers of each ``stack_plan`` group stacked along a leading axis (one unit
of ``inner_kinds`` per row); the encoder-decoder stacks ``enc_layers`` and
``dec_layers`` the same way, one layer a row.  ``load_reference_params``
takes that tree with numpy arrays at its leaves, unstacks the layers into
the port's ``layers.<i>`` (``enc_layers.<i>``, ``dec_layers.<i>``)
modules, and copies every leaf into the parameter of the same dotted name:
the port's modules use the reference's names (``w``, ``b``, ``scale``,
``pos_table``, the MoE banks ``w_up`` / ``w_down`` / ``w_gate``) and
layouts, so nothing is renamed or transposed.  A key missing on either
side, or a shape or type that differs, raises.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

from .transformer import stack_plan

#: the encoder-decoder's stacks: one layer a row of the leading axis
ENCDEC_STACKS = ("enc_layers", "dec_layers")


def _leaves(tree, prefix: str) -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _leaves(sub, f"{prefix}.{key}" if prefix else key)
    else:
        yield prefix, tree


def _rows(stacked, n: int) -> Iterator[Tuple[int, str, Any]]:
    """(i, leaf name, row i) of every leaf of ``stacked``, whose leading
    axis holds ``n`` layers."""
    for name, leaf in _leaves(stacked, ""):
        arr = np.asarray(leaf)
        if arr.shape[:1] != (n,):
            raise ValueError(f"stacked leaf {name} has shape {arr.shape}, "
                             f"expected {n} layers on its leading axis")
        for i in range(n):
            yield i, name, arr[i]


def flatten_reference(params, cfg) -> Dict[str, np.ndarray]:
    """The reference's tree as ``{port parameter name: array}``, with the
    stacked layers split into one entry per layer."""
    stacks = (ENCDEC_STACKS if cfg.block_pattern == "encdec"
              else ("groups",))
    out = dict(_leaves({k: v for k, v in params.items()
                        if k not in stacks}, ""))
    if cfg.block_pattern == "encdec":
        counts = {"enc_layers": cfg.encoder.n_layers,
                  "dec_layers": cfg.n_layers}
        for stack, n in counts.items():
            if stack not in params:
                raise KeyError(f"reference has no {stack}")
            out.update((f"{stack}.{i}.{name}", row)
                       for i, name, row in _rows(params[stack], n))
        return out
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
            out.update((f"layers.{offset + i * len(kinds) + u}.{name}", row)
                       for i, name, row in _rows(stacked, n))
        offset += n * len(kinds)
    return out


def _to_tensor(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":     # numpy has no bf16; exact via fp32
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.tensor(arr)


@torch.no_grad()
def load_reference_params(net: nn.Module, params) -> nn.Module:
    """Copy the reference's parameters (numpy leaves) into ``net`` (a
    ``Decoder`` or an ``EncDec``) in place, onto each parameter's device.
    Returns ``net``."""
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
