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

The way back: ``reference_leaves`` names, for each leaf path of the
reference's tree ('/'-joined, as the reference's checkpoints key them), the
port's parameters that are its rows (or the one parameter it is), and
``to_reference`` turns the port's named tensors (parameters, gradients)
into that tree of numpy arrays, each group's layers stacked on the leading
axis again.  The optimizer and the checkpoints work at that granularity.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, List, Mapping, NamedTuple, Tuple

import numpy as np
import torch
from torch import nn

from ..distributed.sharding import (P, Placement, block_shape,
                                    cache_block_spec, dims_over, gather,
                                    shard_of)
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


# ---------------------------------------------------------------------------
# the way back: the port's named tensors as the reference's tree
# ---------------------------------------------------------------------------


class Leaf(NamedTuple):
    """The port's parameters behind one leaf of the reference's tree."""
    names: Tuple[str, ...]   # in row order; one name when not stacked
    stacked: bool            # rows of a leading layer axis


def tree_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs of a tree of dicts, NamedTuples, lists and
    tuples, the path '/'-joined as the reference's ``tree_paths`` joins it;
    None subtrees are empty."""
    out = []
    if tree is None:
        return out
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_fields"):
        items = ((k, getattr(tree, k)) for k in tree._fields)
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    for k, v in items:
        out.extend(tree_paths(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def nest(flat: Mapping[str, Any]):
    """The tree whose ``tree_paths`` are ``flat``'s keys: dicts, with lists
    where every key of a level is an index (the reference's ``groups``)."""
    root: Dict[str, Any] = {}
    for path, leaf in flat.items():
        node = root
        *parents, last = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        out = {k: listify(v) for k, v in node.items()}
        if out and all(k.isdigit() for k in out):
            return [out[str(i)] for i in range(len(out))]
        return out

    return listify(root)


def reference_leaves(net: nn.Module) -> Dict[str, Leaf]:
    """``{reference leaf path: Leaf}`` for ``net`` (a ``Decoder`` or an
    ``EncDec``): the inverse of :func:`flatten_reference`'s map."""
    cfg = net.cfg
    unit_of = {}                    # decoder layer -> (group, unit pos, row)
    if cfg.block_pattern != "encdec":
        offset = 0
        for g, (_, n, kinds) in enumerate(stack_plan(cfg)):
            for i in range(n):
                for u in range(len(kinds)):
                    unit_of[offset + i * len(kinds) + u] = (g, u, i)
            offset += n * len(kinds)
    rows: Dict[str, List[Tuple[int, str]]] = {}
    single: Dict[str, str] = {}
    for name, _ in net.named_parameters():
        m = re.fullmatch(r"(layers|enc_layers|dec_layers)\.(\d+)\.(.+)", name)
        if m is None:
            single[name.replace(".", "/")] = name
            continue
        stack, j, rest = m.group(1), int(m.group(2)), m.group(3)
        rest = rest.replace(".", "/")
        if stack == "layers":
            g, u, j = unit_of[j]
            path = f"groups/{g}/{u}/{rest}"
        else:
            path = f"{stack}/{rest}"
        rows.setdefault(path, []).append((j, name))
    out = {path: Leaf((name,), False) for path, name in single.items()}
    out.update((path, Leaf(tuple(n for _, n in sorted(r)), True))
               for path, r in rows.items())
    return out


def host_array(x) -> np.ndarray:
    """A tensor (or array) as a numpy array on the host; bf16 widened to
    fp32 (exactly: numpy has no bf16)."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    x = x.detach().cpu()
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()


def to_reference(tensors: Mapping[str, torch.Tensor], net: nn.Module):
    """The port's named tensors (``net``'s parameter names: parameters,
    gradients) as the reference's tree of numpy arrays, each group's
    layers stacked on the leading axis."""
    flat = {}
    for path, leaf in reference_leaves(net).items():
        arrs = [host_array(tensors[n]) for n in leaf.names]
        flat[path] = np.stack(arrs) if leaf.stacked else arrs[0]
    return nest(flat)


def write_rows(params: Mapping[str, torch.Tensor], leaf: Leaf,
               value: torch.Tensor) -> None:
    """Copy ``value`` (a leaf of the reference's tree) into the port's
    parameters behind it: row i into ``leaf.names[i]`` when stacked."""
    rows = value if leaf.stacked else value[None]
    if rows.shape[0] != len(leaf.names):
        raise ValueError(f"{leaf.names[0]}: {rows.shape[0]} rows for "
                         f"{len(leaf.names)} layers")
    for name, row in zip(leaf.names, rows):
        p = params[name]
        if tuple(row.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(row.shape)}, port shape "
                             f"{tuple(p.shape)}")
        p.copy_(row)


@torch.no_grad()
def load_leaves(net: nn.Module, flat: Mapping[str, Any]) -> nn.Module:
    """Copy ``{reference leaf path: stacked tensor or numpy array}`` (a
    checkpoint's ``params``) into ``net``'s parameters, row by row, on each
    parameter's device and in its type.  A missing path raises."""
    params = dict(net.named_parameters())
    for path, leaf in reference_leaves(net).items():
        if path not in flat:
            raise KeyError(f"no leaf {path}")
        value = flat[path]
        if not isinstance(value, torch.Tensor):
            value = _to_tensor(value)
        write_rows(params, leaf, value)
    return net


# ---------------------------------------------------------------------------
# decode caches: the reference's cache tree and a rank's blocks of it
# ---------------------------------------------------------------------------
# The reference stacks its decode caches as its parameters (one tree a
# ``stack_plan`` group, a tuple of the unit's layers, each a dict of
# NamedTuples, a leading layer axis on every leaf; the encoder-decoder one
# ``{"kv": KVCache}`` stacked over the decoder's layers), with a scalar
# ``length``; the port keeps a list of one dict a layer, with one length a
# row.  Under a mesh each leaf is the rank's block of the reference's
# stacked leaf under ``sharding.cache_block_spec`` (its ``length`` the rows
# of its state's), built directly at that size.


def cache_paths(cfg) -> List[Tuple[str, int, int]]:
    """For each of the port's cache layers, in order: (the reference's
    path prefix of its stacked caches, their layer count, its row)."""
    if cfg.block_pattern == "encdec":
        return [("", cfg.n_layers, i) for i in range(cfg.n_layers)]
    out = []
    for g, (_, n, kinds) in enumerate(stack_plan(cfg)):
        for i in range(n):
            out.extend((f"{g}/{u}", n, i) for u in range(len(kinds)))
    return out


def _leaf_path(prefix: str, key: str, field: str) -> str:
    return "/".join(x for x in (prefix, key, field) if x)


def _layer_specs(shapes: Mapping[Tuple[str, str], Tuple[int, ...]],
                 prefix: str, mesh) -> Dict[Tuple[str, str], Any]:
    """``{(key, field): spec}`` of one layer's caches, given the reference's
    stacked shape of each tensor: its ``sharding.cache_block_spec``; a
    ``length`` takes the rows of its state's first tensor."""
    out, first = {}, {}
    for (key, field), shape in shapes.items():
        if field != "length":
            out[key, field] = spec = cache_block_spec(
                _leaf_path(prefix, key, field), shape, mesh)
            first.setdefault(key, spec)
    for key, field in shapes:
        if field == "length":
            out[key, field] = P(first[key][0])
    return out


def shard_caches(whole, cfg, mesh, device):
    """The rank's blocks of ``whole`` (the port's caches at their whole
    shapes, on any device: only shapes and types are read), zeros on
    ``device``.  A KV cache cut on its slots over ``model`` carries
    ``placement`` (mode ``"kv_seq"``), which ``attention_decode`` reads."""
    out = []
    for layer, (prefix, n, _) in zip(whole, cache_paths(cfg)):
        specs = _layer_specs({(key, f): (n,) + tuple(getattr(st, f).shape)
                              for key, st in layer.items()
                              for f in st._fields}, prefix, mesh)
        new = {}
        for key, st in layer.items():
            parts = []
            for field in st._fields:
                t, spec = getattr(st, field), specs[key, field]
                blk = torch.zeros(block_shape(t.shape, spec, mesh),
                                  dtype=t.dtype, device=device)
                if field in ("k", "v") and dims_over(spec, "model") == (2,) \
                        and mesh.shape.get("model", 1) > 1:
                    blk.placement = Placement(2, "kv_seq", mesh)
                parts.append(blk)
            new[key] = type(st)(*parts)
        out.append(new)
    return out


@torch.no_grad()
def load_reference_cache(caches, tree, cfg, mesh=None):
    """Copy the reference's cache tree (numpy leaves, stacked, a scalar
    length a layer) into the port's ``caches`` in place: the whole rows,
    or under ``mesh`` (the one the caches were built on) this rank's
    blocks of them.  Returns ``caches``."""
    flat = {p: _to_tensor(v) for p, v in tree_paths(tree)}
    for layer, (prefix, n, i) in zip(caches, cache_paths(cfg)):
        shapes = {(key, f): tuple(flat[_leaf_path(prefix, key, f)].shape)
                  for key, st in layer.items() for f in st._fields}
        specs = _layer_specs(shapes, prefix, mesh) if mesh else {}
        for key, st in layer.items():
            rows = shapes[key, st._fields[0]][1]
            for field in st._fields:
                row = flat[_leaf_path(prefix, key, field)][i]
                if field == "length":
                    row = row.expand(rows)
                if mesh is not None:
                    row = shard_of(row, specs[key, field], mesh)
                t = getattr(st, field)
                t.copy_(row.to(device=t.device, dtype=t.dtype))
    return caches


def cache_to_reference(caches, cfg, mesh=None, whole=None):
    """The port's caches as the reference's tree of numpy arrays: each
    leaf's rows stacked, a length row 0's (the reference keeps one a
    layer).  Under ``mesh`` the caches are the rank's blocks of ``whole``
    (the caches at their whole shapes, on any device: ``Model.init_cache``
    on ``meta``) and are gathered whole (every rank takes part)."""
    flat: Dict[str, Dict[int, np.ndarray]] = {}
    for j, (prefix, n, i) in enumerate(cache_paths(cfg)):
        layer = caches[j]
        if mesh is not None:
            specs = _layer_specs({(key, f): (n,) + tuple(getattr(st, f).shape)
                                  for key, st in whole[j].items()
                                  for f in st._fields}, prefix, mesh)
            layer = {key: type(st)(*(gather(getattr(st, f), specs[key, f],
                                            mesh) for f in st._fields))
                     for key, st in layer.items()}
        for key, st in layer.items():
            for field in st._fields:
                t = getattr(st, field)
                flat.setdefault(_leaf_path(prefix, key, field), {})[i] = \
                    host_array(t[0] if field == "length" else t)
    return nest({p: np.stack([rows[i] for i in sorted(rows)])
                 for p, rows in flat.items()})
