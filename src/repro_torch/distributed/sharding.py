"""Logical-axis sharding rules, and the blocks they give each rank.

The rules are the reference's: model code names *logical* axes ("batch",
"heads", "ff", "vocab", "experts", ...), ``DEFAULT_RULES`` maps them onto
the mesh axes ``pod``, ``data`` and ``model``, and a parameter's spec is
derived from its leaf path (``param_spec``): Megatron-style tensor
parallelism over ``model``, experts and vocab over ``model``; ``pod`` and
``data`` only ever shard the batch and, through ``zero_spec``, the
optimizer's moments (ZeRO-1).  A spec is computed on the reference's leaf
path and shape, the stacked leaf that ``models/convert.py::
reference_leaves`` names; a per-layer parameter of the port takes the spec
without its leading layer dimension.

Where the reference hands a spec to its partitioner, the port's layout is
explicit.  A :class:`Mesh` (``launch/mesh.py::make_mesh``) lays the axes
over the processes of a ``torch.distributed`` group; :func:`shard_of`
gives this rank's block of a whole tensor under a spec, and
:func:`gather` is its inverse over the spec's axes.  ``shard_module``
cuts a network's parameters to their blocks and marks how each is used:

* ``"tp"``: a leaf of a dense block whose spec cuts on whole heads or on
  the ``d_ff`` columns.  The block's forward runs on the rank's block
  between :func:`tp_enter` (identity forward, all-reduced gradient) and
  :func:`tp_exit` (all-reduced forward, identity gradient).
* ``"gather"``: every other leaf the spec shards over ``model``.  It is
  all-gathered where it is used (:func:`placed`), inside the remat unit,
  so that the recompute gathers again; its gradient is this rank's slice
  of the full gradient, which the ``model`` ranks compute replicated on
  the same rows.

``constrain`` is the identity: the port has no partitioner to hint.
"""

from __future__ import annotations

import contextlib
import itertools
import math
import threading
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from . import process_group as pg

_state = threading.local()

# logical axis -> mesh axis (or tuple); None = replicated
DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "batch_nopod": "data",
    "seq": None,
    "seq_shard": "data",          # long-context sequence parallelism
    "dmodel": None,
    "heads": "model",
    "kv_heads": "model",
    "ff": "model",
    "vocab": "model",
    "experts": "model",
    "capacity": None,
    "state": None,
    "frames": None,
    "kv_seq": "model",            # decode KV-cache sequence dim
    "zero": ("data",),            # axes ZeRO-shards optimizer state over
}


class P(tuple):
    """A partition spec: one entry a dimension, each None (replicated), a
    mesh axis name, or a tuple of names (the dimension split over their
    product, the first axis major).  A tuple, so it compares equal element
    by element: ``P("model", None) == P("model", None)``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


class Mesh:
    """Mesh axes laid over the ranks of a group, row-major: the last axis
    varies fastest.  ``shape`` is ``{axis: size}`` in the axes' order,
    ``coords`` this rank's ``{axis: index}``; ``groups`` holds one
    subgroup for each axis and one for ``("pod", "data")`` (the batch
    axes), None where that subgroup has one rank (nothing to communicate).
    A mesh made with ``groups=None`` computes blocks but communicates
    nothing (one process, a checkpoint cut to another mesh's shape)."""

    def __init__(self, shape: Dict[str, int], rank: int = 0,
                 groups: Optional[Dict] = None):
        self.shape = dict(shape)
        self.rank = rank
        self.groups = groups
        n = math.prod(self.shape.values())
        if not 0 <= rank < n:
            raise ValueError(f"rank {rank} is not in a mesh of {n}")
        coords, rest = {}, rank
        for axis in reversed(list(self.shape)):
            coords[axis] = rest % self.shape[axis]
            rest //= self.shape[axis]
        self.coords = {a: coords[a] for a in self.shape}

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"

    def axis_size(self, axes) -> int:
        """The product of the sizes of ``axes`` (a name, a tuple, None)."""
        return math.prod(self.shape.get(a, 1) for a in _axes(axes))

    def axis_index(self, axes) -> int:
        """This rank's index along ``axes``, the first axis major."""
        i = 0
        for a in _axes(axes):
            i = i * self.shape.get(a, 1) + self.coords.get(a, 0)
        return i

    def group(self, axes):
        """The subgroup of ``axes`` (one axis, or the batch axes), None
        when it has one rank."""
        key = tuple(a for a in _axes(axes) if a in self.shape)
        if self.axis_size(key) == 1:
            return None
        if self.groups is None:
            raise RuntimeError(f"{self!r} has no process groups: it cannot "
                               f"communicate over {key}")
        return self.groups[key if len(key) > 1 else key[0]]

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in ("pod", "data") if a in self.shape)

    def subgroup_ranks(self, axes) -> Dict[Tuple[int, ...], list]:
        """Every subgroup along ``axes``: {the other axes' coordinates:
        its ranks, in the order of ``axes`` row-major}."""
        names = list(self.shape)
        axes = [a for a in _axes(axes) if a in self.shape]
        others = [a for a in names if a not in axes]
        out = {}
        for fixed in itertools.product(*(range(self.shape[a])
                                          for a in others)):
            ranks = []
            for moving in itertools.product(*(range(self.shape[a])
                                              for a in axes)):
                c = dict(zip(others, fixed))
                c.update(zip(axes, moving))
                r = 0
                for a in names:
                    r = r * self.shape[a] + c[a]
                ranks.append(r)
            out[fixed] = ranks
        return out


def _axes(part) -> Tuple[str, ...]:
    if part is None:
        return ()
    if isinstance(part, str):
        return (part,)
    return tuple(part)


def dims_over(spec, axis: str) -> Tuple[int, ...]:
    """The dimensions of ``spec`` that are cut over mesh ``axis``."""
    return tuple(i for i, part in enumerate(spec) if axis in _axes(part))


def mesh_axes(mesh) -> set:
    return set(mesh.shape.keys())


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[dict] = None):
    """Activate (mesh, rules) for :func:`param_spec` and the model code's
    mesh-aware steps."""
    prev = getattr(_state, "ctx", None)
    rules = dict(DEFAULT_RULES, **(rules or {}))
    # drop references to axes the mesh doesn't have (single-pod: no 'pod')
    names = mesh_axes(mesh)

    def fix(v):
        if isinstance(v, tuple):
            t = tuple(a for a in v if a in names)
            return t if t else None
        return v if (v is None or v in names) else None

    _state.ctx = (mesh, {k: fix(v) for k, v in rules.items()})
    try:
        yield
    finally:
        _state.ctx = prev


def active():
    return getattr(_state, "ctx", None)


def logical_spec(*axes: Optional[str]) -> Optional[P]:
    ctx = active()
    if ctx is None:
        return None
    _, rules = ctx
    return P(*(rules.get(a) if a is not None else None for a in axes))


def constrain(x, *axes: Optional[str]):
    """The identity.  The reference hints its partitioner here; the port's
    layout is explicit in the parameters' blocks and the collectives of
    the model code, so there is nothing to hint."""
    return x


# ---------------------------------------------------------------------------
# parameter shardings by leaf path
# ---------------------------------------------------------------------------

#: (path substring, array rank) -> logical axes, scanned in order.
#: Stacked layer params have a leading layer axis (rank + 1) — handled by
#: prepending None in param_spec.
_PARAM_RULES = [
    ("embed", ("vocab", None)),
    ("lm_head", (None, "vocab")),
    ("router", (None, None)),
    # MoE expert banks (E, D, F) / (E, F, D): expert-parallel
    ("w_up", ("experts", None, "ff")),
    ("w_gate", ("experts", None, "ff")),
    ("w_down", ("experts", "ff", None)),
    # attention
    ("wq", (None, "heads")),
    ("wk", (None, "kv_heads")),
    ("wv", (None, "kv_heads")),
    ("wo_gate", (None, "heads")),
    ("wo", ("heads", None)),
    # mlp
    ("up", (None, "ff")),
    ("gate", (None, "ff")),
    ("down", ("ff", None)),
    # ssm projections
    ("wB", (None, "heads")),
    ("wC", (None, "heads")),
    ("wx", (None, "heads")),
    ("wz", (None, "heads")),
    ("wdt", (None, None)),
    ("wf", (None, None)),
    ("wi", (None, "heads")),
    ("wog", (None, "heads")),
    ("pos_table", (None, None)),
    # decode caches (stacked over layers by the caller -> rank+1 handling):
    # KV cache (B, KV, S, hd): batch over data axes, *sequence* over model
    ("k", ("batch", None, "kv_seq", None)),
    ("v", ("batch", None, "kv_seq", None)),
    # SSM matrix state (B, H, DK, DV) and normalizer (B, H, DK)
    ("S", ("batch", "heads", None, None)),
    ("n", ("batch", "heads", None)),
    # sLSTM scalar states (B, H*hd)
    ("c", ("batch", "heads")),
    ("m", ("batch", "heads")),
]


def param_logical_axes(path: str, ndim: int):
    """Logical axes for a parameter leaf (path: '/'-joined key path)."""
    leaf = path.split("/")[-1]
    for frag, axes in _PARAM_RULES:
        if frag == leaf or frag in path.split("/"):
            if len(axes) == ndim:
                return axes
            if len(axes) == ndim - 1:
                return (None,) + tuple(axes)     # stacked layer dim
            if len(axes) == ndim - 2:
                return (None, None) + tuple(axes)
    return (None,) * ndim


def param_spec(path: str, ndim: int) -> P:
    ctx = active()
    axes = param_logical_axes(path, ndim)
    if ctx is None:
        return P(*(None for _ in range(ndim)))
    _, rules = ctx
    return P(*(rules.get(a) for a in axes))


def tree_paths(tree, prefix=""):
    """Flatten a nested dict/NamedTuple tree into (path, leaf) pairs.
    None nodes are empty subtrees and are skipped."""
    out = []
    if tree is None:
        return out
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.extend(tree_paths(v, f"{prefix}/{k}" if prefix else str(k)))
    elif hasattr(tree, "_fields"):
        for k in tree._fields:
            v = getattr(tree, k)
            out.extend(tree_paths(v, f"{prefix}/{k}" if prefix else str(k)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.extend(tree_paths(v, f"{prefix}/{i}" if prefix else str(i)))
    else:
        out.append((prefix, tree))
    return out


def tree_param_specs(tree):
    """A tree of :class:`P` matching ``tree``'s structure."""
    leaves_with_paths = tree_paths(tree)
    specs = {path: param_spec(path, getattr(leaf, "ndim", 0))
             for path, leaf in leaves_with_paths}

    def rebuild(subtree, prefix=""):
        if subtree is None:
            return None
        if isinstance(subtree, dict):
            return {k: rebuild(v, f"{prefix}/{k}" if prefix else str(k))
                    for k, v in subtree.items()}
        if hasattr(subtree, "_fields"):
            return type(subtree)(*(rebuild(getattr(subtree, k),
                                           f"{prefix}/{k}" if prefix else str(k))
                                   for k in subtree._fields))
        if isinstance(subtree, (list, tuple)):
            return type(subtree)(rebuild(v, f"{prefix}/{i}" if prefix else str(i))
                                 for i, v in enumerate(subtree))
        return specs[prefix]

    return rebuild(tree)


def valid_spec(spec: P, shape, mesh) -> P:
    """Drop mesh axes that don't divide the dim or are already used in an
    earlier dim (a mesh axis may appear at most once per spec) — e.g.
    granite's single KV head cannot shard over model=16, and qwen2-moe's
    60 experts don't divide 16 so the expert-FF dim takes TP instead."""
    used = set()
    parts = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, ax in zip(shape, parts):
        axes = ax if isinstance(ax, tuple) else (ax,) if ax else ()
        keep = []
        size = 1
        for a in axes:
            if a in used or a not in mesh.shape:
                continue
            if dim % (size * mesh.shape[a]) == 0:
                keep.append(a)
                size *= mesh.shape[a]
        for a in keep:
            used.add(a)
        out.append(tuple(keep) if len(keep) > 1 else (keep[0] if keep else None))
    return P(*out)


def zero_spec(spec: P, shape, mesh, data_axes=("data",)) -> P:
    """ZeRO-1: add the data axes to the first replicated, divisible dim.
    If no dim is divisible by the full axis product, fall back to axis
    subsets (e.g. 1600-wide params on a ("data","model") request shard
    16-way instead of staying replicated)."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    used = {a for p in parts for a in
            ((p,) if isinstance(p, str) else (p or ()))}
    axes = tuple(a for a in data_axes if a in mesh.shape and a not in used)
    if not axes:
        return valid_spec(P(*parts), shape, mesh)
    # Prefer non-leading dims: dim 0 of a stacked-layer parameter is the
    # scan axis — sharding it makes the partitioner window-buffer whole
    # layer groups.
    order = list(range(1, len(shape))) + [0] if len(shape) >= 3 \
        else list(range(len(shape)))
    candidates = [axes] + [(a,) for a in axes]
    for axes_try in candidates:
        dsize = 1
        for a in axes_try:
            dsize *= mesh.shape[a]
        if dsize == 1:
            continue
        for i in order:
            if parts[i] is None and shape[i] % dsize == 0 and shape[i] >= dsize:
                parts[i] = axes_try if len(axes_try) > 1 else axes_try[0]
                return valid_spec(P(*parts), shape, mesh)
    return valid_spec(P(*parts), shape, mesh)


def leaf_spec(path: str, shape: Sequence[int], mesh) -> P:
    """The valid spec of the reference's leaf ``path`` of ``shape`` on
    ``mesh``: :func:`param_spec` under the mesh's rules, then
    :func:`valid_spec`."""
    with use_mesh(mesh):
        spec = param_spec(path, len(shape))
    return valid_spec(spec, tuple(shape), mesh)


def leaf_zero_spec(path: str, shape: Sequence[int], mesh) -> P:
    """The ZeRO-1 spec of the moments of the leaf ``path``: the leaf's
    spec with the rules' ``zero`` axes (``data``) added."""
    with use_mesh(mesh):
        zero = active()[1].get("zero") or ("data",)
    return zero_spec(leaf_spec(path, shape, mesh), tuple(shape), mesh,
                     data_axes=_axes(zero))


# ---------------------------------------------------------------------------
# blocks: what NamedSharding places on each rank
# ---------------------------------------------------------------------------


def block_shape(shape: Sequence[int], spec: P, mesh) -> Tuple[int, ...]:
    """The shape of each rank's block of a tensor of ``shape``."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    return tuple(n // mesh.axis_size(a) for n, a in zip(shape, parts))


def shard_of(full: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """This rank's block of ``full`` under ``spec``: a contiguous copy
    (``full`` may be freed), or ``full`` itself where the spec cuts no
    dimension on this mesh."""
    x = full
    for dim, part in enumerate(spec):
        n = mesh.axis_size(part)
        if n == 1:
            continue
        size = full.shape[dim] // n
        x = x.narrow(dim, mesh.axis_index(part) * size, size)
    if x is full:
        return full
    return x.clone(memory_format=torch.contiguous_format)


def gather(block: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """The whole tensor from every rank's ``block`` under ``spec``: the
    inverse of :func:`shard_of` over the spec's axes (a dimension split
    over a tuple of axes is gathered over its minor axis first)."""
    x = block
    for dim, part in enumerate(spec):
        for axis in reversed(_axes(part)):
            group = mesh.group(axis)
            if group is not None:
                x = pg.all_gather(x, group, dim=dim)
    return x


# ---------------------------------------------------------------------------
# the model code's collectives, as autograd Functions
# ---------------------------------------------------------------------------


class Placement(NamedTuple):
    """How a per-layer parameter of the port is held under a mesh: its
    dimension cut over ``model``, its use (``"tp"``: the block is used as
    it is; ``"gather"``: gathered where used) and the mesh."""
    dim: int
    mode: str
    mesh: Mesh


class _GatherParam(torch.autograd.Function):
    """A parameter's block gathered over ``model`` along ``dim``; the
    gradient is this rank's slice of the whole one."""

    @staticmethod
    def forward(ctx, block, dim, mesh):
        ctx.dim, ctx.index = dim, mesh.axis_index("model")
        ctx.size = block.shape[dim]
        return pg.all_gather(block, mesh.group("model"), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return (grad.narrow(ctx.dim, ctx.index * ctx.size,
                            ctx.size).contiguous(), None, None)


def placed(p: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """``p`` as the forward uses it: a ``"gather"`` parameter's whole
    tensor, gathered over ``model``; anything else as it is."""
    where = getattr(p, "placement", None)
    if where is None or where.mode != "gather":
        return p
    return _GatherParam.apply(p, where.dim, where.mesh)


class _Enter(torch.autograd.Function):
    """Identity forward; the gradient all-reduced over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return pg.all_reduce(grad, ctx.group), None


class _Exit(torch.autograd.Function):
    """All-reduced forward; the gradient as it is."""

    @staticmethod
    def forward(ctx, x, group):
        return pg.all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _BatchMean(torch.autograd.Function):
    """The mean over the batch ranks; the gradient as it is (each batch
    rank's loss holds the mean, and the trainer averages the ranks'
    gradients)."""

    @staticmethod
    def forward(ctx, x, group):
        return pg.all_reduce(x, group, op="mean")

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class TP(NamedTuple):
    """A block run tensor-parallel: the ``model`` subgroup, its size and
    this rank's index in it."""
    group: object
    size: int
    index: int


def tp_enter(x: torch.Tensor, tp: TP) -> torch.Tensor:
    """The input of a column-parallel block: the identity; its gradient
    is summed over the ``model`` ranks."""
    return _Enter.apply(x, tp.group)


def tp_exit(y: torch.Tensor, tp: TP) -> torch.Tensor:
    """The output of a row-parallel block: the partial sums added over the
    ``model`` ranks."""
    return _Exit.apply(y, tp.group)


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """``x`` averaged over the active mesh's batch axes (``pod``,
    ``data``): the statistic the reference takes over the whole batch,
    from each rank's mean over its equal share of the rows.  The identity
    without a mesh or with one batch rank."""
    ctx = active()
    if ctx is None:
        return x
    mesh = ctx[0]
    group = mesh.group(mesh.batch_axes) if mesh.batch_axes else None
    if group is None:
        return x
    return _BatchMean.apply(x, group)
