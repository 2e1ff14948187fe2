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

* ``"tp"``: a leaf of a block whose spec cuts on whole heads (self- and
  cross-attention, the mLSTM, the SSD head), on the sLSTM's features or
  on the ``d_ff`` columns, or an MoE expert bank cut on the experts'
  ``ff`` dimension (the experts do not divide ``model``).  The block's
  forward runs on the rank's block between :func:`tp_enter` (identity
  forward, all-reduced gradient) and :func:`tp_exit` (all-reduced
  forward, identity gradient) (:func:`block_enter`, :func:`block_exit`);
  a gate leaf the rules keep whole (``wf``, ``wdt``) is used on the
  rank's columns (:func:`rank_columns`).
* ``"ep"``: an MoE expert bank cut on its experts (they divide
  ``model``): the rank runs its own experts, between the same pair.
* ``"gather"``: every other leaf the spec shards over ``model``.  It is
  all-gathered where it is used (:func:`placed`), inside the remat unit,
  so that the recompute gathers again; its gradient is this rank's slice
  of the full gradient, which the ``model`` ranks compute replicated on
  the same rows.  Where no graph is built (decode, prefill) the
  vocabulary leaves are used on their blocks instead (:func:`vocab_block`):
  an embedding looks up the rows it holds and the ranks sum them, an LM
  head gives its share of the logits and the ranks gather them, wherever
  that moves fewer bytes than gathering the leaf.

The decode caches follow the reference's cache rules
(:func:`cache_block_spec`): a KV cache's slots over ``model``
(``kv_seq``), the recurrent states' heads over ``model``, the rows over
the batch axes.  A cache cut on its slots carries ``placement`` (mode
``"kv_seq"``), which the decode reads.

With FSDP (the reference's ``zero_data_axes`` parameter shardings: a
leaf's spec with the ``data`` axis added by :func:`zero_spec`), a
parameter holds this rank's ``data`` block of the above too.
:func:`placed` all-gathers it over ``data`` where it is used, before any
``"gather"`` over ``model``; its gradient comes back as this rank's block
of the mean over the batch ranks (a reduce-scatter over ``data``, a sum
over ``pod``), which the trainer does not average again.  This is what
the reference's partitioner computes for those specs.

The rules travel with the mesh (``Mesh.rules``; ``mesh.with_rules(...)``
puts a profile's dict over ``DEFAULT_RULES``): ``use_mesh(mesh)``
activates them, and every
layout decision reads them, so a rank built on a ``dp_sp`` mesh runs what
the reference's step runs under ``use_mesh(mesh, rules=...)``.  The batch
axes are the rules' ``batch`` axes, kept by ``valid_spec`` where they
divide the global batch (``Mesh.for_batch``); FSDP and ZeRO-1 cut over the
rules' ``zero`` axes (:func:`leaf_zero_spec`, ``Placement.fsdp_axes``).

Where the rules cut ``seq`` over ``model`` (the reference's ``seq_sp``,
Megatron-SP) and the sequence divides it (:func:`seq_tp`), the residual
stream between blocks is the rank's rows of the sequence.  A
tensor-parallel block takes the whole sequence through :func:`seq_enter`
(an all-gather; its gradient reduce-scattered) and gives its rows through
:func:`seq_exit` (a reduce-scatter of the partial sums; its gradient
all-gathered).  A block that runs whole on every rank takes the sequence
through :func:`tp_gather` (its gradient the rank's rows) and gives its
rows through :func:`seq_rows` (its gradient all-gathered).  The layers
choose between the two at their call sites (:func:`on_sequence`).  A leaf used on
the rank's rows (the norms, the LM head in the loss) gets those rows'
share of its gradient: ``placed(p, rows=tp)`` sums it over ``model``.

``constrain`` is the identity: the port has no partitioner to hint.
"""

from __future__ import annotations

import contextlib
import itertools
import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from . import process_group as pg


class _State:
    """The active (mesh, rules).  One for the process, not one a thread:
    the autograd engine runs a CUDA backward, and the recompute of a
    checkpointed unit in it, on a thread of its own, which must see the
    mesh the forward ran under (a rank is one process with one mesh)."""
    ctx = None


_state = _State()

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
    subgroup for each axis of more than one rank and for each combination
    of such axes that a profile's batch or ZeRO axes name
    (``launch/mesh.py::COMBINED_AXES``), keyed in the mesh's order.  ``rules`` are the logical-axis rules the mesh runs under:
    ``DEFAULT_RULES``, each fixed to the mesh's axes; :meth:`with_rules`
    gives the same rank under a profile's (:func:`use_mesh` takes them
    when given none).  A mesh made with ``groups=None`` computes blocks
    but communicates nothing (one process, a checkpoint cut to another
    mesh's shape)."""

    def __init__(self, shape: Dict[str, int], rank: int = 0,
                 groups: Optional[Dict] = None):
        self.shape = dict(shape)
        self.rank = rank
        self.groups = groups
        self.rules = fixed_rules(self.shape)
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
        """The subgroup of ``axes`` (one axis or several, in the mesh's
        order), None when it has one rank."""
        key = tuple(a for a in self.shape
                    if a in _axes(axes) and self.shape[a] > 1)
        if not key:
            return None
        if self.groups is None:
            raise RuntimeError(f"{self!r} has no process groups: it cannot "
                               f"communicate over {key}")
        return self.groups[key if len(key) > 1 else key[0]]

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        """The rules' ``batch`` axes (reduced to those that divide the
        global batch by :meth:`for_batch`)."""
        return _axes(self.rules.get("batch"))

    @property
    def zero_axes(self) -> Tuple[str, ...]:
        """The rules' ``zero`` axes: what ZeRO-1 and FSDP cut over."""
        return _axes(self.rules.get("zero"))

    def _view(self, rules: dict) -> "Mesh":
        view = Mesh(self.shape, self.rank, self.groups)
        view.rules = rules
        return view

    def with_rules(self, rules: Optional[dict]) -> "Mesh":
        """This rank of this mesh (its groups shared) under ``rules``, a
        profile's dict over ``DEFAULT_RULES``."""
        return self._view(fixed_rules(self.shape, rules))

    def for_batch(self, global_batch: int) -> "Mesh":
        """This mesh with its batch axes those of the rules' ``batch``
        axes that ``valid_spec`` keeps on ``global_batch`` rows (the
        reference's batch specs): an axis that does not divide what is
        left holds the same rows on each of its ranks."""
        spec = valid_spec(P(self.batch_axes or None), (global_batch,), self)
        return self._view(dict(self.rules, batch=spec[0]))

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


def fixed_rules(shape, rules: Optional[dict] = None) -> dict:
    """``DEFAULT_RULES`` updated by ``rules``, each value's mesh axes
    those of ``shape`` (single-pod: no ``pod``), None where none is
    left."""
    names = set(shape)

    def fix(v):
        if isinstance(v, tuple):
            t = tuple(a for a in v if a in names)
            return t if t else None
        return v if (v is None or v in names) else None

    return {k: fix(v) for k, v in dict(DEFAULT_RULES, **(rules or {})).items()}


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[dict] = None):
    """Activate (mesh, rules) for :func:`param_spec` and the model code's
    mesh-aware steps; without ``rules``, the mesh's own
    (``Mesh.rules``)."""
    prev = _state.ctx
    if rules is None:
        rules = getattr(mesh, "rules", None)
    _state.ctx = (mesh, fixed_rules(mesh_axes(mesh), rules))
    try:
        yield
    finally:
        _state.ctx = prev


def active():
    return _state.ctx


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
    spec with the rules' ``zero`` axes (``data``; ``dp_sp``: ``("data",
    "model")``) added."""
    return zero_spec(leaf_spec(path, shape, mesh), tuple(shape), mesh,
                     data_axes=mesh.zero_axes or ("data",))


def zero_cut(spec: P, zspec: P, mesh) -> Optional[Tuple[int, Tuple[str, ...]]]:
    """(dimension, mesh axes) that ``zspec`` (a ZeRO-1 or FSDP spec) cuts
    beyond ``spec``, the axes of one rank left out; None where it cuts
    nothing more."""
    for i, (a, b) in enumerate(itertools.zip_longest(spec, zspec)):
        if a != b:
            axes = tuple(x for x in _axes(b) if mesh.shape.get(x, 1) > 1)
            return (i, axes) if axes else None
    return None


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
    """How a per-layer parameter (or a decode cache) of the port is held
    under a mesh: its dimension cut over ``model`` by the tensor-parallel
    rules (None: whole over ``model``), its use (``"tp"``: the block is
    used as it is, between :func:`tp_enter` and :func:`tp_exit`; ``"ep"``:
    an expert bank's own experts, used alike; ``"gather"``: gathered where
    used; ``"kv_seq"``: a KV cache's slots; None), the mesh, its dimension
    cut under FSDP (None: no FSDP block) and the axes of that cut (the
    rules' ``zero`` axes that divide it)."""
    dim: Optional[int]
    mode: Optional[str]
    mesh: Mesh
    fsdp: Optional[int] = None
    fsdp_axes: Tuple[str, ...] = ("data",)


def fsdp_spec(path: str, shape: Sequence[int], mesh, stacked: bool) -> P:
    """The FSDP spec of the leaf ``path``: :func:`leaf_zero_spec`, the
    rules' ``zero`` axes added to the leaf's spec.  The port keeps one
    module a layer, so where that spec cuts the layer axis of a stacked
    leaf (an (L, X) norm scale or bias with L a multiple of ``data``) the
    zero axes go on the per-layer leaf's own first free dimension instead:
    the same bytes a rank."""
    spec = leaf_zero_spec(path, shape, mesh)
    cut = zero_cut(leaf_spec(path, shape, mesh), spec, mesh)
    if not (stacked and cut is not None and cut[0] == 0):
        return spec
    rest = zero_spec(P(*spec[1:]), tuple(shape[1:]), mesh,
                     data_axes=mesh.zero_axes or ("data",))
    return P(None, *rest)


class _GatherData(torch.autograd.Function):
    """An FSDP parameter's block gathered over its ``axes`` along ``dim``;
    the gradient is this rank's block of its mean over the batch ranks: a
    reduce-scatter over ``axes``, a sum over the batch axes that are not
    among them, over the ranks of both."""

    @staticmethod
    def forward(ctx, block, dim, mesh, axes):
        ctx.dim, ctx.mesh, ctx.axes = dim, mesh, axes
        return pg.all_gather(block, mesh.group(axes), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        mesh, axes = ctx.mesh, ctx.axes
        g = pg.reduce_scatter(grad.contiguous(), mesh.group(axes),
                              dim=ctx.dim)
        rest = tuple(a for a in mesh.batch_axes if a not in axes)
        if mesh.group(rest) is not None:
            g = pg.all_reduce(g, mesh.group(rest))
        return g / mesh.axis_size(axes + rest), None, None, None


def placed(p: Optional[torch.Tensor], rows: Optional["TP"] = None
           ) -> Optional[torch.Tensor]:
    """``p`` as the forward uses it: an FSDP parameter gathered over its
    zero axes; a ``"gather"`` parameter's whole tensor, gathered over
    ``model``; anything else as it is.  ``rows`` (the ``model`` axis of a
    sequence cut over it, :func:`seq_tp`) marks a use on the rank's rows:
    the gradient, those rows' share, is summed over ``model`` (the
    gathered leaf's reduce-scattered)."""
    where = getattr(p, "placement", None)
    if where is not None and where.fsdp is not None:
        p = _GatherData.apply(p, where.fsdp, where.mesh, where.fsdp_axes)
    if where is not None and where.mode == "gather":
        tp = tp_of(where.mesh)
        return (tp_gather(p, tp, where.dim) if rows is None
                else _GatherSum.apply(p, where.dim, tp))
    return p if rows is None else tp_enter(p, rows)


def vocab_block(p: torch.Tensor):
    """(the rank's block, the ``model`` axis as a :class:`TP`, its cut
    dimension) of a ``"gather"`` leaf used where no graph is built (the
    vocabulary leaves of a decode or prefill step), its ``data`` block
    gathered under FSDP; None where ``p`` is not such a leaf or a graph is
    built (training gathers it whole, :func:`placed`)."""
    where = getattr(p, "placement", None)
    if (where is None or where.mode != "gather"
            or torch.is_grad_enabled()):
        return None
    if where.fsdp is not None:
        p = _GatherData.apply(p, where.fsdp, where.mesh, where.fsdp_axes)
    return p, tp_of(where.mesh), where.dim


def is_fsdp(p) -> bool:
    """True for a parameter that holds an FSDP block."""
    where = getattr(p, "placement", None)
    return where is not None and where.fsdp is not None


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


class _GatherModel(torch.autograd.Function):
    """Every ``model`` rank's block concatenated along ``dim``; the
    gradient is this rank's block of it (the ranks hold one replicated
    gradient)."""

    @staticmethod
    def forward(ctx, x, dim, tp):
        ctx.dim, ctx.index, ctx.size = dim, tp.index, x.shape[dim]
        return pg.all_gather(x, tp.group, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return (grad.narrow(ctx.dim, ctx.index * ctx.size,
                            ctx.size).contiguous(), None, None)


def tp_gather(x: torch.Tensor, tp: TP, dim: int) -> torch.Tensor:
    """The ``model`` ranks' blocks of a replicated tensor (a ``"gather"``
    parameter, the MoE's token-cut outputs), each cut along ``dim``, put
    back whole on every rank."""
    return _GatherModel.apply(x, dim, tp)


class _GatherSum(torch.autograd.Function):
    """Every ``model`` rank's block concatenated along ``dim``; the
    gradient, each rank's partial sum, reduce-scattered."""

    @staticmethod
    def forward(ctx, x, dim, tp):
        ctx.dim, ctx.group = dim, tp.group
        return pg.all_gather(x, tp.group, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return (pg.reduce_scatter(grad.contiguous(), ctx.group, dim=ctx.dim),
                None, None)


class _ScatterSum(torch.autograd.Function):
    """This rank's block along ``dim`` of the sum over the ``model``
    ranks; the gradient all-gathered."""

    @staticmethod
    def forward(ctx, x, dim, tp):
        ctx.dim, ctx.group = dim, tp.group
        return pg.reduce_scatter(x.contiguous(), tp.group, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return pg.all_gather(grad, ctx.group, dim=ctx.dim), None, None


class _Rows(torch.autograd.Function):
    """This rank's block along ``dim`` of a tensor the ``model`` ranks
    hold alike; the gradient, of the rank's block, all-gathered."""

    @staticmethod
    def forward(ctx, x, dim, tp):
        ctx.dim, ctx.group = dim, tp.group
        size = x.shape[dim] // tp.size
        return x.narrow(dim, tp.index * size, size).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return pg.all_gather(grad, ctx.group, dim=ctx.dim), None, None


def seq_tp(seq: int) -> Optional[TP]:
    """The ``model`` axis as a :class:`TP` where the active rules cut the
    sequence over it (``seq_sp``) and it divides ``seq`` positions (as
    ``valid_spec`` keeps it on ``("batch", "seq", "dmodel")``); None
    otherwise.  The residual stream is then the rank's rows."""
    ctx = active()
    if ctx is None:
        return None
    mesh, rules = ctx
    axes = tuple(a for a in _axes(rules.get("seq"))
                 if a not in _axes(rules.get("batch"))
                 and mesh.shape.get(a, 1) > 1)
    if not axes:
        return None
    if axes != ("model",):
        raise NotImplementedError(f"the sequence cut over {axes}: the port "
                                  f"cuts it over 'model' only")
    tp = tp_of(mesh)
    return tp if seq % tp.size == 0 else None


def seq_rows(x: torch.Tensor, tp: TP) -> torch.Tensor:
    """The rank's rows (dim 1) of a sequence every ``model`` rank holds
    alike (the output of a block run whole); the gradient all-gathered."""
    return _Rows.apply(x, 1, tp)


def seq_enter(x: torch.Tensor, tp: TP) -> torch.Tensor:
    """The input of a tensor-parallel block from the ranks' rows: the
    whole sequence; its gradient, partial over the rank's heads or
    columns, reduce-scattered."""
    return _GatherSum.apply(x, 1, tp)


def seq_exit(y: torch.Tensor, tp: TP) -> torch.Tensor:
    """The output of a row-parallel block as the rank's rows: the partial
    sums reduce-scattered; the gradient all-gathered."""
    return _ScatterSum.apply(y, 1, tp)


def block_enter(x: torch.Tensor, tp: Optional[TP],
                sp: Optional[TP] = None) -> torch.Tensor:
    """The input of a block run tensor-parallel on ``tp``:
    :func:`tp_enter`, or under ``sp`` (:func:`seq_tp`) the ranks' rows put
    whole (:func:`seq_enter`); ``x`` itself where ``tp`` is None."""
    if tp is None:
        return x
    return tp_enter(x, tp) if sp is None else seq_enter(x, sp)


def block_exit(y: torch.Tensor, tp: Optional[TP],
               sp: Optional[TP] = None) -> torch.Tensor:
    """The output of a block run tensor-parallel on ``tp``: the partial
    sums added (:func:`tp_exit`), or under ``sp`` the rank's rows of them
    (:func:`seq_exit`); ``y`` itself where ``tp`` is None."""
    if tp is None:
        return y
    return tp_exit(y, tp) if sp is None else seq_exit(y, sp)


def rank_columns(p: torch.Tensor, tp: TP, width: int) -> torch.Tensor:
    """This rank's ``width`` columns (the block of the last dimension at
    its ``model`` index) of a leaf that every ``model`` rank holds whole:
    a gate of a tensor-parallel block, whose columns are the block's heads
    or features.  The rank's use gives the gradient of its own columns
    only; :func:`tp_enter` sums it over ``model``, so that every rank
    holds the whole leaf's gradient, as the trainer takes a replicated
    leaf's."""
    return tp_enter(placed(p), tp).narrow(-1, tp.index * width, width)


def on_sequence(block, h: torch.Tensor, sp: Optional[TP],
                tp: Optional[TP] = None):
    """``block`` on ``h``, under ``sp`` (:func:`seq_tp`) the rank's rows of
    the sequence; without ``sp``, ``block(h)``.  A tensor-parallel block
    (its ``tp`` given) takes the rows, ``block(h, sp=sp)``, and enters and
    leaves the sequence itself (:func:`seq_enter`, :func:`seq_exit`).  Any
    other runs whole on every rank, on the gathered sequence, and gives
    the rank's rows of its output (of a tuple's first: the MoE's
    ``(y, aux)``)."""
    if sp is None:
        return block(h)
    if tp is not None:
        return block(h, sp=sp)
    out = block(tp_gather(h, sp, 1))
    if isinstance(out, tuple):
        return (seq_rows(out[0], sp),) + out[1:]
    return seq_rows(out, sp)


def tp_of(mesh) -> Optional[TP]:
    """The ``model`` axis of ``mesh`` as a :class:`TP`, None where it has
    one rank."""
    if mesh is None or mesh.shape.get("model", 1) == 1:
        return None
    return TP(mesh.group("model"), mesh.shape["model"],
              mesh.axis_index("model"))


def active_tp() -> Optional[TP]:
    """:func:`tp_of` the active mesh (None without one)."""
    ctx = active()
    return tp_of(ctx[0]) if ctx is not None else None


# ---------------------------------------------------------------------------
# decode caches
# ---------------------------------------------------------------------------


def cache_block_spec(path: str, shape: Sequence[int], mesh) -> P:
    """The spec of the port's per-layer block of the reference's stacked
    decode-cache leaf ``path`` (its ``init_decode_cache`` tree) of
    ``shape``: the leaf's :func:`leaf_spec`, as the reference's dry run
    places its caches, without the layer dimension.  The rule
    for ``n`` is written for the SSM's (B, H, DK) normaliser; on the
    sLSTM's (B, W) normaliser it lands one dimension early (the layer
    axis over the batch axes, the rows over ``model``), a layout no step
    could use without moving the state between ranks: the port lays the
    sLSTM's ``n`` out as its ``c`` and ``m``."""
    parts = path.split("/")
    if parts[-1] == "n" and len(parts) > 1 and parts[-2] == "sl":
        path = "/".join(parts[:-1] + ["c"])
    spec = leaf_spec(path, shape, mesh)
    return P(*spec[1:])


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """``x`` averaged over the active mesh's batch axes (``Mesh.
    batch_axes``): the statistic the reference takes over the whole batch,
    from each rank's mean over its equal share of the rows.  The identity
    without a mesh or with one batch rank."""
    ctx = active()
    if ctx is None:
        return x
    mesh = ctx[0]
    group = mesh.group(mesh.batch_axes)
    if group is None:
        return x
    return _BatchMean.apply(x, group)
