"""Three-term roofline of one rank's step, counted as the step runs.

    compute term    = sum over operand types of FLOPs / that type's peak
    memory term     = bytes / HBM bandwidth
    collective term = collective bytes / link bandwidth

The reference parses a compiled XLA artifact (``core/hlo.py``); the port
counts the eager step itself, on the ``meta`` device or on the card
(:func:`analyze_step`), under one dispatch mode (:class:`CountingMode`):

* FLOPs by operand type: what ``core/hlo.py`` counts (products and
  convolutions, through ``torch.utils.flop_counter``'s formulas), and the
  hand-written kernels' own work (K4, K5, K6 register their formulas with
  their operators, ``kernels/*/ops.py``);
* bytes: every operation's inputs read and outputs written (eager PyTorch
  is unfused, so this is what the card moves); views move nothing;
* the peak of live bytes: the step's arguments, and every storage an
  operation makes while it lives (the counterpart of the reference's
  ``memory_analysis``), and the temporaries live at that peak by the
  operation that made them (``peak_by_op``: what holds the peak).

Collective bytes and calls come from ``distributed/process_group.py``'s
stats, summed operand sizes by kind as the reference sums them.  Every
term is per rank and in seconds.  The constants come from a ``Machine``,
by default ``H100_SXM``: spec-sheet peaks, not measurements; its 450 GB/s
link is NVLink within one 8-GPU host, so a ``model`` axis of 16 ranks,
which spans two hosts, is priced as if it did not.

``collective_term_calibrated`` multiplies the collective term by the
contention factor at neighbour distance, the paper's correction beyond
LogP, as the reference does.
"""

from __future__ import annotations

import dataclasses
import json
import time
import weakref
from collections import defaultdict
from typing import Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..distributed import process_group as pg
from .machine import H100_SXM, Machine
from .perfmodel import Calibration, IdentityCalibration

#: what every record this module writes says of its numbers
SPEC_NOTE = ("spec-sheet model of the card, not a measurement; the link is "
             "NVLink within one 8-GPU host, so a model axis of 16 ranks "
             "(two hosts) is priced as if it were one")


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops: float                       # per rank, every type
    memory_bytes: float                # per rank, inputs read + outputs written
    collective_bytes: float            # per rank, summed operand sizes
    collective_breakdown: Dict[str, float]
    collective_counts: Dict[str, float]
    model_flops: float                 # 6*N_active*D (train), 2*N_active*D
    raw_cost_analysis: Dict[str, float]
    memory_analysis: Dict[str, float]
    while_loops: list
    flops_by_type: Dict[str, float] = dataclasses.field(default_factory=dict)
    machine: Machine = H100_SXM

    # -- the three terms (seconds) ------------------------------------------
    @property
    def compute_term(self) -> float:
        if not self.flops_by_type:
            return self.flops / self.peak
        return sum(f / self.machine.peak_for(t)
                   for t, f in self.flops_by_type.items())

    @property
    def peak(self) -> float:
        """The dense (bf16) peak of one rank: the yardstick of
        ``roofline_fraction``."""
        return self.machine.peak_for("bfloat16")

    @property
    def memory_term(self) -> float:
        return self.memory_bytes / self.machine.hbm_bandwidth

    @property
    def collective_term(self) -> float:
        return self.collective_bytes / self.machine.link_bandwidth

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_term, "memory": self.memory_term,
                 "collective": self.collective_term}
        return max(terms, key=terms.get)

    @property
    def bound_time(self) -> float:
        """Lower-bound step time if terms overlap perfectly."""
        return max(self.compute_term, self.memory_term, self.collective_term)

    @property
    def serial_time(self) -> float:
        return self.compute_term + self.memory_term + self.collective_term

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / all ranks' counted FLOPs: remat and redundancy."""
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the ranks' dense peak the step reaches if it runs at
        the bound: MODEL_FLOPS / (bound_time * chips * peak)."""
        denom = self.bound_time * self.chips * self.peak
        return self.model_flops / denom if denom else 0.0

    def to_dict(self) -> dict:
        d = {f.name: getattr(self, f.name)
             for f in dataclasses.fields(self) if f.name != "machine"}
        d = json.loads(json.dumps(d))          # plain copies
        d.update(compute_term=self.compute_term, memory_term=self.memory_term,
                 collective_term=self.collective_term, dominant=self.dominant,
                 bound_time=self.bound_time,
                 useful_flops_fraction=self.useful_flops_fraction,
                 roofline_fraction=self.roofline_fraction,
                 machine=self.machine.name,
                 peaks={t: self.machine.peak_for(t)
                        for t in (self.flops_by_type or {"bfloat16": 0})},
                 hbm_bandwidth=self.machine.hbm_bandwidth,
                 link_bandwidth=self.machine.link_bandwidth,
                 notes=SPEC_NOTE)
        return d


# ---------------------------------------------------------------------------
# counting a step
# ---------------------------------------------------------------------------

def tensor_bytes(t: torch.Tensor) -> int:
    """The bytes ``t`` spans: its elements, a broadcast (zero-stride)
    dimension counted once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


_LOG_SIGMOID = torch.ops.aten.log_sigmoid_forward.default


def _tensors(tree):
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


class CountingMode(TorchDispatchMode):
    """Counts what the operations run under it do: FLOPs by the first
    operand's type (``flops``), bytes read and written (``bytes``), and
    the live bytes of the storages they make (``live``, ``peak``), with
    the live bytes at the peak by the operation that made them
    (``peak_by_op``)."""

    def __init__(self):
        super().__init__()
        self.flops: Dict[str, float] = defaultdict(float)
        self.bytes = 0
        self.ops = 0
        self.live = 0
        self.peak = 0
        self.peak_by_op: Dict[str, int] = {}
        self._storages: Dict[int, tuple] = {}
        self._by_op: Dict[str, int] = defaultdict(int)

    def _free(self, key: int) -> None:
        n, op = self._storages.pop(key, (0, None))
        self.live -= n
        if op is not None:
            self._by_op[op] -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        formula = flop_registry.get(func._overloadpacket)
        if formula is None:
            # a composite operation reaches the mode whole under inference
            # mode: count the operations it is made of, as a graph-building
            # run (and the card) executes them
            with self:                 # the parts pass through the mode
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        self.ops += 1
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if func is _LOG_SIGMOID and outs[0].device.type != "cpu":
            # the CPU kernel fills a buffer for its backward; the card's
            # returns it empty, and a count takes what the card makes
            outs = outs[:1]
        if formula is not None and ins:
            self.flops[str(ins[0].dtype).replace("torch.", "")] += float(
                formula(*args, **kwargs, out_val=out))
        if not _is_view(func):
            self.bytes += sum(tensor_bytes(t) for t in ins)
            if not func.__name__.startswith(("empty", "new_empty")):
                self.bytes += sum(tensor_bytes(t) for t in outs)
        if any(r.alias_info is not None for r in func._schema.returns):
            return out             # a view or an in-place result: no storage
        mine = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._storages or key in mine:
                continue
            op = func.__name__
            self._storages[key] = (st.nbytes(), op)
            self.live += st.nbytes()
            self._by_op[op] += st.nbytes()
            weakref.finalize(st, self._free, key)
        if self.live > self.peak:
            self.peak = self.live
            self.peak_by_op = {k: v for k, v in self._by_op.items() if v}
        return out


def storages(*trees) -> Dict[int, int]:
    """{storage: bytes} of the distinct storages of the tensors in
    ``trees`` (a module counts its parameters and buffers)."""
    seen = {}
    flat = [list(x.parameters()) + list(x.buffers())
            if isinstance(x, torch.nn.Module) else x
            for x in tree_flatten(trees)[0]]
    for t in _tensors(flat):
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return seen


@dataclasses.dataclass
class Count:
    """What :func:`count_step` saw: FLOPs by type, bytes, the memory
    (``memory_analysis``' keys), the collectives by kind, the wall."""
    flops_by_type: Dict[str, float]
    bytes: float
    memory: Dict[str, float]
    collective_bytes: Dict[str, float]
    collective_calls: Dict[str, float]
    ops: int
    wall_s: float
    #: the temporaries live at the peak, by the operation that made them
    #: (the eight largest)
    peak_by_op: Dict[str, float] = dataclasses.field(default_factory=dict)


def count_step(step: Callable[[], object], arguments=()) -> Count:
    """Run ``step()`` once under :class:`CountingMode`, with the
    collective stats reset before it.  ``arguments`` are the tensors the
    step takes (parameters, optimizer state, batch): their bytes are
    ``argument_bytes``; ``temp_bytes`` is the peak of the bytes the step
    made and held at once, ``output_bytes`` what it still holds at its
    end (its outputs), and ``total_bytes`` the peak a rank holds."""
    pg.reset_collective_stats()
    mode = CountingMode()
    held = storages(arguments)
    args = sum(held.values())
    t0 = time.perf_counter()
    with mode:
        result = step()
    wall = time.perf_counter() - t0
    out = sum(n for key, n in storages(result).items() if key not in held)
    del result
    stats = pg.collective_stats()
    memory = {"argument_bytes": float(args), "output_bytes": float(out),
              "temp_bytes": float(mode.peak), "alias_bytes": 0.0,
              "total_bytes": float(args + mode.peak)}
    top = sorted(mode.peak_by_op.items(), key=lambda kv: -kv[1])[:8]
    return Count(dict(mode.flops), float(mode.bytes), memory,
                 {k: float(v) for k, v in stats["bytes_by_kind"].items()},
                 {k: float(v) for k, v in stats["calls_by_kind"].items()},
                 mode.ops, wall, {k: float(v) for k, v in top})


def terms_of(count: Count, *, arch: str, shape: str, mesh_name: str,
             chips: int, model_flops: float,
             machine: Machine = H100_SXM) -> RooflineTerms:
    """:class:`RooflineTerms` from one :func:`count_step`."""
    return RooflineTerms(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops=sum(count.flops_by_type.values()),
        memory_bytes=count.bytes,
        collective_bytes=sum(count.collective_bytes.values()),
        collective_breakdown=dict(count.collective_bytes),
        collective_counts=dict(count.collective_calls),
        model_flops=model_flops, raw_cost_analysis={},
        memory_analysis=dict(count.memory), while_loops=[],
        flops_by_type=dict(count.flops_by_type), machine=machine)


def analyze_step(step: Callable[[], object], arguments=(), *, arch: str,
                 shape: str, mesh_name: str, chips: int, model_flops: float,
                 machine: Machine = H100_SXM) -> RooflineTerms:
    """The counterpart of the reference's ``analyze_compiled``: run the
    step once, counted, and give its three terms."""
    return terms_of(count_step(step, arguments), arch=arch, shape=shape,
                    mesh_name=mesh_name, chips=chips,
                    model_flops=model_flops, machine=machine)


def collective_term_calibrated(terms: RooflineTerms,
                               calibration: Optional[Calibration] = None,
                               p: Optional[int] = None,
                               synchronized: bool = True) -> float:
    """Paper-faithful collective term: the ideal time scaled by the
    contention factor at neighbour distance (ring schedules talk to
    distance-1 neighbours; the factor captures link sharing when every
    rank does so at once).  ``synchronized=True`` uses C_max: a collective
    is a synchronization, per the paper's rule."""
    calibration = calibration or IdentityCalibration()
    p = p or terms.chips
    factor = (calibration.c_max(p, 1.0) if synchronized
              else calibration.c_avg(1.0))
    return terms.collective_term * factor


def format_table(rows: list) -> str:
    """Markdown table of :class:`RooflineTerms`."""
    hdr = ("| arch | shape | mesh | compute s | memory s | collective s | "
           "dominant | MODEL_FLOPS | useful frac | roofline frac |")
    sep = "|" + "---|" * 10
    lines = [hdr, sep]
    for t in rows:
        lines.append(
            f"| {t.arch} | {t.shape} | {t.mesh} | {t.compute_term:.4g} | "
            f"{t.memory_term:.4g} | {t.collective_term:.4g} | {t.dominant} | "
            f"{t.model_flops:.3g} | {t.useful_flops_fraction:.3f} | "
            f"{t.roofline_fraction:.3f} |")
    return "\n".join(lines)


def save_terms(terms: RooflineTerms, path: str):
    with open(path, "w") as f:
        json.dump(terms.to_dict(), f, indent=1)


def load_terms(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
