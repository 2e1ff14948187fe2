"""Model-guided dispatch: the executable back half of the tuner.

``matmul`` / ``trsm`` / ``cholesky`` take *global* (unsharded) tensors,
ask the :class:`~repro_torch.tuner.autotune.Tuner` for an
:class:`~repro_torch.tuner.plan.ExecutionPlan`, build the planned 2D / 2.5D
process grid, block-distribute the operands (padding to the grid where
needed — identity-extended for triangular/SPD structure), and run the
chosen variant with the planned local kernels:

* ``local_kernel="pallas"`` (the CUDA default) wires the hand-written
  kernels (``kernels.matmul/trsm/cholesky``) in as the local matmul /
  triangular solve / diagonal factor — one batched launch over all the
  stacked ranks; on CPU tensors they run their plain versions;
* ``local_kernel="jnp"`` (the CPU default) uses the ``torch.matmul`` /
  ``torch.linalg`` locals.

The plan strings are the reference's, so its frozen plans load here.
Executors are memoized per (grid, devices, group, variant, kernel, tiles).

``group=`` (a ``torch.distributed`` group of the whole world, every process
making the same call) runs the plan with ranks as processes
(``linalg.collectives.GroupComm``): rank 0 plans and broadcasts the plan,
so every rank runs the same one whatever its plan cache holds; grid rank k
is the group's rank k and holds its own blocks; ranks beyond the plan's p
take no part in the grid and receive the result.  Each rank's ``devices``
entry is its device (default: the current CUDA device).

Every entry point is instrumented as the reference's is: with
``observe=True``, ``REPRO_TELEMETRY=1`` or ``REPRO_OBS=1`` a
``telemetry.PhaseTimer`` records the ``plan``, ``distribute`` and
``execute`` phases under ``obs`` spans and emits one run record.  CUDA
launches return before the device is done, so while a timer is active each
of ``distribute`` and ``execute`` ends in ``torch.cuda.synchronize``: a
phase's host time then holds its device work.  Unobserved calls add no
synchronize.  On a group each phase is the slowest rank's (``all_reduce``
of the maximum) and only rank 0 emits the record, as the reference's one
SPMD record; its ``meta`` adds ``comm_s``, the slowest rank's host seconds
in the group backend's calls, and the transport.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .. import obs, telemetry
from ..devices import canonical, default_devices, device_kind_of
from ..distributed.process_group import broadcast, host_or_device, transport
from ..kernels.cholesky.ops import cholesky as _kchol
from ..kernels.common import TilePlan
from ..kernels.matmul.ops import matmul as _kmm
from ..kernels.trsm.ops import trsm as _ktrsm
# NB: import the factories, not the modules — the linalg package shadows
# the trsm/cholesky module attributes with the dispatch wrappers.
from ..linalg.cannon import make as _make_cannon
from ..linalg.cholesky import make as _make_cholesky
from ..linalg.grid import (BLOCK, ROWS_OVER_LAYERS, Grid, collect,
                           distribute, make_grid_mesh)
from ..linalg.summa import make as _make_summa
from ..linalg.trsm import make as _make_trsm
from .autotune import Tuner, default_tuner
from .plan import ExecutionPlan

_LOCK = threading.Lock()
_EXECUTORS: Dict[tuple, object] = {}


# -- local kernel hooks -----------------------------------------------------

def _tiles_key(tiles: Dict[str, Dict[str, int]]) -> tuple:
    """Canonical hashable form of a plan's tiles map (executor memo key)."""
    return tuple(sorted((fam, tuple(sorted(blocks.items())))
                        for fam, blocks in (tiles or {}).items()))


def _tile_plans(tiles: Dict[str, Dict[str, int]]) -> Dict[str, TilePlan]:
    """The plan's JSON tile map as TilePlan objects."""
    return {fam: TilePlan.from_blocks(fam, blocks, source="plan")
            for fam, blocks in (tiles or {}).items()}


def _local_hooks(algo: str, local_kernel: str,
                 tiles: Optional[Dict[str, Dict[str, int]]] = None) -> dict:
    """The kernel wrappers as the variants' local hooks.  Every hook takes
    the stacked ``(c, g, g, ...)`` blocks of all ranks at once, so each
    kernel launch covers the whole grid (the ranks on ``blockIdx.z``)."""
    if local_kernel != "pallas":
        return {}
    plans = _tile_plans(tiles)
    mm_tp = plans.get("matmul")
    trsm_tp = plans.get("trsm")
    chol_tp = plans.get("cholesky")

    def local_mm(a, b):
        return _kmm(a, b, out_dtype=a.dtype, tiles=mm_tp)

    if algo in ("cannon", "summa"):
        return {"local_mm": local_mm}
    if algo == "trsm":
        def local_solve(b, u):
            return _ktrsm(u, b, tiles=trsm_tp, mm_tiles=mm_tp)
        return {"local_mm": local_mm, "local_solve": local_solve}
    if algo == "cholesky":
        def local_chol(a):
            return _kchol(a, tiles=chol_tp, mm_tiles=mm_tp)

        def local_panel_solve(a, ljj):
            # panel width is fixed by the diagonal factor's extent; only
            # the dgemm tail inherits a tile choice here
            return _ktrsm(ljj.mT, a, mm_tiles=mm_tp)
        return {"local_mm": local_mm, "local_chol": local_chol,
                "local_solve": local_panel_solve}
    raise ValueError(algo)


_MAKERS = {"cannon": _make_cannon, "summa": _make_summa, "trsm": _make_trsm,
           "cholesky": _make_cholesky}


def _executor(plan: ExecutionPlan, grid: Grid):
    key = (plan.algo, plan.variant, plan.g, plan.c, grid.device, grid.group,
           grid.rank, plan.local_kernel, _tiles_key(plan.tiles))
    with _LOCK:
        fn = _EXECUTORS.get(key)
    if fn is None:
        hooks = _local_hooks(plan.algo, plan.local_kernel, plan.tiles)
        fn = _MAKERS[plan.algo](grid, plan.variant, **hooks)
        with _LOCK:
            if len(_EXECUTORS) > 64:
                _EXECUTORS.clear()
            _EXECUTORS[key] = fn
    return fn


# -- padding ----------------------------------------------------------------

def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _pad_zero(x, rows: int, cols: int):
    return torch.nn.functional.pad(x, (0, cols - x.shape[1],
                                       0, rows - x.shape[0]))


def _pad_eye(x, size: int):
    """blockdiag(x, I): structure-preserving pad for triangular/SPD args."""
    n = x.shape[0]
    if size == n:
        return x
    out = _pad_zero(x, size, size)
    idx = torch.arange(n, size, device=x.device)
    out[idx, idx] = 1
    return out


def _check_square(name: str, x) -> int:
    if x.ndim != 2 or x.shape[0] != x.shape[1]:
        raise ValueError(f"{name} must be square 2-D, got {tuple(x.shape)} "
                         "(the paper's algorithms are square-grid)")
    return int(x.shape[0])


def _dtype_key(x) -> str:
    """Plan-cache dtype key: the bare type name ("float32"), as in the
    reference's plan keys."""
    return str(x.dtype).removeprefix("torch.")


# -- execution --------------------------------------------------------------

def _resolve(devices: Optional[Sequence], plan_p: int) -> Tuple:
    devices = list(devices) if devices is not None else default_devices()
    if len(devices) < plan_p:
        raise ValueError(f"plan needs {plan_p} devices, have {len(devices)}")
    return tuple(canonical(d) for d in devices[:plan_p])


def _group_devices(devices: Optional[Sequence], group) -> Tuple:
    """The device of each rank of ``group``: ``devices`` (one entry a rank)
    or, by default, each rank's current CUDA device."""
    world = dist.get_world_size(group)
    return _resolve(devices if devices is not None
                    else default_devices() * world, world)


def _settle(pt, device: torch.device) -> None:
    """End a timed phase on the device's clock: with a timer active, wait
    for the device so the phase's host time holds its device work."""
    if pt is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


def _run(plan: ExecutionPlan, grid: Grid, fn, ops, pt):
    """Distribute the padded operands, run the variant and collect the
    global result (``distribute`` and ``execute`` phases)."""
    _phase = telemetry.phase_scope
    n, g, c = plan.n, plan.g, plan.c
    m = _round_up(n, g)
    if plan.algo in ("cannon", "summa"):
        a, b = ops
        with _phase(pt, "distribute"):
            ad = distribute(_pad_zero(a, m, m), grid, BLOCK)
            bd = distribute(_pad_zero(b, m, m), grid, BLOCK)
            _settle(pt, grid.device)
        with _phase(pt, "execute"):
            out = collect(fn(ad, bd), grid, BLOCK)[:n, :n]
            _settle(pt, grid.device)
    elif plan.algo == "trsm":
        u, b = ops
        mb = _round_up(n, c * g)
        bx_spec = ROWS_OVER_LAYERS if c > 1 else BLOCK
        with _phase(pt, "distribute"):
            ud = distribute(_pad_eye(u, m), grid, BLOCK)
            bd = distribute(_pad_zero(b, mb, m), grid, bx_spec)
            _settle(pt, grid.device)
        with _phase(pt, "execute"):
            out = collect(fn(ud, bd), grid, bx_spec)[:n, :n]
            _settle(pt, grid.device)
    elif plan.algo == "cholesky":
        (a,) = ops
        with _phase(pt, "distribute"):
            ad = distribute(_pad_eye(a, m), grid, BLOCK)
            _settle(pt, grid.device)
        with _phase(pt, "execute"):
            out = collect(fn(ad), grid, BLOCK)[:n, :n]
            _settle(pt, grid.device)
    else:
        raise ValueError(f"unknown algo {plan.algo!r}")
    return out


#: the phases a group's ranks agree on, in a fixed order
_PHASES = ("plan", "distribute", "execute")


def _slowest(pt, group, device, comm_s: float) -> None:
    """Each phase, and ``comm_s``, as the slowest rank's."""
    vals = torch.tensor([pt.phases.get(k, 0.0) for k in _PHASES]
                        + [comm_s], dtype=torch.float64,
                        device=host_or_device(group, device))
    dist.all_reduce(vals, op=dist.ReduceOp.MAX, group=group)
    vals = vals.tolist()
    for k, v in zip(_PHASES, vals):
        if k in pt.phases or v > 0.0:
            pt.phases[k] = v
    backend = dist.get_backend(group)
    pt.meta.update(comm_s=vals[-1], world=dist.get_world_size(group),
                   transport=transport(backend, device.type))


def execute(plan: ExecutionPlan, *operands,
            devices: Optional[Sequence] = None, observe: bool = False,
            store=None, group=None, _plan_seconds: float = 0.0):
    """Run an already-resolved plan on its operands (benchmarks use this to
    force specific — including deliberately bad — variants).

    ``observe=True`` records this run's measured phases into the telemetry
    store even when global recording is off; ``store`` routes the record
    (default: the global default store).  ``group`` runs the plan with
    ranks as processes of that group (every process makes this call with
    the same plan and operands; see the module docstring).
    ``_plan_seconds`` lets the model-guided wrappers account the planning
    time they already spent."""
    if group is None:
        devs = _resolve(devices, plan.p)
    else:
        devs = _group_devices(devices, group)
        if plan.p > len(devs):
            raise ValueError(f"plan needs {plan.p} ranks, the group has "
                             f"{len(devs)}")
    grid = make_grid_mesh(plan.g, plan.g, layers=plan.c, devices=devs,
                          group=group)
    fn = _executor(plan, grid) if grid.member else None
    pt = None
    if observe or telemetry.enabled() or obs.enabled():
        pt = telemetry.timer_for_plan(plan, kind="dispatch")
        if _plan_seconds > 0.0:
            pt.add("plan", _plan_seconds)
    ops = [torch.as_tensor(x, device=grid.device) for x in operands]
    comm = grid.comm if group is not None else None
    comm0 = comm.wait_s if comm is not None else 0.0
    out = None
    # root span for the whole dispatch; the phase() children underneath
    # (distribute/execute) carry the predicted durations and pair up
    with obs.maybe_span(f"dispatch:{plan.algo}", cat="dispatch_root",
                        algo=plan.algo, variant=plan.variant, n=plan.n,
                        p=plan.p, c=plan.c,
                        predicted_total_s=plan.predicted.get("total")):
        if grid.member:
            out = _run(plan, grid, fn, ops, pt)
        if group is not None and len(devs) > plan.p:
            # the ranks beyond the grid receive rank 0's result
            with telemetry.phase_scope(pt, "execute"):
                if out is None:
                    out = torch.empty((plan.n, plan.n), dtype=ops[0].dtype,
                                      device=grid.device)
                out = broadcast(out, 0, group)
                _settle(pt, grid.device)
    if pt is not None:
        if group is not None:
            comm_s = comm.wait_s - comm0 if comm is not None else 0.0
            _slowest(pt, group, grid.device, comm_s)
            if dist.get_rank(group) != 0:
                return out
        pt.emit(store=store, force=observe)
    return out


def _plan_on_group(t: Tuner, op: str, n: int, dtype: str,
                   local_kernel: Optional[str], observe: bool, group,
                   devices) -> ExecutionPlan:
    """Rank 0's plan, on every rank: rank 0 plans for the group's size and
    its ranks' device kind and broadcasts the plan."""
    rank = dist.get_rank(group)
    box = [None]
    if rank == 0:
        dev = devices[0]
        try:
            box[0] = t.plan(op, n, device_count=len(devices),
                            platform=dev.type,
                            device_kind=device_kind_of(dev), dtype=dtype,
                            local_kernel=local_kernel,
                            observe=observe).to_dict()
        except Exception as exc:
            box[0] = {"error": f"{type(exc).__name__}: {exc}"}
            dist.broadcast_object_list(
                box, src=dist.get_global_rank(group, 0), group=group,
                device=host_or_device(group, devices[rank]))
            raise
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0),
                               group=group,
                               device=host_or_device(group, devices[rank]))
    if "error" in box[0]:
        raise RuntimeError(f"rank 0 could not plan {op}: {box[0]['error']}")
    return ExecutionPlan.from_dict(box[0])


def _dispatch(op: str, operands, devices, tuner, local_kernel, observe,
              group):
    """Plan ``op`` for its first operand's size and type, and execute."""
    t = tuner or default_tuner()
    n = int(operands[0].shape[0])
    dtype = _dtype_key(operands[0])
    t0 = time.perf_counter()
    with obs.maybe_span("plan", cat="dispatch", op=op, n=n):
        if group is None:
            devs = list(devices) if devices is not None \
                else default_devices()
            plan = t.plan(op, n, devices=devs, dtype=dtype,
                          local_kernel=local_kernel, observe=observe)
        else:
            devs = _group_devices(devices, group)
            plan = _plan_on_group(t, op, n, dtype, local_kernel, observe,
                                  group, devs)
    return execute(plan, *operands, devices=devs, observe=observe,
                   store=t.store, group=group,
                   _plan_seconds=time.perf_counter() - t0)


def matmul(A, B, *, devices: Optional[Sequence] = None,
           tuner: Optional[Tuner] = None,
           local_kernel: Optional[str] = None,
           observe: bool = False, group=None):
    """C = A @ B, model-guided: the tuner races the Cannon and SUMMA models
    over every realizable 2D/2.5D grid and executes the winner."""
    _check_square("A", A)
    if tuple(B.shape) != tuple(A.shape):
        raise ValueError(f"A {tuple(A.shape)} and B {tuple(B.shape)} must "
                         "match")
    return _dispatch("matmul", (A, B), devices, tuner, local_kernel,
                     observe, group)


def trsm(U, B, *, devices: Optional[Sequence] = None,
         tuner: Optional[Tuner] = None,
         local_kernel: Optional[str] = None,
         observe: bool = False, group=None):
    """Solve X U = B (U upper-triangular), model-guided."""
    _check_square("U", U)
    if tuple(B.shape) != tuple(U.shape):
        raise ValueError(f"U {tuple(U.shape)} and B {tuple(B.shape)} must "
                         "match")
    return _dispatch("trsm", (U, B), devices, tuner, local_kernel, observe,
                     group)


def cholesky(A, *, devices: Optional[Sequence] = None,
             tuner: Optional[Tuner] = None,
             local_kernel: Optional[str] = None,
             observe: bool = False, group=None):
    """L with A = L L^T (A SPD), model-guided."""
    _check_square("A", A)
    return _dispatch("cholesky", (A,), devices, tuner, local_kernel,
                     observe, group)
