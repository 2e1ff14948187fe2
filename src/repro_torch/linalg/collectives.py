"""Collectives of the linalg variants: one interface, two backends.

The counterparts of the reference's ``lax`` collectives inside
``shard_map``.  A variant's body takes its collectives from its grid
(``grid.comm``), so the same body runs on either backend:

* the **stacked** backend (:data:`STACKED`, the module functions below):
  every rank in one process on one device, operands stacked as
  ``(c, g, g, ...)`` (grid axes ``lyr``, ``row``, ``col`` are the leading
  three dimensions).  ``ppermute`` along one axis by a uniform shift is
  :func:`shift` (``torch.roll``); by a fixed permutation of the flattened
  grid (the Cannon skew, the Cholesky transpose) :func:`permute_grid`, one
  index gather; ``psum`` over an axis is :func:`psum`, a sum broadcast back
  to every rank; ``axis_index`` is :func:`axis_index`, a broadcast
  ``arange``; the select-and-reduce broadcast is :func:`bcast_from`.
  Every rank runs on one stream of one device, so a serialization barrier
  (the reference's ``optimization_barrier``) is already implied by eager
  execution: :func:`barrier` marks where the schedule has one.
* the **group** backend (:class:`GroupComm`): each rank a process of a
  ``torch.distributed`` group, holding its own block shaped
  ``(1, 1, 1, rb, cb)``, so that the bodies and the kernel hooks see the
  shapes they see stacked.  ``psum`` is ``all_reduce`` on the rank's row,
  column or layer subgroup; ``bcast_from`` select-and-reduce on it;
  ``shift`` and ``permute_grid`` one ``batch_isend_irecv`` (a rank that
  would send to itself keeps its block).  A gloo group given CUDA tensors stages
  every operation through pinned host memory
  (``distributed.process_group.stages``).

Overlap: ``shift_start`` / ``psum_start`` / ``bcast_start`` return a
handle and ``wait(handle)`` its result.  The stacked backend computes at
once, so its numbers do not move; the group backend issues the operations
asynchronously (on gloo after the block's device-to-host copy) and
returns before they finish.
"""

from __future__ import annotations

import time
import weakref
from datetime import timedelta
from typing import Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ..distributed.process_group import (GROUP_TIMEOUT_S, stages, to_device,
                                         to_host)

AXES = {"lyr": 0, "row": 1, "col": 2}


def axis_index(axis: str, x: torch.Tensor) -> torch.Tensor:
    """Each rank's index along ``axis``, shaped to broadcast against
    ``x``."""
    dim = AXES[axis]
    shape = [1] * x.ndim
    shape[dim] = x.shape[dim]
    return torch.arange(x.shape[dim], device=x.device).view(shape)


def psum(x: torch.Tensor, axis: str) -> torch.Tensor:
    """Sum over ``axis``, the result on every rank of that axis."""
    dim = AXES[axis]
    return x.sum(dim=dim, keepdim=True).expand_as(x)


def bcast_from(x: torch.Tensor, axis: str,
               k: Union[int, torch.Tensor]) -> torch.Tensor:
    """Select-and-reduce broadcast of the block owned by index ``k`` along
    ``axis`` (``k`` may differ per layer: a broadcastable tensor)."""
    return psum(torch.where(axis_index(axis, x) == k, x, 0), axis)


def shift(x: torch.Tensor, axis: str, by: int = -1) -> torch.Tensor:
    """Uniform ring shift along ``axis``: rank ``k`` receives the block of
    rank ``k - by`` (``by=-1``: every block moves to rank ``k - 1``)."""
    return torch.roll(x, shifts=by, dims=AXES[axis])


def permute_grid(x: torch.Tensor,
                 perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Move blocks between ranks of the flattened (lyr, row, col) grid by
    ``(source, destination)`` pairs covering every rank once."""
    size = x.shape[0] * x.shape[1] * x.shape[2]
    src = [-1] * size
    for s, d in perm:
        src[d] = s
    if sorted(src) != list(range(size)):
        raise ValueError("permute_grid needs a permutation of every rank")
    flat = x.reshape(size, *x.shape[3:])
    return flat[torch.tensor(src, device=x.device)].reshape(x.shape)


def barrier(*xs):
    """The serialized variants' barrier: the next step waits for these
    values.  Eager execution on one stream already orders every step, so
    the stacked backend returns its arguments unchanged."""
    return xs


# -- the interface, on the stacked backend ------------------------------------

class Done:
    """A handle whose result is already computed."""

    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value


class Stacked:
    """The stacked backend behind the interface the bodies call: the module
    functions above; a start computes at once and its wait returns the
    result."""

    axis_index = staticmethod(axis_index)
    psum = staticmethod(psum)
    bcast_from = staticmethod(bcast_from)
    shift = staticmethod(shift)
    permute_grid = staticmethod(permute_grid)
    barrier = staticmethod(barrier)

    def shift_start(self, x, axis, by=-1):
        return Done(shift(x, axis, by))

    def psum_start(self, x, axis):
        return Done(psum(x, axis))

    def bcast_start(self, x, axis, k):
        return Done(bcast_from(x, axis, k))

    def wait(self, handle):
        return handle.value

    def computes_first(self, mask) -> bool:
        """Whether this rank runs its product before a look-ahead
        collective whose result it reads only where ``mask`` holds
        (Cholesky's next pivot).  Stacked ranks share one order: the
        product first."""
        return True


STACKED = Stacked()


# -- the group backend --------------------------------------------------------

# group -> {grid shape: {"grid": subgroup of the grid's ranks,
#                        axis: {line: (subgroup, global ranks)}}}
_SUBGROUPS = weakref.WeakKeyDictionary()


def _line_of(axis: str, coords, k: int):
    """The coordinates of rank ``k`` along ``axis`` on ``coords``' line."""
    out = list(coords)
    out[AXES[axis]] = k
    return tuple(out)


def _flat(coords, shape) -> int:
    l, i, j = coords
    return (l * shape[1] + i) * shape[2] + j


def coords_of(rank: int, shape) -> Tuple[int, int, int]:
    """The (lyr, row, col) coordinates of grid rank ``rank``."""
    _c, r, q = shape
    return rank // (r * q), (rank // q) % r, rank % q


def subgroups(group, shape):
    """The subgroups of ``group`` that a grid of ``shape`` communicates on:
    its own ranks (where the group has more) and every row, column and
    layer line longer than 1, and under ``"comm"`` this process's
    :class:`GroupComm` (None for a rank beyond the grid).  Created once per
    (group, shape) and cached.  ``new_group`` is collective, so every rank
    of the world calls this, in the same order, for the lines it is not on
    too."""
    world = dist.get_world_size(group)
    if world != dist.get_world_size():
        raise ValueError("the linalg group backend needs a group of the "
                         "whole world (new_group is collective over it)")
    cache = _SUBGROUPS.setdefault(group, {})
    if shape in cache:
        return cache[shape]
    p = shape[0] * shape[1] * shape[2]
    if p > world:
        raise ValueError(f"a {shape} grid needs {p} ranks, the group has "
                         f"{world}")
    timeout = timedelta(seconds=GROUP_TIMEOUT_S)
    glob = [dist.get_global_rank(group, r) for r in range(p)]
    out = {"grid": (group if p == world
                    else dist.new_group(glob, timeout=timeout))}
    for axis in AXES:
        size = shape[AXES[axis]]
        if size == 1:
            continue
        lines = {}
        for r in range(p):
            coords = coords_of(r, shape)
            if coords[AXES[axis]] != 0:
                continue
            ranks = [glob[_flat(_line_of(axis, coords, k), shape)]
                     for k in range(size)]
            lines[coords] = (dist.new_group(ranks, timeout=timeout), ranks)
        out[axis] = lines
    # one collective of every rank before any point-to-point: NCCL sets a
    # group's communicator up at its first operation, which must then
    # involve every rank (a rank whose block stays put sends nothing)
    dist.barrier(group)
    rank = dist.get_rank(group)
    out["comm"] = GroupComm(group, rank, shape, out) if rank < p else None
    cache[shape] = out
    return out


class Pending:
    """A started group operation: its works, the buffer that receives the
    result, the device the result goes back to (staged) or None, and the
    send buffer, kept alive until the works complete."""

    __slots__ = ("works", "buf", "device", "keep")

    def __init__(self, works, buf, device, keep=None):
        self.works = works
        self.buf = buf
        self.device = device
        self.keep = keep


class GroupComm:
    """The group backend for rank ``rank`` of ``group`` on a grid of
    ``shape`` = (layers, rows, cols): grid rank k is the group's rank k, at
    coordinates :func:`coords_of`.  Every rank of the grid calls each
    collective in the same order.

    ``pending`` counts the operations started and not yet waited for;
    ``wait_s`` sums the host seconds spent in this backend's calls
    (staging, issuing, waiting): the communication a rank did not hide."""

    def __init__(self, group, rank: int, shape, subs):
        self.group = group
        self.rank = rank
        self.shape = tuple(shape)
        self.coords = coords_of(rank, self.shape)
        self.lines = {}
        for axis in AXES:
            if axis in subs:
                base = _line_of(axis, self.coords, 0)
                self.lines[axis] = subs[axis][base]
        self.pending = 0
        self.wait_s = 0.0

    # -- ranks and their coordinates
    def axis_index(self, axis: str, x: torch.Tensor) -> torch.Tensor:
        return torch.full([1] * x.ndim, self.coords[AXES[axis]],
                          dtype=torch.long, device=x.device)

    def computes_first(self, mask) -> bool:
        return bool(mask)

    def _global(self, grid_rank: int) -> int:
        return dist.get_global_rank(self.group, grid_rank)

    # -- buffers
    def _stages(self, x) -> bool:
        return stages(self.group, x)

    def _send_buf(self, x):
        if self._stages(x):
            return to_host(x.contiguous())
        return x.contiguous()

    def _recv_buf(self, x):
        if self._stages(x):
            return torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        return torch.empty(x.shape, dtype=x.dtype, device=x.device)

    def _pending(self, works, buf, x, keep=None):
        self.pending += 1
        return Pending(works, buf, x.device if self._stages(x) else None,
                       keep)

    # -- starts
    def psum_start(self, x, axis: str):
        if axis not in self.lines:
            return Done(x)
        t0 = time.perf_counter()
        buf = self._send_buf(x)
        if buf is x:
            buf = x.clone()
        work = dist.all_reduce(buf, group=self.lines[axis][0],
                               async_op=True)
        self.wait_s += time.perf_counter() - t0
        return self._pending([work], buf, x)

    def bcast_start(self, x, axis: str, k):
        return self.psum_start(
            torch.where(self.axis_index(axis, x) == k, x, 0), axis)

    def _exchange(self, x, src: int, dst: int):
        """Send ``x`` to grid rank ``dst`` and receive from grid rank
        ``src`` in one ``batch_isend_irecv``; a rank that would send to
        itself keeps its block (gloo refuses a send to oneself)."""
        if dst == self.rank:
            return Done(x)
        t0 = time.perf_counter()
        send, recv = self._send_buf(x), self._recv_buf(x)
        works = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, self._global(dst), self.group),
            dist.P2POp(dist.irecv, recv, self._global(src), self.group)])
        self.wait_s += time.perf_counter() - t0
        return self._pending(works, recv, x, keep=send)

    def shift_start(self, x, axis: str, by: int = -1):
        dim = AXES[axis]
        size = self.shape[dim]
        k = self.coords[dim]
        src = _flat(_line_of(axis, self.coords, (k - by) % size), self.shape)
        dst = _flat(_line_of(axis, self.coords, (k + by) % size), self.shape)
        return self._exchange(x, src, dst)

    def wait(self, handle):
        if isinstance(handle, Done):
            return handle.value
        t0 = time.perf_counter()
        with torch.profiler.record_function("comm_wait"):
            for work in handle.works:
                work.wait()
        out = handle.buf
        if handle.device is not None:
            out = to_device(out, handle.device)
        self.pending -= 1
        self.wait_s += time.perf_counter() - t0
        return out

    # -- the synchronous forms
    def psum(self, x, axis: str):
        return self.wait(self.psum_start(x, axis))

    def bcast_from(self, x, axis: str, k):
        return self.wait(self.bcast_start(x, axis, k))

    def shift(self, x, axis: str, by: int = -1):
        return self.wait(self.shift_start(x, axis, by))

    def permute_grid(self, x, perm: Sequence[Tuple[int, int]]):
        size = self.shape[0] * self.shape[1] * self.shape[2]
        src = [-1] * size
        for s, d in perm:
            src[d] = s
        if sorted(src) != list(range(size)):
            raise ValueError("permute_grid needs a permutation of every rank")
        dst = src.index(self.rank)
        return self.wait(self._exchange(x, src[self.rank], dst))

    @staticmethod
    def barrier(*xs):
        """Every synchronous operation has completed on return, so the
        serialized variants' barrier orders nothing more."""
        return xs
