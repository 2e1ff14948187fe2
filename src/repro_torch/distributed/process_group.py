"""Ranks as processes of a ``torch.distributed`` group.

The counterpart of the reference's forced host devices: where the
reference runs P ranks as P devices of one process, the port's group
backend runs them as P processes, each owning its own blocks.

* :func:`spawn` starts ``world`` processes (the ``spawn`` start method,
  which CUDA needs), initialises the default group from a file store in
  ``init_dir`` (never a TCP port, so that several worlds can run side by
  side), calls ``fn(rank, world, device, *args)`` in each, and returns the
  ranks' results.  A rank that raises or hangs fails the call with that
  rank's traceback.
* ``device_of_rank``: :func:`on_cpu` (the tests), :func:`on_first_card`
  (every rank on ``cuda:0``, a gloo group: the one-card machine) and
  :func:`card_per_rank` (``cuda:r``, NCCL: a card of its own per rank);
  :func:`devices_for` picks one from a device type and a backend.
* The staging rule (:func:`stages`): gloo's point-to-point takes host
  tensors only, so a gloo group given CUDA tensors stages every operation
  the same way, through pinned host memory (:func:`to_host`,
  :func:`to_device`).  NCCL and CPU tensors do not stage.
* The collectives the models' sharding takes (``sharding.py``), on any
  group or subgroup, staged by the same rule: :func:`all_reduce` (sum or
  mean), :func:`all_gather` along a dimension and :func:`reduce_scatter`.
  Each returns a new tensor and leaves its input as it was.
"""

from __future__ import annotations

import datetime
import faulthandler
import os
import queue as queue_mod
import time
import traceback
from typing import Callable, List, Sequence

import torch
import torch.distributed as dist

#: seconds a collective of a spawned group, or of a linalg grid's
#: subgroup, may wait before it fails
GROUP_TIMEOUT_S = 60.0
#: seconds a spawned world may take to start, beyond its own timeout
START_SLACK_S = 60.0


def on_cpu(rank: int) -> torch.device:
    return torch.device("cpu")


def on_first_card(rank: int) -> torch.device:
    return torch.device("cuda", 0)


def card_per_rank(rank: int) -> torch.device:
    return torch.device("cuda", rank)


def devices_for(device: str, backend: str) -> Callable[[int], torch.device]:
    """``device_of_rank`` for a device type and a backend: the CPU; one
    card shared by every rank (gloo); a card per rank (NCCL)."""
    if device == "cpu":
        return on_cpu
    if device != "cuda":
        raise ValueError(f"device must be 'cpu' or 'cuda', got {device!r}")
    return card_per_rank if backend == "nccl" else on_first_card


def transport(backend: str, device: str) -> str:
    """What a measurement over this group measures, in words."""
    if backend == "gloo" and device == "cuda":
        return "gloo, staged through pinned host memory"
    return f"{backend}, {device} tensors"


# -- staging ------------------------------------------------------------------

def stages(group, x: torch.Tensor) -> bool:
    """True when ``x`` goes through pinned host memory on ``group``: a
    gloo group given a CUDA tensor."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def to_host(x: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of the CUDA tensor ``x``, complete on return: the
    copy runs on a side stream after the work already queued on the
    current stream."""
    side = _side_stream(x.device)
    # on the host by name: a caller's default device may be the card
    host = torch.empty(x.shape, dtype=x.dtype, device="cpu",
                       pin_memory=True)
    with torch.profiler.record_function("stage_d2h"):
        side.wait_stream(torch.cuda.current_stream(x.device))
        with torch.cuda.stream(side):
            host.copy_(x, non_blocking=True)
        side.synchronize()
    return host


def to_device(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``host`` on ``device``, queued on the current stream."""
    with torch.profiler.record_function("stage_h2d"):
        return host.to(device, non_blocking=True)


_SIDE = {}


def _side_stream(device: torch.device):
    stream = _SIDE.get(device)
    if stream is None:
        stream = _SIDE[device] = torch.cuda.Stream(device)
    return stream


def host_or_device(group, device: torch.device) -> torch.device:
    """Where a small tensor of the group's own bookkeeping (phase times,
    results of a benchmark) lives: the CPU, except on NCCL, which takes
    CUDA tensors only."""
    if dist.get_backend(group) == "nccl":
        return device
    return torch.device("cpu")


def broadcast(x: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """``x`` of rank ``src`` on every rank of ``group``: each rank passes a
    tensor of the same shape and type (its own values are overwritten),
    staged by the rule above."""
    group = group or dist.group.WORLD
    if stages(group, x):
        host = to_host(x)
        dist.broadcast(host, dist.get_global_rank(group, src), group=group)
        return to_device(host, x.device)
    x = x.clone()
    dist.broadcast(x, dist.get_global_rank(group, src), group=group)
    return x


def send(x: torch.Tensor, dst: int, group=None) -> None:
    """Send ``x`` to rank ``dst`` of ``group``, staged by the rule above."""
    group = group or dist.group.WORLD
    dist.send(to_host(x) if stages(group, x) else x.contiguous(),
              dist.get_global_rank(group, dst), group=group)


def recv(like: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """A tensor shaped and typed as ``like``, on its device, received from
    rank ``src`` of ``group``, staged by the rule above."""
    group = group or dist.group.WORLD
    staged = stages(group, like)
    buf = torch.empty(like.shape, dtype=like.dtype, pin_memory=staged,
                      device="cpu" if staged else like.device)
    dist.recv(buf, dist.get_global_rank(group, src), group=group)
    return to_device(buf, like.device) if staged else buf


def _group_size(group) -> int:
    return dist.get_world_size(group)


#: what this process's :func:`all_reduce`, :func:`all_gather` and
#: :func:`reduce_scatter` have done since :func:`reset_collective_stats`:
#: calls, bytes staged through pinned host memory (both ways) and host
#: seconds spent in them (staging copies and waits included)
_STATS = {"calls": 0, "staged_bytes": 0, "host_s": 0.0}


def collective_stats() -> dict:
    return dict(_STATS)


def reset_collective_stats() -> None:
    _STATS.update(calls=0, staged_bytes=0, host_s=0.0)


def _count(t0: float, staged_bytes: int) -> None:
    _STATS["calls"] += 1
    _STATS["staged_bytes"] += staged_bytes
    _STATS["host_s"] += time.perf_counter() - t0


def all_reduce(x: torch.Tensor, group=None, *, op: str = "sum"
               ) -> torch.Tensor:
    """The sum (``op="sum"``) or the mean (``op="mean"``) of ``x`` over the
    ranks of ``group``, on every rank, in ``x``'s type and on its device.
    On a gloo group a 2-byte float is reduced in fp32 and rounded once
    (gloo's half-precision sums are not taken); the mean divides the sum
    by the group's size."""
    group = group or dist.group.WORLD
    if op not in ("sum", "mean"):
        raise ValueError(f"op must be 'sum' or 'mean', got {op!r}")
    t0, n = time.perf_counter(), _group_size(group)
    narrow = (x.dtype in (torch.bfloat16, torch.float16)
              and dist.get_backend(group) == "gloo")
    buf = x.to(torch.float32) if narrow else x
    staged = stages(group, buf)
    if staged:
        host = to_host(buf)
        dist.all_reduce(host, group=group)
        out = to_device(host, x.device)
    else:
        out = buf.clone()
        dist.all_reduce(out, group=group)
    if op == "mean" and n > 1:
        out = out / n
    out = out.to(x.dtype) if narrow else out
    _count(t0, 2 * buf.numel() * buf.element_size() if staged else 0)
    return out


def all_gather(x: torch.Tensor, group=None, *, dim: int = 0
               ) -> torch.Tensor:
    """Every rank's ``x`` (one shape on every rank) concatenated along
    ``dim`` in the group's rank order, on every rank."""
    group = group or dist.group.WORLD
    t0, n = time.perf_counter(), _group_size(group)
    staged = stages(group, x)
    src = to_host(x) if staged else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    out = to_device(out, x.device) if staged else out
    _count(t0, (n + 1) * x.numel() * x.element_size() if staged else 0)
    return out


def reduce_scatter(x: torch.Tensor, group=None, *, dim: int = 0
                   ) -> torch.Tensor:
    """This rank's block along ``dim`` (the group's size divides it) of
    the sum of ``x`` over the group.  Gloo has no reduce-scatter: this is
    :func:`all_reduce` followed by this rank's block, which moves the
    whole tensor where a reduce-scatter moves one block of it."""
    group = group or dist.group.WORLD
    n = _group_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not split over {n} ranks")
    size = x.shape[dim] // n
    return all_reduce(x, group).narrow(dim, dist.get_rank(group) * size,
                                       size).contiguous()


# -- spawning a world ---------------------------------------------------------

def spawn(fn: Callable, world: int, *, backend: str = "gloo",
          device_of_rank: Callable[[int], torch.device] = on_cpu,
          init_dir: str, timeout_s: float = 120.0,
          args: Sequence = ()) -> List:
    """Run ``fn(rank, world, device, *args)`` in ``world`` new processes
    joined in one default group, and return their results by rank.

    ``fn`` and ``args`` are pickled (``fn`` by its import path).  The
    group's store is the file ``init_dir/store``: ``init_dir`` must be a
    directory that no other world uses.  Each rank's collectives fail after
    ``GROUP_TIMEOUT_S``, joining the group included; a rank still running
    ``timeout_s`` after the group formed writes its stack to
    ``init_dir/rank<r>.stack`` and exits.  The first failure
    (an exception, a rank that died, a hang) terminates every rank and
    raises ``RuntimeError`` with that rank's traceback or stack."""
    import multiprocessing as mp
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    os.makedirs(init_dir, exist_ok=True)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, rank, world, backend, device_of_rank,
                               init_dir, timeout_s, tuple(args), results))
             for rank in range(world)]
    for p in procs:
        p.start()
    done, failure = {}, None
    deadline = time.monotonic() + timeout_s + START_SLACK_S
    try:
        while len(done) < world and failure is None:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue_mod.Empty:
                failure = _silent_failure(procs, done, init_dir, deadline)
                continue
            if ok:
                done[rank] = payload
            else:
                failure = f"rank {rank} of {world} failed:\n{payload}"
    finally:
        if failure is not None:
            for p in procs:
                p.terminate()
        for p in procs:
            p.join(timeout=30)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    if failure is not None:
        raise RuntimeError(failure)
    return [done[r] for r in range(world)]


def _silent_failure(procs, done, init_dir, deadline):
    """The failure of a rank that reported nothing: it died, or the world
    outlived its deadline.  None while every rank may still report (a rank
    that exited with code 0 has put its result on the queue)."""
    for rank, p in enumerate(procs):
        if rank not in done and p.exitcode not in (None, 0):
            return (f"rank {rank} of {len(procs)} exited with code "
                    f"{p.exitcode} without a result"
                    + _stack(init_dir, rank))
    if time.monotonic() > deadline:
        late = [r for r in range(len(procs)) if r not in done]
        return (f"ranks {late} of {len(procs)} did not finish in time"
                + "".join(_stack(init_dir, r) for r in late))
    return None


def _stack(init_dir, rank) -> str:
    path = os.path.join(init_dir, f"rank{rank}.stack")
    try:
        with open(path) as f:
            text = f.read().strip()
    except OSError:
        return ""
    return f"\nrank {rank}'s stack when it timed out:\n{text}" if text else ""


def _rank_main(fn, rank, world, backend, device_of_rank, init_dir, timeout_s,
               args, results):
    with open(os.path.join(init_dir, f"rank{rank}.stack"), "w") as stack:
        try:
            device = torch.device(device_of_rank(rank))
            if device.type == "cuda":
                torch.cuda.set_device(device)
            dist.init_process_group(
                backend, init_method=f"file://{init_dir}/store", rank=rank,
                world_size=world,
                timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
            # the timer starts once every rank has joined: a rank that
            # joins late is not the one that hangs
            faulthandler.dump_traceback_later(timeout_s, exit=True,
                                              file=stack)
            out = fn(rank, world, device, *args)
            dist.destroy_process_group()
        except Exception:
            results.put((rank, False, traceback.format_exc()))
            raise
        finally:
            faulthandler.cancel_dump_traceback_later()
        results.put((rank, True, out))
