"""Collectives of the single-process stacked-rank backend.

The counterparts of the reference's ``lax`` collectives inside
``shard_map``, on operands stacked as ``(c, g, g, ...)`` (grid axes
``lyr``, ``row``, ``col`` are the leading three dimensions):

* ``ppermute`` along one axis by a uniform shift is :func:`shift`
  (``torch.roll``);
* ``ppermute`` by a fixed permutation of the flattened grid (the Cannon
  skew, the Cholesky transpose) is :func:`permute_grid`, one index gather;
* ``psum`` over an axis is :func:`psum`, a sum broadcast back to every rank;
* ``axis_index`` is :func:`axis_index`, a broadcast ``arange``;
* the select-and-reduce broadcast is :func:`bcast_from`.

Every rank runs on one stream of one device, so a serialization barrier
(the reference's ``optimization_barrier``) is already implied by eager
execution: :func:`barrier` marks where the schedule has one.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

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
