"""Devices of the port: ``torch.device`` objects, one per rank.

The reference takes its framework's devices; the port takes a sequence of
``torch.device``.  Entries may repeat one device: ``[cuda:0] * 8`` runs an
8-rank plan on one card, the counterpart of forced host devices.
"""

from __future__ import annotations

from typing import List

import torch


def default_devices() -> List[torch.device]:
    """The default pool: the current CUDA device.  There is no CPU
    fallback — without a GPU the caller must name its devices."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass devices=[torch.device('cpu')] "
            "* p to run the plain versions on the CPU")
    return [canonical(torch.device("cuda"))]


def canonical(device) -> torch.device:
    """``torch.device`` with the CUDA index made explicit, so that
    ``cuda`` and ``cuda:0`` compare equal."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def device_kind_of(device) -> str:
    """The card's name for a CUDA device, the platform name otherwise."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type
