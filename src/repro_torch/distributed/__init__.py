"""Multi-process execution: ranks as processes of a ``torch.distributed``
group (``process_group``).  The linalg path's group backend is
``linalg.collectives.GroupComm``; the models' sharding (``sharding.py``)
comes in a later slice, in this package."""

from .process_group import (broadcast, card_per_rank, devices_for,
                            host_or_device, on_cpu, on_first_card, recv,
                            send, spawn, stages, to_device, to_host,
                            transport)

__all__ = ["broadcast", "card_per_rank", "devices_for", "host_or_device",
           "on_cpu", "on_first_card", "recv", "send", "spawn", "stages",
           "to_device", "to_host", "transport"]
