"""Multi-process execution: ranks as processes of a ``torch.distributed``
group (``process_group``: spawning a world, staging, the collectives), and
the models' logical-axis sharding over a mesh of those ranks
(``sharding``: the rules, each rank's blocks, the tensor-parallel and
gather steps).  The linalg path's group backend is
``linalg.collectives.GroupComm``."""

from .process_group import (all_gather, all_reduce, broadcast, card_per_rank,
                            collective_stats, devices_for, host_or_device,
                            on_cpu, on_first_card, recv, reduce_scatter,
                            reset_collective_stats, send, spawn, stages,
                            to_device, to_host, transport)
from .sharding import (P, Mesh, constrain, gather, param_spec, shard_of,
                       tree_param_specs, use_mesh, valid_spec, zero_spec)

__all__ = ["P", "Mesh", "all_gather", "all_reduce", "broadcast",
           "card_per_rank", "collective_stats", "constrain", "devices_for", "gather",
           "host_or_device", "on_cpu", "on_first_card", "param_spec", "recv",
           "reduce_scatter", "reset_collective_stats", "send", "shard_of", "spawn", "stages",
           "to_device", "to_host", "transport", "tree_param_specs",
           "use_mesh", "valid_spec", "zero_spec"]
