"""Collectives: the group API between processes (`collective.py`, the
reference's twelve names) and, in `ops`, the ones over a mesh axis for
code that runs on each rank's own shard."""

from ray_tpu_torch.util.collective.collective import (
    allgather,
    allreduce,
    barrier,
    broadcast,
    destroy_collective_group,
    get_collective_group_size,
    get_rank,
    init_collective_group,
    is_group_initialized,
    recv,
    reducescatter,
    send,
)

__all__ = [
    "init_collective_group", "destroy_collective_group", "allreduce",
    "allgather", "reducescatter", "broadcast", "barrier", "send", "recv",
    "get_rank", "get_collective_group_size", "is_group_initialized",
]
