"""The placement rule of the mining stores across workers.

The counterpart of ``repro.runtime.sharding.partition_sharding``: the
OL and edge-OL stores are partition-major (dim 0 is the graph-partition
axis), blocked over the workers.  Worker ``r`` of ``W`` holds the
contiguous block ``[r·NP/W, (r+1)·NP/W)``, so worker order IS partition
order and the level wire's per-worker support shards reassemble by plain
concatenation.  The upload, the checkpoint save and the resume all use
this one rule.
"""
from __future__ import annotations

__all__ = ["partition_block"]


def partition_block(n_partitions: int, rank: int, n_workers: int) -> slice:
    """The slice of the partition axis that worker ``rank`` of
    ``n_workers`` holds; raises unless the partitions divide evenly."""
    if n_partitions % n_workers:
        raise ValueError(f"{n_partitions} partitions do not divide over "
                         f"{n_workers} workers")
    if not 0 <= rank < n_workers:
        raise ValueError(f"rank {rank} outside [0, {n_workers})")
    per = n_partitions // n_workers
    return slice(rank * per, (rank + 1) * per)
