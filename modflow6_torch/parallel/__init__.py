"""Sharded runners: a model split into P shards solved as one system.

Port of modflow6_tpu/parallel (see ``sharded`` for how one controller
drives the P shards in place of a ``shard_map`` program)."""

from .partition import RowPartition, partition_model
from .sharded import ShardedSolution, ShardVec

__all__ = ["RowPartition", "ShardVec", "ShardedSolution", "partition_model"]
