"""Execution over several cards (port of ``cudf_tpu/parallel``): a mesh
of ``torch.distributed`` ranks, one process a card, hash shuffles between
them, and distributed relational ops.

The reference rides XLA collectives inside one ``shard_map`` program; here
every rank runs the port's own local tiers (groupby, join, sort) over its
rows, and NCCL (between cards) or gloo (between CPU processes) collectives
move rows between ranks: ``all_to_all_single`` for shuffles,
``all_gather`` for broadcasts, samples and results, ``all_reduce`` for
counts and decisions every rank must share.
"""

from cudf_tpu_torch.parallel.mesh import Mesh, collect_frame, make_mesh, partition_frame
from cudf_tpu_torch.parallel.shuffle import (bucketize, exchange, shuffle_by_key,
                                             shuffle_by_keys)
from cudf_tpu_torch.parallel.dist import (
    broadcast_inner_join,
    dist_distinct,
    dist_groupby_sum,
    dist_groupby_sum_multi,
    dist_inner_join,
    dist_join,
    dist_sort,
    distributed_groupby_agg,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "partition_frame",
    "collect_frame",
    "bucketize",
    "exchange",
    "shuffle_by_key",
    "shuffle_by_keys",
    "dist_groupby_sum",
    "dist_groupby_sum_multi",
    "dist_inner_join",
    "dist_join",
    "dist_sort",
    "dist_distinct",
    "broadcast_inner_join",
    "distributed_groupby_agg",
]
