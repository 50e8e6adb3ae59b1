"""Partitioning: ``hash_partition`` and ``round_robin_partition`` (port of
``cudf_tpu/ops/partitioning.py``; libcudf's partitioning.cu,
round_robin.cu).

A row's partition is its ``ops/row_ops.py`` ``row_hash`` modulo P.  That
hash is the reference's uint64 bits held in int64, so the remainder is
taken of the unsigned value: a negative int64 h is 2^64 + h, whose
remainder is (h mod P + 2^64 mod P) mod P.  The rows then come out
ordered by partition (a stable sort of the ids: ``torch.sort(stable=True)``,
no kernel of A-H) with int64 offsets[P + 1] from a bincount, the
reference's output.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.core.table import Table
from cudf_tpu_torch.ops import copying
from cudf_tpu_torch.ops.row_ops import row_hash
from cudf_tpu_torch.utils import tracing


def unsigned_remainder(h: torch.Tensor, divisor: int) -> torch.Tensor:
    """int64 bits read as uint64, modulo ``divisor`` (int64 [n])."""
    r = torch.remainder(h, divisor)
    return torch.where(h < 0, (r + (1 << 64) % divisor) % divisor, r)


def partition_ids(keys: Sequence[Column], num_partitions: int, seed: int = 0) -> torch.Tensor:
    """int32 [n]: each row's partition, row_hash mod P (unsigned)."""
    return unsigned_remainder(row_hash(list(keys), seed=seed), num_partitions).to(torch.int32)


def hash_partition(table: Table, key_names: Sequence[str], num_partitions: int,
                   seed: int = 0) -> Tuple[Table, torch.Tensor]:
    """(the rows ordered by partition, int64 offsets[P + 1])."""
    pids = partition_ids([table[k] for k in key_names], num_partitions, seed)
    return partition_by_ids(table, pids, num_partitions)


def partition_by_ids(table: Table, pids: torch.Tensor,
                     num_partitions: int) -> Tuple[Table, torch.Tensor]:
    """The rows stably ordered by ``pids`` and each partition's offsets."""
    order = torch.sort(pids, stable=True).indices
    out = copying.gather_table(table, order, bounds_check=False)
    counts = tracing.synced("partition_sizes", pids, torch.bincount, pids.long(),
                            minlength=num_partitions, syncs=2)
    offsets = torch.zeros(num_partitions + 1, dtype=torch.int64, device=pids.device)
    torch.cumsum(counts, 0, out=offsets[1:])
    return out, offsets


def round_robin_partition(table: Table, num_partitions: int,
                          start_partition: int = 0) -> Tuple[Table, torch.Tensor]:
    """Row i to partition (i + start) mod P."""
    rows = torch.arange(table.num_rows, dtype=torch.int64, device=_device(table))
    pids = ((rows + start_partition) % num_partitions).to(torch.int32)
    return partition_by_ids(table, pids, num_partitions)


def _device(table: Table) -> torch.device:
    return table.column(0).device
