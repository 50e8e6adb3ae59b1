"""A plan over the ranks of a mesh (port of ``cudf_tpu/engine/spmd.py``).

The reference lowers a whole plan into one jitted ``shard_map`` program
with static capacities, whose collectives ride the mesh axis.  torch has
no such program, so here one process drives each card: every rank builds
the same plan over the same sources, runs the partition-list executor of
``engine/streaming.py`` over its own partitions, and a ``Ranks`` object
puts collectives where that executor moves partitions in one process:

- a ``DataFrameScan`` (or ``PythonScan``, or a Scan of one file) gives
  each rank its row range; a Scan of several files gives file i to rank
  i % world;
- a hash shuffle (groupby partials, shuffle joins, ``.over()``,
  distinct) is ``parallel/shuffle.exchange``: ``all_to_all_single`` of
  the header rows, then of the rows;
- a broadcast join's right side and every node that runs on one partition
  gather their input with ``parallel/mesh.gather_table`` (``all_gather``),
  the broadcast chosen by an ``all_reduce`` of the right side's bytes so
  that every rank takes one branch; rank 0 keeps what a one-partition node
  gives;
- the sort's splitters come from an ``all_gather`` of every rank's
  samples, whole-column aggregates (a Reduce, a Select of aggregates) from
  an ``all_gather`` of every rank's partials;
- the result is gathered to every rank (``all_gather``).

The exchange is lossless: no capacity, no overflow ladder (the
reference's ``(1, 8, 64)`` retry).  A node whose work does not split over
the ranks (an aggregation that does not decompose, a whole-column
aggregate a Filter compares rows with) raises ``Unlowerable`` on every
rank at once; ``evaluate_streaming`` counts it (``get_fallback_stats``)
and runs the plan with its one-process executor over the mesh's size in
partitions, on every rank (each holds the whole sources).

Float join keys hash as the join compares them (``streaming._join_key_types``)
and every column keeps its mask through every step: the reference's
undecoded float keys and its zero-row probe's dropped masks
(``cudf_tpu/engine/spmd.py:240``, ``:256``) have no counterpart here.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.core.table import Table
from cudf_tpu_torch.engine import ir as IRs

# what the last evaluate_spmd did: the mesh's size, the files this rank
# read (of Scans of several files), this rank's rows out
LAST_RUN: dict = {"ranks": 0, "files": 0, "rows": 0}


class Unlowerable(Exception):
    """A plan node whose work does not split over the ranks of a mesh (the
    fallback signal of ``evaluate_streaming``)."""


def spmd_cache_clear() -> None:
    """Nothing is compiled or cached per plan here (the reference caches
    one jitted program a plan); kept for the reference's callers."""


class Ranks:
    """The exchanges of ``engine/streaming.py``'s executor over the ranks
    of ``mesh``: this rank holds its partitions, a shuffle leaves it one
    (the mesh's size is the partition count)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.n = mesh.size
        self.rank = mesh.rank

    def _local(self, parts: Sequence[Table]) -> Table:
        from cudf_tpu_torch.engine.streaming import _gather

        return _gather(list(parts))

    def source(self, t: Table) -> List[Table]:
        from cudf_tpu_torch.ops import copying
        from cudf_tpu_torch.parallel.mesh import row_range

        lo, hi = row_range(t.num_rows, self.rank, self.n)
        return [Table.from_pairs(t.names, [copying.slice(c, lo, hi) for c in t.columns])]

    def files(self, paths: Sequence[str]) -> List[str]:
        return list(paths)[self.rank::self.n]

    def route(self, parts: Sequence[Table], ids: Sequence[torch.Tensor]) -> List[Table]:
        from cudf_tpu_torch.engine.streaming import _produced, _unspill
        from cudf_tpu_torch.parallel.shuffle import exchange_by_ids

        parts = [_unspill(p) for p in parts]
        kept = [(p, i) for p, i in zip(parts, ids) if p.num_rows > 0]
        if kept:
            t = self._local([p for p, _ in kept])
            pid = kept[0][1] if len(kept) == 1 else torch.cat([i for _, i in kept])
        else:
            t, pid = parts[0], None
        return _produced([exchange_by_ids(self.mesh, t, pid)])

    def gather(self, parts: Sequence[Table]) -> Table:
        from cudf_tpu_torch.parallel.mesh import gather_table

        return gather_table(self.mesh, self._local(parts))

    def on_one(self, node: IRs.IR, *tables: Table) -> List[Table]:
        from cudf_tpu_torch.engine.streaming import empty_like

        if self.rank != 0 and isinstance(node, IRs.Sink):
            return [empty_like(tables[0])]      # rank 0 alone writes
        out = node.do_evaluate(*tables)
        return [out if self.rank == 0 else empty_like(out)]

    def total(self, x: int) -> int:
        return self.mesh.sum_ints([x])[0]

    def any(self, flags: Sequence[bool]) -> List[bool]:
        return self.mesh.any_flags(flags) if flags else []

    def all_partials(self, partials: list) -> list:
        return [p for rank in self.mesh.all_gather_object(list(partials)) for p in rank]

    def unify(self, column: Sequence[Column]) -> List[Column]:
        """The columns over one sorted dictionary: the union of every rank's
        keys (a dictionary's keys, a STRING column's distinct values), as
        ``unify_dictionaries`` unions one process's."""
        from cudf_tpu_torch.ops import copying
        from cudf_tpu_torch.ops.dictionary import encode, unify_dictionaries
        from cudf_tpu_torch.parallel.mesh import gather_table

        local = encode(copying.concatenate([c.keys if c.dtype.is_dictionary else c
                                            for c in column])).keys
        every = gather_table(self.mesh, Table({"k": local}))["k"]
        return unify_dictionaries([every, *column])[1:]

    def bloom(self, bf):
        bits = bf._bits_on(self.mesh.device)
        self.mesh.all_reduce(bits.view(torch.uint8), "max")
        return bf

    def fallback(self, reason: str) -> None:
        raise Unlowerable(reason)


def evaluate_spmd(node, mesh, axis: str = "x") -> Table:
    """The plan's table over the ranks of ``mesh``, whole on every rank.
    Raises ``Unlowerable`` (on every rank) when a node's work does not
    split over them.  Row order: a sorted plan keeps the global order
    (rank r holds the r-th key range); other plans give each rank's rows in
    rank order, a shuffle's in source-rank order."""
    from cudf_tpu_torch.engine import streaming
    from cudf_tpu_torch.parallel.mesh import gather_table

    if axis not in mesh.shape or len(mesh.shape) != 1:
        raise Unlowerable(f"a plan runs over a 1-D mesh, not {mesh.shape}")
    streaming.LAST_RUN.update(partitions=mesh.size, file_partitions=0)
    parts = [streaming._unspill(p) for p in streaming._eval(node, Ranks(mesh))]
    local = streaming._gather(parts)
    LAST_RUN.update(ranks=mesh.size, files=streaming.LAST_RUN["file_partitions"],
                    rows=local.num_rows)
    return gather_table(mesh, local)
