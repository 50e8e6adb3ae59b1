"""The partitioned executor on one device (port of
``cudf_tpu/engine/streaming.py``; cudf-polars' streaming lowering): a
plan evaluates to a list of tables, one a partition, each on the device
of the plan's sources.

- Sources: an in-memory table is cut into row ranges (views of it); a
  Scan of several files gives one partition a file; a ``PythonScan`` is
  cut like a table.
- Pointwise nodes (Select, HStack, Filter, Projection) map over the
  partitions; one with ``.over()`` windows first repartitions by the keys
  its windows share.  A node whose expressions hold a whole-column
  aggregate (an ``Agg`` outside an ``Over``) is not pointwise: a Select of
  decomposable aggregates alone (sum, count, min, max, mean, var, std)
  and a Reduce take partials a partition and a merge; any other such node
  runs on one partition (counted: ``get_fallback_stats``).
- GroupBy: partial aggregations a partition, a hash shuffle of the
  partials by key, a merge a partition.  ``sum``, ``min``, ``max``,
  ``count`` and ``size`` merge as themselves, ``mean`` as a sum over a
  count, ``var`` and ``std`` as (count, mean, M2, residual) merged by
  Chan's formula (the reference merges (sum, sum of squares, count),
  which cancels).  Other aggregations gather the partitions into one
  (counted).
- Join: the right side broadcast to every left partition when its bytes
  are at most ``executor.broadcast_limit`` (inner, left, semi, anti),
  else both sides shuffled by key hash, each key pair first cast to the
  type the join compares it in, the left side of an inner or semi join
  first filtered by a bloom filter of the right side's keys when that
  side is at most 8x the limit.
- Sort: splitters from a sample of every partition's keys give each row
  a range partition (a run of equal keys never straddles two), the rows
  go to their partitions on the device (``partition_by_ids``), and each
  partition is sorted alone: the concatenation is the stable global
  order.
- Distinct: a local distinct, a shuffle by the subset, a distinct again.
- Union concatenates the partition lists; every other node gathers its
  children into one partition.

A hash shuffle hashes key values, not codes: STRING and dictionary keys
are first put over one dictionary across the partitions (and both sides
of a join), so equal values meet whatever dictionary each partition
read.

Every step that crosses partitions goes through an exchange object:
``OneCard`` here (every partition in this process), ``engine/spmd.py``'s
over the ranks of a ``parallel.Mesh`` (one process a card, collectives in
place of the in-process moves).

With the ``spill`` option every partition the executor produces is
registered with ``utils/spill.py``'s manager and spilled coldest first to
the device budget (``spill.device_limit_bytes``, else
``spill.device_limit_fraction`` of the card's memory; unbounded on the
CPU); a consumer brings a partition back before reading it.

``mesh`` is a partition count (``collect(mesh=8)``), "auto"
(``collect(streaming=True)``: ``choose_partitions``) or a
``parallel.Mesh`` (``engine/spmd.py`` when ``executor.spmd_lowering`` is
on, else this executor over the mesh's size in partitions on every rank).
"""

from __future__ import annotations

import math
import warnings
from typing import List, Optional, Sequence

import torch

from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.core.table import Table
from cudf_tpu_torch.engine import ir as IRs
from cudf_tpu_torch.utils.config import get_option

_POINTWISE = (IRs.Select, IRs.HStack, IRs.Filter, IRs.Projection)
MAX_PARTITIONS = 512

# what the last evaluate_streaming did: its partition count and its
# per-file source partitions
LAST_RUN = {"partitions": 0, "file_partitions": 0}


class PerformanceWarning(UserWarning):
    """A plan node ran on one partition: the executor could not split it."""


class NotDecomposable(NotImplementedError):
    """Raised, under ``executor.fallback_mode = "raise"``, for a node the
    partitioned executor can only run on one partition."""


# ----------------------------------------------------------------------
# fallback accounting (the reference's fallback_mode contract)
# ----------------------------------------------------------------------
_FALLBACK_STATS = {"count": 0, "reasons": {}}


def get_fallback_stats() -> dict:
    """{"count": fallbacks since the last reset, "reasons": {reason: hits}}."""
    return {"count": _FALLBACK_STATS["count"], "reasons": dict(_FALLBACK_STATS["reasons"])}


def reset_fallback_stats() -> None:
    _FALLBACK_STATS["count"] = 0
    _FALLBACK_STATS["reasons"] = {}


def _record_fallback(reason: str, error: Optional[Exception] = None) -> None:
    """Count a fallback; under ``executor.fallback_mode`` "raise" raise
    ``error`` (default: NotDecomposable), under "warn" warn."""
    _FALLBACK_STATS["count"] += 1
    _FALLBACK_STATS["reasons"][reason] = _FALLBACK_STATS["reasons"].get(reason, 0) + 1
    mode = get_option("executor.fallback_mode")
    if mode == "raise":
        raise error if error is not None else NotDecomposable(reason)
    if mode == "warn":
        warnings.warn(f"the partitioned executor runs this node on one partition: {reason}",
                      PerformanceWarning, stacklevel=4)


# ----------------------------------------------------------------------
# spilling: produced partitions spill coldest first to the device budget;
# a consumer brings one back before it reads it
# ----------------------------------------------------------------------

def _spill_budget(device) -> int:
    explicit = int(get_option("spill.device_limit_bytes") or 0)
    if explicit:
        return explicit
    if device is not None and torch.device(device).type == "cuda":
        total = torch.cuda.get_device_properties(torch.device(device)).total_memory
        return int(total * float(get_option("spill.device_limit_fraction")))
    return 1 << 62


def _auto_spill(t: Table) -> Table:
    if get_option("spill") and t.num_columns:
        from cudf_tpu_torch.utils.spill import get_spill_manager

        mgr = get_spill_manager()
        for c in t.columns:
            mgr.register(c)
        mgr.spill_to_budget(_spill_budget(t.device))
    return t


def _unspill(t: Table) -> Table:
    from cudf_tpu_torch.utils.spill import get_spill_manager, is_spilled

    spilled = [c for c in t.columns if is_spilled(c)]
    if spilled:
        mgr = get_spill_manager()
        for c in spilled:
            mgr.ensure_on_device(c)
    return t


def _produced(parts: List[Table]) -> List[Table]:
    return [_auto_spill(p) for p in parts]


# ----------------------------------------------------------------------
# partition count
# ----------------------------------------------------------------------

def estimate_source_bytes(node: IRs.IR) -> int:
    """The plan's source bytes: in-memory tables by ``nbytes``, file scans
    by their size on disk (16 MiB for a file that cannot be read)."""
    import os

    if isinstance(node, IRs.DataFrameScan):
        return node.do_evaluate().nbytes
    if isinstance(node, IRs.Scan):
        total = 0
        for p in node.paths:
            try:
                total += os.path.getsize(p)
            except OSError:
                total += 1 << 24
        return total
    return sum(estimate_source_bytes(c) for c in node.children)


def choose_partitions(node: IRs.IR) -> int:
    """The partition count that keeps each partition's share of the
    sources under ``executor.target_partition_size`` (1 to 512)."""
    budget = int(get_option("executor.target_partition_size"))
    est = estimate_source_bytes(node)
    return max(1, min(-(-est // max(budget, 1)), MAX_PARTITIONS))


def is_mesh(mesh) -> bool:
    """Whether ``mesh`` is a ``parallel.Mesh`` (ranks of a process group)."""
    from cudf_tpu_torch.parallel.mesh import Mesh

    return isinstance(mesh, Mesh)


def partition_count(mesh) -> Optional[int]:
    """``mesh`` as a partition count: None for "auto", a Mesh's size for a
    Mesh; any other value that is not an int raises TypeError."""
    if mesh is None or (isinstance(mesh, str) and mesh == "auto"):
        return None
    if is_mesh(mesh):
        return mesh.size
    if isinstance(mesh, bool) or not isinstance(mesh, int):
        raise TypeError(f"mesh is a partition count, \"auto\" or a parallel.Mesh, not "
                        f"{mesh!r}")
    if mesh < 1:
        raise ValueError(f"a partition count is at least 1, not {mesh}")
    return mesh


def evaluate_streaming(node: IRs.IR, mesh_or_nparts=None) -> Table:
    """The plan's table through the partitioned executor, over a partition
    count ("auto" or None: chosen from the plan's size); over a
    ``parallel.Mesh`` through ``engine/spmd.py`` (with
    ``executor.spmd_lowering``; a plan it cannot lower is counted and runs
    here, over the mesh's size in partitions, on every rank)."""
    from cudf_tpu_torch.ops.copying import concatenate_tables

    n = partition_count(mesh_or_nparts)
    quiet = False
    if is_mesh(mesh_or_nparts) and get_option("executor.spmd_lowering"):
        from cudf_tpu_torch.engine.spmd import Unlowerable, evaluate_spmd

        try:
            return evaluate_spmd(node, mesh_or_nparts)
        except Unlowerable as exc:
            _record_fallback(str(exc), exc)
            quiet = True            # counted once, here
    if n is None:
        n = choose_partitions(node)
    LAST_RUN.update(partitions=n, file_partitions=0)
    parts = [_unspill(p) for p in _eval(node, OneCard(n, quiet=quiet))]
    parts = [p for p in parts if p.num_rows > 0] or parts[:1]
    out = parts[0] if len(parts) == 1 else concatenate_tables(parts)
    if get_option("spill"):
        # the result is the caller's: no later spill may reach it
        from cudf_tpu_torch.utils.spill import get_spill_manager

        mgr = get_spill_manager()
        for c in (c for p in parts for c in p.columns):
            mgr.unregister(c)
    return out


# ----------------------------------------------------------------------
# the exchanges of one process
# ----------------------------------------------------------------------

class OneCard:
    """Every step of the executor that crosses partitions, for ``n``
    partitions held in this process.  ``engine/spmd.py``'s ``Ranks`` has
    the same methods over the ranks of a mesh.  ``quiet`` counts no
    fallback (a plan already counted when it fell back here)."""

    def __init__(self, n: int, quiet: bool = False):
        self.n = int(n)
        self.quiet = quiet

    def source(self, t: Table) -> List[Table]:
        """An in-memory source's partitions."""
        return _partition_table(t, self.n)

    def files(self, paths: Sequence[str]) -> List[str]:
        """The files of a scan of several files read here (one a partition)."""
        return list(paths)

    def route(self, parts: Sequence[Table], ids: Sequence[torch.Tensor]) -> List[Table]:
        """Each row of ``parts[i]`` to partition ``ids[i][row]`` (int32):
        the ``n`` partitions, each row of one in its source's order."""
        return _assemble(_shuffle(parts, ids, self.n), parts[0])

    def gather(self, parts: Sequence[Table]) -> Table:
        """The partitions as one table."""
        return _gather(parts)

    def on_one(self, node: IRs.IR, *tables: Table) -> List[Table]:
        """``node`` over whole tables: one partition."""
        return [node.do_evaluate(*tables)]

    def total(self, x: int) -> int:
        """``x`` summed over every holder of partitions (here: itself)."""
        return int(x)

    def any(self, flags: Sequence[bool]) -> List[bool]:
        """Each flag or-ed over every holder of partitions."""
        return [bool(f) for f in flags]

    def all_partials(self, partials: list) -> list:
        """Every partition's host partials, in partition order."""
        return list(partials)

    def unify(self, column: Sequence[Column]) -> List[Column]:
        """STRING or dictionary columns over one sorted dictionary of every
        value they hold."""
        from cudf_tpu_torch.ops.dictionary import unify_dictionaries

        if all(c.dtype.is_dictionary and c.keys is column[0].keys for c in column):
            return list(column)
        return unify_dictionaries(column)

    def bloom(self, bf):
        """The bloom filter of every holder's right-side keys."""
        return bf

    def fallback(self, reason: str) -> None:
        """A node runs on one partition: counted (``get_fallback_stats``)."""
        if not self.quiet:
            _record_fallback(reason)


# ----------------------------------------------------------------------
# the partition-list evaluation
# ----------------------------------------------------------------------

def _partition_table(t: Table, n: int) -> List[Table]:
    """Row ranges of the table (views of its columns; STRING rows copied)."""
    from cudf_tpu_torch.ops import copying

    rows = t.num_rows
    per = -(-rows // n) if rows else 0
    return [Table.from_pairs(t.names, [copying.slice(c, i * per, min((i + 1) * per, rows))
                                       for c in t.columns]) for i in range(n)]


def empty_like(t: Table) -> Table:
    """No rows of ``t``'s columns."""
    from cudf_tpu_torch.ops import copying

    return Table.from_pairs(t.names, [copying.slice(c, 0, 0) for c in t.columns])


def _gather(parts: List[Table]) -> Table:
    """The partitions as one table (every partition brought back)."""
    from cudf_tpu_torch.ops.copying import concatenate_tables

    parts = [_unspill(p) for p in parts]
    nonempty = [p for p in parts if p.num_rows > 0] or parts[:1]
    return nonempty[0] if len(nonempty) == 1 else concatenate_tables(nonempty)


class Partitions(IRs.IR):
    """A source of partitions already in place (this holder's): what
    ``parallel/dist.py`` gives the executor of a rank's own rows."""

    def __init__(self, parts: Sequence[Table]):
        self.children = ()
        self.parts = list(parts)

    def schema(self):
        return list(self.parts[0].names)

    def do_evaluate(self) -> Table:
        return _gather(self.parts)


def _eval(node: IRs.IR, ex) -> List[Table]:
    """The node's partitions (``ex``: an exchange object, or a partition
    count for ``OneCard``)."""
    if isinstance(ex, int):
        ex = OneCard(ex)
    if isinstance(node, Partitions):
        return list(node.parts)
    if isinstance(node, (IRs.DataFrameScan, IRs.PythonScan)):
        return ex.source(node.do_evaluate())
    if isinstance(node, IRs.Scan):
        if len(node.paths) > 1:
            mine = ex.files(node.paths)
            LAST_RUN["file_partitions"] += len(mine)
            if not mine:        # a rank with no file of its own: no rows of the schema
                return [empty_like(IRs.Scan(node.fmt, node.paths[:1], node.projection,
                                            node.predicate, device=node.device).do_evaluate())]
            return _produced([
                IRs.Scan(node.fmt, [p], node.projection, node.predicate,
                         device=node.device).do_evaluate() for p in mine])
        return _produced(ex.source(node.do_evaluate()))
    if isinstance(node, (IRs.Select, IRs.Reduce)) and _whole_column_aggs(node):
        return _eval_aggregates(node, ex)
    if isinstance(node, _POINTWISE):
        parts = _eval(node.children[0], ex)
        if _whole_column_aggs(node):
            ex.fallback(f"{type(node).__name__}: a whole-column aggregate compares rows "
                        "with every partition's")
            return ex.on_one(node, ex.gather(parts))
        okeys = _over_keys(node)
        if okeys == []:
            return _produced(ex.on_one(node, ex.gather(parts)))
        if okeys:
            parts = _repartition_by_hash(parts, okeys, ex)
        out = []
        for i in range(len(parts)):
            p, parts[i] = parts[i], None          # release each input as it is read
            out.append(_auto_spill(node.do_evaluate(_unspill(p))))
        return out
    if isinstance(node, IRs.Union):
        return [p for c in node.children for p in _eval(c, ex)]
    if isinstance(node, IRs.GroupBy):
        return _eval_groupby(node, ex)
    if isinstance(node, IRs.Join) and node.how != "cross":
        return _eval_join(node, ex)
    if isinstance(node, IRs.Sort):
        return _eval_sort(node, ex)
    if isinstance(node, IRs.Distinct):
        return _eval_distinct(node, ex)
    # every other node: its children gathered, evaluated on one partition
    # (brought back last: evaluating one child may spill another's table)
    tables = [ex.gather(_eval(c, ex)) for c in node.children]
    return ex.on_one(node, *[_unspill(t) for t in tables])


def _over_keys(node) -> Optional[List[str]]:
    """The keys every ``.over()`` of a pointwise node's expressions shares
    (None: no window expression).  Rows equal on them share a partition,
    so each window's rows do; with no shared key the node runs on one
    partition.  (The reference repartitions by the union of the keys,
    which splits the windows of the shorter key lists.)"""
    from cudf_tpu_torch.engine.expr import Over

    key_lists: List[List[str]] = []

    def walk(e):
        if isinstance(e, Over):
            key_lists.append(list(e.keys))
        for c in getattr(e, "children", ()):
            walk(c)

    for e in _node_exprs(node):
        walk(e)
    if not key_lists:
        return None
    return [k for k in key_lists[0] if all(k in ks for ks in key_lists[1:])]


def _node_exprs(node) -> list:
    exprs = list(getattr(node, "exprs", ()) or getattr(node, "aggs", ()))
    if getattr(node, "predicate", None) is not None and not isinstance(node, IRs.Scan):
        exprs.append(node.predicate)
    return exprs


def _holds_agg(e) -> bool:
    """Whether the expression holds an ``Agg`` outside an ``Over`` (a
    reduction of the whole input, which a partition alone cannot give)."""
    from cudf_tpu_torch.engine.expr import Agg, Over

    if isinstance(e, Over):
        return False
    if isinstance(e, Agg):
        return True
    return any(_holds_agg(c) for c in getattr(e, "children", ()))


def _whole_column_aggs(node) -> bool:
    return any(_holds_agg(e) for e in _node_exprs(node))


# ----------------------------------------------------------------------
# whole-column aggregates: partials a partition, merged
# ----------------------------------------------------------------------

_WHOLE = ("sum", "count", "min", "max", "mean", "var", "std")


def _reduce_specs(node):
    """(name, inner expr, kind) of each expression of a Select or Reduce
    made of decomposable aggregates alone, or the reason it is not."""
    from cudf_tpu_torch.engine.expr import Alias, Agg

    specs = []
    for e in _node_exprs(node):
        name, a = e.output_name, e
        while isinstance(a, Alias):
            a = a.children[0]
        if not isinstance(a, Agg):
            return f"{type(node).__name__}: {e!r} is not an aggregate alone"
        if a.agg not in _WHOLE:
            return f"{type(node).__name__}: agg {a.agg} is not decomposable"
        if _holds_agg(a.children[0]):
            return f"{type(node).__name__}: {e!r} nests an aggregate"
        specs.append((name, a.children[0], a.agg))
    return specs


def _partial_of(col: Column, kind: str):
    """One partition's host partial of a whole-column ``kind``."""
    from cudf_tpu_torch.ops import reductions

    if kind in ("sum", "count", "min", "max"):
        return getattr(reductions, kind)(col)
    n = reductions.count(col)
    if kind == "mean":
        if col.data.dtype == torch.uint64:      # as reductions.mean: float sums
            return float(reductions._accumulated(col, 0, as_float=True)[0].sum()), n
        return reductions.sum(col), n
    # var, std: (count, mean, M2, residual) about the rounded mean
    x, v = reductions._accumulated(col, 0, as_float=True)
    mean = float(x.sum()) / n if n else 0.0
    d = x - mean
    if v is not None:
        d = torch.where(v, d, 0.0)
    m2, r = torch.stack([(d * d).sum(), d.sum()]).tolist()
    return float(n), mean, m2, r


def _merge_partials(parts: list, kind: str):
    """The whole-column value from every partition's partials (the
    in-memory reduction's value, floats up to summation order)."""
    if kind in ("sum", "count"):
        return sum(parts)
    if kind in ("min", "max"):
        kept = [p for p in parts if p is not None]
        if not kept:
            return None
        return min(kept) if kind == "min" else max(kept)
    if kind == "mean":
        n = sum(c for _, c in parts)
        return float(sum(s for s, _ in parts)) / n if n else float("nan")
    return _chan_scalar(parts, kind)


def _chan_scalar(parts: list, kind: str) -> float:
    """var or std (ddof 1) from (n_i, m_i, M2_i, r_i) by Chan's merge."""
    n = sum(p[0] for p in parts)
    if n - 1 <= 0:
        return float("nan")
    mean = sum(p[0] * p[1] for p in parts) / n
    m2 = 0.0
    for ni, mi, m2i, ri in parts:
        if ni > 0:
            d = mi - mean
            m2 += m2i + 2.0 * d * ri + ni * d * d
    var = m2 / (n - 1)
    return float(math.sqrt(var)) if kind == "std" else float(var)


def _eval_aggregates(node, ex) -> List[Table]:
    """A Select of aggregates alone, or a Reduce: each partition's host
    partials, every partition's gathered (``ex.all_partials``), merged into
    the one-row table the in-memory executor gives.  Aggregates that do
    not decompose run on one partition (a counted fallback)."""
    from cudf_tpu_torch.engine.expr import Agg

    parts = _eval(node.children[0], ex)
    specs = _reduce_specs(node)
    if isinstance(specs, str):
        ex.fallback(specs)
        return ex.on_one(node, ex.gather(parts))
    sample = _unspill(next((p for p in parts if p.num_rows > 0), parts[0]))
    local = []
    for p in parts:
        if p.num_rows:
            p = _unspill(p)
            local.append([_partial_of(inner.evaluate(p), kind) for _, inner, kind in specs])
    every = ex.all_partials(local)
    device = sample.device if sample.device is not None else "cpu"
    cols = []
    for j, (name, inner, kind) in enumerate(specs):
        if not every:           # no rows anywhere: the reduction of nothing
            cols.append(Agg(inner, kind).evaluate(sample))
            continue
        cols.append(Column.full(1, _merge_partials([ps[j] for ps in every], kind),
                                device=device))
    return ex.on_one(_Constant([n for n, _, _ in specs], cols))


class _Constant(IRs.IR):
    """A computed one-row table as a node (``on_one`` evaluates nodes)."""

    def __init__(self, names, cols):
        self.children = ()
        self.names, self.cols = list(names), list(cols)

    def schema(self):
        return list(self.names)

    def do_evaluate(self) -> Table:
        return Table.from_pairs(self.names, self.cols)


# ----------------------------------------------------------------------
# hash shuffle
# ----------------------------------------------------------------------

def _join_key_types(lk, rk):
    """Each pair of join key columns in the type the join compares them
    in (``ops/join._align_pair``): a pair of different numeric or temporal
    types is cast to their common type, so equal keys hash alike (an int32
    key and a float64 key of equal values; the reference hashes each in
    its own type).  STRING and dictionary keys are left to ``_hash_keys``."""
    from cudf_tpu_torch.core import dtypes as dt
    from cudf_tpu_torch.ops.unary import cast

    sample_l = next((c for c in lk if c), None)
    sample_r = next((c for c in rk if c), None)
    if sample_l is None or sample_r is None:
        return lk, rk
    for j, (a, b) in enumerate(zip(sample_l, sample_r)):
        if a.dtype == b.dtype or any(c.dtype.is_string or c.dtype.is_dictionary
                                     for c in (a, b)):
            continue
        target = dt.common_dtype(a.dtype, b.dtype)
        for side in (lk, rk):
            for kc in side:
                if kc[j].dtype != target:
                    kc[j] = cast(kc[j], target)
    return lk, rk


def _hash_keys(sides: Sequence[Sequence[Table]], keys: Sequence[Sequence[str]], ex):
    """Each side's partitions' key columns, ready to hash alike: a STRING or
    dictionary key is put over one dictionary across every partition of
    every side (``ex.unify``: one sort of the partitions' distinct
    values), and every key loses its mask (``_unmasked``)."""
    cols = [[[p[k] for k in ks] for p in parts] for parts, ks in zip(sides, keys)]
    for j in range(len(keys[0])):
        column = [c[j] for side in cols for c in side]
        if not any(c.dtype.is_string or c.dtype.is_dictionary for c in column):
            continue
        unified = iter(ex.unify(column))
        for side in cols:
            for c in side:
                c[j] = next(unified)
    return [[[_unmasked(c) for c in kc] for kc in side] for side in cols]


def _unmasked(c: Column) -> Column:
    """The key without its mask, null rows zeroed: a row's hash then does
    not depend on whether its partition's column has a mask, and null
    rows meet in one partition.  Always a column of its own: a spill of
    the partition's column while the shuffle runs leaves it readable."""
    if c.data is None or (c.children and not c.dtype.is_dictionary):
        return c
    data = c.data if c.validity is None else \
        torch.where(c.validity, c.data, torch.zeros_like(c.data))
    return Column(c.dtype, c.length, data, None, c.offsets, c.children)


def _hash_ids(key_cols, n: int) -> List[torch.Tensor]:
    """Each partition's rows' destinations: row_hash of the keys mod n."""
    from cudf_tpu_torch.ops.partitioning import partition_ids

    return [partition_ids(kc, n) if kc and kc[0].length else None for kc in key_cols]


def _shuffle(parts: Sequence[Table], ids, n: int) -> List[List[Table]]:
    """Each partition's rows, ordered by their destination ids, cut into n
    buckets: buckets[i] holds the pieces bound for partition i."""
    from cudf_tpu_torch.ops import copying
    from cudf_tpu_torch.ops.partitioning import partition_by_ids

    buckets: List[List[Table]] = [[] for _ in range(n)]
    for p, pid in zip(parts, ids):
        if p.num_rows == 0:
            continue
        reordered, offsets = partition_by_ids(_unspill(p), pid, n)
        offs = offsets.tolist()
        for i in range(n):
            if offs[i + 1] > offs[i]:
                buckets[i].append(Table.from_pairs(
                    reordered.names,
                    [copying.slice(c, offs[i], offs[i + 1]) for c in reordered.columns]))
    return buckets


def _assemble(buckets: List[List[Table]], like: Table) -> List[Table]:
    from cudf_tpu_torch.ops import copying

    like = _unspill(like)
    out = []
    for pieces in buckets:
        if not pieces:
            out.append(empty_like(like))
        else:
            out.append(pieces[0] if len(pieces) == 1 else copying.concatenate_tables(pieces))
    return _produced(out)


def _repartition_by_hash(parts: List[Table], keys: List[str], ex) -> List[Table]:
    """The rows reshuffled so equal keys share a partition (the Shuffle
    node, streaming/shuffle.py)."""
    parts = [_unspill(p) for p in parts]
    (key_cols,) = _hash_keys([parts], [keys], ex)
    return ex.route(parts, _hash_ids(key_cols, ex.n))


# ----------------------------------------------------------------------
# groupby: partials, shuffle, merge
# ----------------------------------------------------------------------

_DIRECT = {"sum": "sum", "count": "sum", "min": "min", "max": "max", "size": "sum"}
_NUMERIC_ONLY = ("sum", "mean", "var", "std")
_MOMENTS = ("n", "mean", "m2", "r")


def _decompose(node: IRs.GroupBy, sample: Table):
    """(kernel partials, moment partials, finals) of the node's
    aggregations, or the reason they cannot be split.  Kernel partials are
    (name, inner expr, agg), which the kernel tiers may serve; moment
    partials (name, inner expr) give var and std their (count, mean, M2,
    residual); finals are (out name, how, partial names, out dtype)."""
    from cudf_tpu_torch.core import dtypes as dt

    kernel, moments, finals = [], [], []
    for name, inner, kind in (IRs.unwrap_agg(a) for a in node.aggs):
        if kind not in _DIRECT and kind not in ("mean", "var", "std"):
            return f"GroupBy: {kind} is not decomposable"
        kd = inner.evaluate(sample).dtype
        if kind in ("min", "max") and (kd.is_dictionary or kd.is_nested or kd.is_decimal):
            return f"GroupBy: {kind} of {kd!r} is not decomposable"
        if kind in _NUMERIC_ONLY and not (kd.is_numeric or kd.is_bool):
            return f"GroupBy: {kind} of {kd!r} is not decomposable"
        out = dt.FLOAT32 if kd == dt.FLOAT32 else dt.FLOAT64
        if kind in _DIRECT:
            kernel.append((name, inner, kind))
            finals.append((name, "direct", [name], kd))
        elif kind == "mean":
            kernel += [(f"__{name}_sum", inner, "sum"), (f"__{name}_cnt", inner, "count")]
            finals.append((name, "mean", [f"__{name}_sum", f"__{name}_cnt"], out))
        else:
            moments.append((name, inner))
            finals.append((name, kind, [f"__{name}_{m}" for m in _MOMENTS], out))
    return kernel, moments, finals


def _partial(node: IRs.GroupBy, p: Table, kernel, moments) -> Table:
    """One partition's partial aggregations: the kernel-tier requests in
    one call, the moments over one sort-tier grouper; both give their
    groups in ascending key order."""
    from cudf_tpu_torch.core import dtypes as dt
    from cudf_tpu_torch.ops import groupby as gb

    keys = p.select(node.keys)
    cols = {}
    if kernel:
        k, a = gb.groupby_agg(keys, [(pn, ie.evaluate(p), pa) for pn, ie, pa in kernel])
        cols.update(k.items())
        cols.update(a.items())
    if moments:
        grouper = gb.make_grouper(list(keys.columns))
        if not kernel:
            cols.update(gb.group_keys_table(keys, grouper).items())
        elif grouper.num_groups != k.num_rows:
            raise RuntimeError(f"the kernel tier gave {k.num_rows} groups, the sort tier "
                               f"{grouper.num_groups}")
        g = grouper.num_groups
        for name, inner in moments:
            for m, t in zip(_MOMENTS, gb.group_moments(inner.evaluate(p), grouper)):
                cols[f"__{name}_{m}"] = Column(dt.FLOAT64, g, t)
    return Table(cols)


def _decoded_keys(partials: List[Table], keys: Sequence[str], ex) -> List[Table]:
    """The partials with one layout a key column: a dictionary key is
    decoded when another partial holds it decoded, here or on another
    holder (the kernel tiers give a dictionary key's values, the sort tier
    the dictionary)."""
    flags = ex.any([f for k in keys for f in (
        any(p[k].dtype.is_dictionary for p in partials),
        any(not p[k].dtype.is_dictionary for p in partials))])
    for i, k in enumerate(keys):
        if flags[2 * i] and flags[2 * i + 1]:
            partials = [p.insert(k, p[k].decode_dictionary()) for p in partials]
    return partials


def _merge(node: IRs.GroupBy, t: Table, kernel, finals) -> Table:
    """The shuffled partials of one partition merged into its groups."""
    from cudf_tpu_torch.ops import groupby as gb

    grouper = None
    if not any(how in ("var", "std") for _, how, _, _ in finals):
        k, a = gb.groupby_agg(t.select(node.keys),
                              [(pn, t[pn], _DIRECT[pa]) for pn, _, pa in kernel])
        merged = dict(a.items())
        cols = dict(k.items())
    else:
        grouper = gb.make_grouper([t[k] for k in node.keys])
        cols = dict(gb.group_keys_table(t.select(node.keys), grouper).items())
        merged = {pn: gb.aggregate(t[pn], grouper, _DIRECT[pa]) for pn, _, pa in kernel}
    for name, how, pnames, kd in finals:
        if how == "direct":
            cols[name] = merged[pnames[0]]
        elif how == "mean":
            s, c = merged[pnames[0]], merged[pnames[1]]
            valid = c.data > 0
            mean = torch.where(valid, s.data.double() / c.data.double().clamp(min=1), 0.0)
            cols[name] = Column(kd, mean.shape[0], mean.to(kd.torch_storage),
                                None if bool(valid.all()) else valid)
        else:
            cols[name] = _chan([t[p].data for p in pnames], grouper, how, kd)
    return Table(cols)


def _chan(moments, grouper, how: str, kd) -> Column:
    """var or std of each group from its partials' (n_i, m_i, M2_i, r_i):
    with mean = sum n_i m_i / n and d_i = m_i - mean,
    M2 = sum (M2_i + 2 d_i r_i + n_i d_i^2) (Chan, Golub and LeVeque's merge;
    the r_i term takes out each m_i's rounding), then M2 / (n - 1)."""
    n_i, m_i, m2_i, r_i = moments
    gid, g = grouper.group_ids, grouper.num_groups
    if grouper.kept_rows is not None:
        n_i, m_i, m2_i, r_i = (x[grouper.kept_rows] for x in moments)
    n = torch.zeros(g, dtype=torch.float64, device=n_i.device).index_add_(0, gid, n_i)
    mean = torch.zeros_like(n).index_add_(0, gid, n_i * m_i) / n.clamp(min=1)
    d = torch.where(n_i > 0, m_i - mean[gid], 0.0)
    m2 = torch.zeros_like(n).index_add_(0, gid, m2_i + 2.0 * d * r_i + n_i * d * d)
    valid = n > 1
    var = torch.where(valid, m2 / (n - 1).clamp(min=1), float("nan"))
    out = torch.sqrt(var) if how == "std" else var
    return Column(kd, g, out.to(kd.torch_storage), valid)


def _eval_groupby(node: IRs.GroupBy, ex) -> List[Table]:
    parts = _eval(node.children[0], ex)
    sample = next((p for p in parts if p.num_rows > 0), parts[0])
    plan = _decompose(node, _unspill(sample))
    if isinstance(plan, str):
        ex.fallback(plan)
        return ex.on_one(node, ex.gather(parts))
    kernel, moments, finals = plan
    partials = []
    for i in range(len(parts)):
        p, parts[i] = parts[i], None
        if p.num_rows:
            partials.append(_auto_spill(_partial(node, _unspill(p), kernel, moments)))
    if ex.total(len(partials)) == 0:
        return [node.do_evaluate(_unspill(sample))]
    if not partials:            # rows elsewhere, none here: no groups of this holder's
        partials = [_partial(node, _unspill(sample), kernel, moments)]
    partials = _decoded_keys([_unspill(p) for p in partials], node.keys, ex)
    shuffled = _repartition_by_hash(partials, node.keys, ex)
    # a holder no key went to keeps no rows, in the merge's layout
    return _produced([_merge(node, _unspill(t), kernel, finals) for t in shuffled
                      if t.num_rows > 0] or [_merge(node, _unspill(shuffled[0]), kernel, finals)])


# ----------------------------------------------------------------------
# join: broadcast, or a (bloom-filtered) shuffle
# ----------------------------------------------------------------------

def _bloom_bits(rows: int) -> int:
    """Bits for a filter over ``rows`` keys: about ten a key, a power of
    two from 2^22 to 2^30."""
    return 1 << min(30, max(22, math.ceil(math.log2(max(rows, 1) * 10))))


def _eval_join(node: IRs.Join, ex) -> List[Table]:
    left_parts = _eval(node.children[0], ex)
    right_parts = _eval(node.children[1], ex)
    right_bytes = ex.total(sum(p.nbytes for p in right_parts))
    limit = int(get_option("executor.broadcast_limit"))
    if right_bytes <= limit and node.how in ("inner", "left", "semi", "anti"):
        right_all = ex.gather(right_parts)
        out = []
        for i in range(len(left_parts)):
            p, left_parts[i] = left_parts[i], None
            out.append(_auto_spill(node.do_evaluate(_unspill(p), _unspill(right_all))))
        return out
    left_parts = [_unspill(p) for p in left_parts]
    right_parts = [_unspill(p) for p in right_parts]
    lk, rk = _hash_keys([left_parts, right_parts], [node.left_on, node.right_on], ex)
    lk, rk = _join_key_types(lk, rk)
    if node.how in ("inner", "semi") and right_bytes <= 8 * limit and _bloom_keys(lk, rk):
        left_parts, lk = _bloom_filter(left_parts, lk, right_parts, rk, ex)
    ls = ex.route(left_parts, _hash_ids(lk, ex.n))
    del left_parts, lk
    rs = ex.route(right_parts, _hash_ids(rk, ex.n))
    del right_parts, rk
    out = []
    for i in range(len(ls)):
        lt, rt = _unspill(ls[i]), _unspill(rs[i])
        ls[i] = rs[i] = None
        out.append(_auto_spill(node.do_evaluate(lt, rt)))
    return out


def _bloom_keys(lk, rk) -> bool:
    """Whether both sides' keys hash alike in the bloom filter: integer
    columns of one dtype a key (murmur3 hashes a value's bytes)."""
    sample_l = next((c for c in lk if c), None)
    sample_r = next((c for c in rk if c), None)
    if sample_l is None or sample_r is None:
        return False
    return all(a.dtype == b.dtype and a.dtype.is_integer for a, b in zip(sample_l, sample_r))


def _bloom_filter(left_parts, lk, right_parts, rk, ex):
    """The left partitions without the rows whose keys the right side's
    bloom filter rules out (the runtime join filter: fewer rows shuffled)."""
    from cudf_tpu_torch.ops import copying
    from cudf_tpu_torch.ops.bloom import BloomFilter
    from cudf_tpu_torch.ops.stream_compaction import filter_indices

    rows = ex.total(sum(p.num_rows for p in right_parts))
    bf = BloomFilter(num_bits=_bloom_bits(rows))
    for p, kc in zip(right_parts, rk):
        if p.num_rows:
            bf.add(kc)
    bf = ex.bloom(bf)
    parts, keys = [], []
    for p, kc in zip(left_parts, lk):
        if p.num_rows == 0:
            parts.append(p)
            keys.append(kc)
            continue
        keep = filter_indices(bf.maybe_contains(kc))
        parts.append(copying.gather_table(p, keep, bounds_check=False))
        keys.append([copying.gather(c, keep, bounds_check=False) for c in kc])
    return parts, keys


# ----------------------------------------------------------------------
# sort: range partitions by the keys' global order; distinct
# ----------------------------------------------------------------------

SORT_SAMPLES = 64      # sampled rows a range partition, for the splitters


def _eval_sort(node: IRs.Sort, ex) -> List[Table]:
    """Range partitions from splitters: evenly spaced rows of every
    partition's keys (``SORT_SAMPLES`` a range partition in all) are
    gathered, sorted and cut into n quantiles; a row goes to the count of
    splitters below it, so a run of equal keys stays in one range
    partition.  The rows go there on the device (``partition_by_ids``,
    ``ex.route``) and each range partition is sorted alone: the
    concatenation is the stable global order.  The keys of two partitions
    are never held together."""
    from cudf_tpu_torch.ops import copying, row_ops
    from cudf_tpu_torch.ops.join import _lex_searchsorted

    n = ex.n
    every = _eval(node.children[0], ex)
    parts = [_unspill(p) for p in every if p.num_rows > 0]
    total = ex.total(sum(p.num_rows for p in parts))
    if n == 1 or total == 0:
        return ex.on_one(node, ex.gather(every))
    ascending = [not d for d in node.descending]
    na = "last" if node.nulls_last else "first"
    samples = []
    for p in parts:
        k = min(p.num_rows, -(-SORT_SAMPLES * n * p.num_rows // total))
        at = torch.arange(k, device=p[node.by[0]].device) * p.num_rows // k
        samples.append(Table.from_pairs(
            node.by, [copying.gather(p[b], at, bounds_check=False) for b in node.by]))
    if not samples:             # no rows here: the keys' schema, no rows
        samples = [empty_like(_unspill(every[0]).select(node.by))]
    sample = ex.gather(samples)
    order = row_ops.lex_sort_indices(list(sample.columns), ascending, na)
    m = order.shape[0]
    cut = order[torch.arange(1, n, device=order.device) * m // n]
    splitters = [copying.gather(c, cut, bounds_check=False) for c in sample.columns]
    del samples, sample, order
    parts = parts or [_unspill(every[0])]
    ids = []
    for p in parts:
        # splitters and rows compared over one encoding (one dictionary,
        # one string width)
        keys = [copying.concatenate([s, p[b]]) for s, b in zip(splitters, node.by)]
        ops = row_ops.sort_operands(keys, ascending, na)
        ids.append(_lex_searchsorted([o[:n - 1] for o in ops], [o[n - 1:] for o in ops],
                                     "left").to(torch.int32))
        del keys, ops
    ranged = ex.route(parts, ids)
    del parts, ids
    out = []
    for i in range(len(ranged)):
        t, ranged[i] = ranged[i], None
        if t.num_rows:
            out.append(_auto_spill(node.do_evaluate(_unspill(t))))
    return out or [empty_like(_unspill(every[0]))]


def _eval_distinct(node: IRs.Distinct, ex) -> List[Table]:
    """A local distinct, a shuffle by the subset, a distinct again.  With
    keep="none" the rows are shuffled first: a local pass would drop a
    duplicate pair in one partition and keep its third copy in another."""
    parts = [_unspill(p) for p in _eval(node.children[0], ex)]
    keys = node.subset or list(parts[0].names)
    local = parts if node.keep == "none" else [node.do_evaluate(p) for p in parts]
    shuffled = _repartition_by_hash(local, list(keys), ex)
    return _produced([node.do_evaluate(_unspill(p)) for p in shuffled])
