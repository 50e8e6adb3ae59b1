"""Logical IR nodes and the in-memory executor (port of
``cudf_tpu/engine/ir.py``).

Every node has ``do_evaluate`` over its children's tables and a cached
``evaluate`` (a node shared by two parents runs once).  The executor is
the in-memory one: every table lives on the device of its source
frames, and every node runs there through the ``ops`` layer.

``Scan`` reads Parquet or CSV files onto its device with the projection
and the simple conjuncts of its predicate pushed into the reader (row
groups and pages pruned by the file's metadata), then applies the whole
predicate; ``Sink`` writes its child's table to a file.  ``Rolling`` is a
trailing window of rows over a sorted table (``frame/window.py``).
``MapFunction`` and ``PythonScan`` are the engine's escape hatches: a
Python function over a table, and a Python callable as a source.
``engine/streaming.py`` runs the same nodes over a list of partitions.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.core.table import Table
from cudf_tpu_torch.engine.expr import Agg, Alias, Expr


class IR:
    children: Tuple["IR", ...] = ()

    def schema(self) -> List[str]:
        raise NotImplementedError

    def do_evaluate(self, *child_tables: Table) -> Table:
        raise NotImplementedError

    def evaluate(self, cache: Optional[Dict[int, Table]] = None) -> Table:
        cache = cache if cache is not None else {}
        key = id(self)
        if key in cache:
            return cache[key]
        out = self.do_evaluate(*[c.evaluate(cache) for c in self.children])
        cache[key] = out
        return out

    def explain(self, depth: int = 0) -> str:
        lines = [f"{'  ' * depth}{self.__class__.__name__}{self._explain_args()}"]
        lines.extend(c.explain(depth + 1) for c in self.children)
        return "\n".join(lines)

    def _explain_args(self) -> str:
        return ""


class DataFrameScan(IR):
    """In-memory table source."""

    def __init__(self, table: Table, projection: Optional[Sequence[str]] = None):
        self.table = table
        self.projection = list(projection) if projection is not None else None

    def schema(self):
        return self.projection or list(self.table.names)

    def do_evaluate(self) -> Table:
        return self.table.select(self.projection) if self.projection else self.table

    def _explain_args(self):
        return f"(cols={self.schema()})"


class Scan(IR):
    """File source with projection and predicate pushdown."""

    def __init__(self, fmt: str, paths: Sequence[str], projection: Optional[Sequence[str]] = None,
                 predicate: Optional[Expr] = None, *, device):
        self.fmt = fmt
        self.paths = list(paths)
        self.projection = list(projection) if projection is not None else None
        self.predicate = predicate
        self.device = device

    def schema(self):
        if self.projection:
            return list(self.projection)
        return file_columns(self.fmt, self.paths[0])

    def _read_cols(self):
        """The columns to read: the projection and the predicate's."""
        if self.projection is None:
            return None
        cols = list(self.projection)
        if self.predicate is not None:
            cols += [r for r in sorted(self.predicate.references()) if r not in cols]
        return cols

    def _read_one(self, path):
        if self.fmt == "parquet":
            from cudf_tpu_torch.io.parquet import _read_parquet_pruned

            filters = predicate_to_filters(self.predicate) if self.predicate is not None \
                else None
            return _read_parquet_pruned(path, self._read_cols(), filters or None,
                                        device=self.device)[0]
        if self.fmt == "csv":
            from cudf_tpu_torch.io.csv import read_csv

            return read_csv(path, usecols=self._read_cols(), device=self.device)
        raise ValueError(f"unknown file format {self.fmt!r}")

    def do_evaluate(self) -> Table:
        from cudf_tpu_torch.ops.copying import concatenate_tables

        tables = [self._read_one(p)._table for p in self.paths]
        t = tables[0] if len(tables) == 1 else concatenate_tables(tables)
        if self.predicate is not None:
            t = _filter_table(t, self.predicate)
        if self.projection is not None:
            t = t.select(self.projection)
        return t

    def _explain_args(self):
        return (f"({self.fmt}, {len(self.paths)} file(s), cols={self.projection}, "
                f"pred={self.predicate!r})")


class Sink(IR):
    """Write the child's table to a file; the table passes through."""

    def __init__(self, child: IR, fmt: str, path: str):
        self.children = (child,)
        self.fmt = fmt
        self.path = path

    def schema(self):
        return self.children[0].schema()

    def do_evaluate(self, t: Table) -> Table:
        from cudf_tpu_torch.frame.dataframe import DataFrame
        from cudf_tpu_torch.frame.index import default_index

        df = DataFrame._from(t, default_index(t.num_rows))
        if self.fmt == "parquet":
            df.to_parquet(self.path)
        elif self.fmt == "csv":
            df.to_csv(self.path, index=False)
        else:
            raise ValueError(f"unknown file format {self.fmt!r}")
        return t


def file_columns(fmt: str, path: str) -> List[str]:
    """A file's column names, from its metadata (Parquet) or its header
    line (CSV)."""
    if fmt == "parquet":
        from cudf_tpu_torch.io.parquet_nested import schema_tree
        from cudf_tpu_torch.io.thrift import read_file_metadata

        return [node.name for node in schema_tree(read_file_metadata(path).schema)]
    if fmt == "csv":
        import csv

        with open(path, newline="") as f:
            return next(csv.reader(f))
    raise ValueError(f"unknown file format {fmt!r}")


class Rolling(IR):
    """Windowed aggregations over a sorted table (the reference's
    ``ir.py`` Rolling): ``aggs`` are (output name, column name, agg)
    triples, each a trailing window of ``period`` rows; the result holds
    the index column and the outputs."""

    def __init__(self, child: IR, index_col: str, period: int, aggs: Sequence):
        self.children = (child,)
        self.index_col = index_col
        self.period = period
        self.aggs = list(aggs)

    def schema(self):
        return [self.index_col] + [a[0] for a in self.aggs]

    def do_evaluate(self, t: Table) -> Table:
        from cudf_tpu_torch.frame.index import default_index
        from cudf_tpu_torch.frame.series import Series
        from cudf_tpu_torch.frame.window import Rolling as FrameRolling

        cols = {self.index_col: t[self.index_col]}
        for out_name, col_name, agg in self.aggs:
            s = Series._from(t[col_name], default_index(t.num_rows), col_name)
            cols[out_name] = getattr(FrameRolling(s, self.period), agg)()._column
        return Table(cols)

    def _explain_args(self):
        return f"(period={self.period}, aggs={self.aggs})"


class MapFunction(IR):
    """Escape hatch: an arbitrary Table -> Table function over the child's
    table (``LazyFrame.map_batches``).  The partitioned executor runs it
    once, over the whole table."""

    def __init__(self, child: IR, fn, name: str = "map"):
        self.children = (child,)
        self.fn = fn
        self.name = name

    def schema(self):
        return self.children[0].schema()

    def do_evaluate(self, t: Table) -> Table:
        return self.fn(t)

    def _explain_args(self):
        return f"({self.name})"


class PythonScan(IR):
    """Source backed by a Python callable that returns a Table or a
    DataFrame (the polars python-source escape hatch)."""

    def __init__(self, fn, schema_hint: Sequence[str] = ()):
        self.fn = fn
        self._schema = list(schema_hint)

    def schema(self):
        return self._schema or list(self.do_evaluate().names)

    def do_evaluate(self) -> Table:
        out = self.fn()
        return out._table if hasattr(out, "_table") else out


class Select(IR):
    """Projection with expression evaluation."""

    def __init__(self, child: IR, exprs: Sequence[Expr]):
        self.children = (child,)
        self.exprs = list(exprs)

    def schema(self):
        return [e.output_name for e in self.exprs]

    def do_evaluate(self, t: Table) -> Table:
        return Table.from_pairs([e.output_name for e in self.exprs],
                                [e.evaluate(t) for e in self.exprs])

    def _explain_args(self):
        return f"({[e.output_name for e in self.exprs]})"


class HStack(IR):
    """with_columns: computed columns appended (or replaced by name),
    each evaluated against the child's table."""

    def __init__(self, child: IR, exprs: Sequence[Expr]):
        self.children = (child,)
        self.exprs = list(exprs)

    def schema(self):
        base = self.children[0].schema()
        return base + [e.output_name for e in self.exprs if e.output_name not in base]

    def do_evaluate(self, t: Table) -> Table:
        out = t
        for e in self.exprs:
            out = out.insert(e.output_name, e.evaluate(t))
        return out


class Filter(IR):
    def __init__(self, child: IR, predicate: Expr):
        self.children = (child,)
        self.predicate = predicate

    def schema(self):
        return self.children[0].schema()

    def do_evaluate(self, t: Table) -> Table:
        return _filter_table(t, self.predicate)

    def _explain_args(self):
        return f"({self.predicate!r})"


class GroupBy(IR):
    """Keyed aggregation through ``ops/groupby.py`` ``groupby_agg``: the
    kernel tiers (one integer or dictionary key) or the sort tier."""

    def __init__(self, child: IR, keys: Sequence[str], aggs: Sequence[Expr]):
        self.children = (child,)
        self.keys = list(keys)
        self.aggs = list(aggs)

    def schema(self):
        return self.keys + [a.output_name for a in self.aggs]

    def do_evaluate(self, t: Table) -> Table:
        from cudf_tpu_torch.ops import groupby as gb

        specs = []
        for a in self.aggs:
            name, inner, kind = unwrap_agg(a)
            specs.append((name, inner.evaluate(t), kind))
        out_keys, out_aggs = gb.groupby_agg(t.select(self.keys), specs)
        cols = dict(out_keys.items())
        cols.update(dict(out_aggs.items()))
        return Table(cols)

    def _explain_args(self):
        return f"(keys={self.keys}, aggs={[repr(a) for a in self.aggs]})"


class Reduce(IR):
    """Whole-table aggregation into a 1-row table."""

    def __init__(self, child: IR, aggs: Sequence[Expr]):
        self.children = (child,)
        self.aggs = list(aggs)

    def schema(self):
        return [a.output_name for a in self.aggs]

    def do_evaluate(self, t: Table) -> Table:
        return Table.from_pairs([a.output_name for a in self.aggs],
                                [a.evaluate(t) for a in self.aggs])


def _pair_device(lt: Table, rt: Table):
    """The device of a join's tables, which a cross join's maps go to."""
    dev = lt.device or rt.device
    if dev is None:
        raise ValueError("a cross join of two tables without columns has no device")
    return dev


class Join(IR):
    """Equi-join through ``ops/join.py``: ``how`` is inner, left, outer
    (or full), cross, semi or anti.  Null keys never match (polars'
    ``join_nulls=False``).  The right side's key columns are dropped; an
    outer join fills a key that both sides name alike from the right
    where the left has none.  Semi and anti joins give left rows only."""

    HOWS = ("inner", "left", "outer", "full", "cross", "semi", "anti")

    def __init__(self, left: IR, right: IR, left_on: Sequence[str],
                 right_on: Sequence[str], how: str = "inner", suffix: str = "_right"):
        if how not in self.HOWS:
            raise ValueError(f"unknown join how={how!r}")
        self.children = (left, right)
        self.left_on = list(left_on)
        self.right_on = list(right_on)
        self.how = how
        self.suffix = suffix

    def schema(self):
        ls = self.children[0].schema()
        if self.how in ("semi", "anti"):
            return ls
        rs = [n for n in self.children[1].schema() if n not in self.right_on]
        return ls + [n + self.suffix if n in ls else n for n in rs]

    def do_evaluate(self, lt: Table, rt: Table) -> Table:
        from cudf_tpu_torch.ops import copying, join as join_ops
        from cudf_tpu_torch.ops.replace import replace_nulls_column

        lk = [lt[k] for k in self.left_on]
        rk = [rt[k] for k in self.right_on]
        if self.how in ("semi", "anti"):
            pick = join_ops.semi_join if self.how == "semi" else join_ops.anti_join
            return copying.gather_table(lt, pick(lk, rk, nulls_equal=False),
                                        bounds_check=False)
        if self.how == "cross":
            li, ri = join_ops.cross_join(lt.num_rows, rt.num_rows, device=_pair_device(lt, rt))
        else:
            li, ri = join_ops._join(lk, rk, "outer" if self.how == "full" else self.how,
                                    nulls_equal=False)
        # an inner or cross join's maps are in range: no bounds check, no masks
        check = self.how in ("left", "outer", "full")
        cols = {}
        for n, c in lt.items():
            col = copying.gather(c, li, bounds_check=check)
            if self.how in ("outer", "full") and n in self.left_on and n in self.right_on:
                col = replace_nulls_column(col, copying.gather(rt[n], ri, bounds_check=True))
            cols[n] = col
        for n, c in rt.items():
            if n not in self.right_on:
                cols[n + self.suffix if n in cols else n] = copying.gather(
                    c, ri, bounds_check=check)
        return Table(cols)

    def _explain_args(self):
        return f"(how={self.how}, on={list(zip(self.left_on, self.right_on))})"


class ConditionalJoin(IR):
    """An inner join on a predicate over pairs of rows: ``predicate(lt,
    rt)`` gets the left and right tables gathered to every (left, right)
    pair (left-major) and returns a BOOL8 column; the pairs where it is
    true (not null) are kept.  A right column whose name the left has
    gets ``_right``."""

    def __init__(self, left: IR, right: IR, predicate, how: str = "inner"):
        if how != "inner":
            raise ValueError(f"a conditional join is inner, not {how!r}")
        self.children = (left, right)
        self.predicate = predicate
        self.how = how

    def schema(self):
        ls = self.children[0].schema()
        return ls + [n + "_right" if n in ls else n for n in self.children[1].schema()]

    def do_evaluate(self, lt: Table, rt: Table) -> Table:
        from cudf_tpu_torch.ops import copying, join as join_ops
        from cudf_tpu_torch.ops.stream_compaction import _mask_of, filter_indices

        li, ri = join_ops.cross_join(lt.num_rows, rt.num_rows, device=_pair_device(lt, rt))
        lg = copying.gather_table(lt, li, bounds_check=False)
        rg = copying.gather_table(rt, ri, bounds_check=False)
        keep = filter_indices(_mask_of(self.predicate(lg, rg)))
        cols = dict(copying.gather_table(lg, keep, bounds_check=False).items())
        for n, c in copying.gather_table(rg, keep, bounds_check=False).items():
            cols[n + "_right" if n in cols else n] = c
        return Table(cols)


class Sort(IR):
    def __init__(self, child: IR, by: Sequence[str], descending: Sequence[bool] = (),
                 nulls_last: bool = True):
        self.children = (child,)
        self.by = list(by)
        self.descending = list(descending) or [False] * len(self.by)
        self.nulls_last = nulls_last

    def schema(self):
        return self.children[0].schema()

    def do_evaluate(self, t: Table) -> Table:
        from cudf_tpu_torch.ops import copying, sort as sort_ops

        order = sort_ops.sorted_order([t[k] for k in self.by],
                                      [not d for d in self.descending],
                                      "last" if self.nulls_last else "first")
        return copying.gather_table(t, order, bounds_check=False)

    def _explain_args(self):
        return f"(by={self.by}, desc={self.descending})"


class Distinct(IR):
    def __init__(self, child: IR, subset: Optional[Sequence[str]] = None, keep: str = "first"):
        self.children = (child,)
        self.subset = list(subset) if subset else None
        self.keep = keep

    def schema(self):
        return self.children[0].schema()

    def do_evaluate(self, t: Table) -> Table:
        from cudf_tpu_torch.ops import stream_compaction as sc

        return sc.distinct(t, self.subset, "first" if self.keep == "any" else self.keep)


class Slice(IR):
    def __init__(self, child: IR, offset: int, length: Optional[int]):
        self.children = (child,)
        self.offset = offset
        self.length = length

    def schema(self):
        return self.children[0].schema()

    def do_evaluate(self, t: Table) -> Table:
        from cudf_tpu_torch.ops import copying

        start = self.offset if self.offset >= 0 else max(t.num_rows + self.offset, 0)
        stop = t.num_rows if self.length is None else start + self.length
        return Table.from_pairs(t.names, [copying.slice(c, start, stop) for c in t.columns])


class Projection(IR):
    def __init__(self, child: IR, columns: Sequence[str]):
        self.children = (child,)
        self.columns = list(columns)

    def schema(self):
        return list(self.columns)

    def do_evaluate(self, t: Table) -> Table:
        return t.select(self.columns)

    def _explain_args(self):
        return f"({self.columns})"


class Union(IR):
    """Vertical concat."""

    def __init__(self, *children: IR):
        self.children = tuple(children)

    def schema(self):
        return self.children[0].schema()

    def do_evaluate(self, *tables: Table) -> Table:
        from cudf_tpu_torch.ops.copying import concatenate_tables

        return concatenate_tables(list(tables))


class HConcat(IR):
    def __init__(self, *children: IR):
        self.children = tuple(children)

    def schema(self):
        return [n for c in self.children for n in c.schema()]

    def do_evaluate(self, *tables: Table) -> Table:
        return Table({n: c for t in tables for n, c in t.items()})


class MergeSorted(IR):
    """A merge of inputs each sorted by the column ``by`` (ascending,
    nulls last): their rows in one sorted order, ties in input order."""

    def __init__(self, by: str, *children: IR):
        self.children = tuple(children)
        self.by = by

    def schema(self):
        return self.children[0].schema()

    def do_evaluate(self, *tables: Table) -> Table:
        from cudf_tpu_torch.ops import copying, join as join_ops

        order = join_ops.merge_sorted([[t[self.by]] for t in tables])
        merged = copying.concatenate_tables(list(tables))
        return copying.gather_table(merged, order, bounds_check=False)

    def _explain_args(self):
        return f"(by={self.by})"


class Empty(IR):
    """A table of empty float64 columns on ``device``."""

    def __init__(self, names: Sequence[str] = (), *, device):
        self.names = list(names)
        self.device = device

    def schema(self):
        return list(self.names)

    def do_evaluate(self) -> Table:
        return Table({n: Column.empty(dt.FLOAT64, device=self.device) for n in self.names})


class Cache(IR):
    """Marks a shared subplan; ``evaluate`` already runs a node once."""

    def __init__(self, child: IR):
        self.children = (child,)

    def schema(self):
        return self.children[0].schema()

    def do_evaluate(self, t: Table) -> Table:
        return t


class ErrorNode(IR):
    def __init__(self, message: str):
        self.message = message

    def schema(self):
        return []

    def do_evaluate(self) -> Table:
        raise RuntimeError(self.message)


# ----------------------------------------------------------------------
# helpers
# ----------------------------------------------------------------------

def unwrap_agg(e: Expr):
    """(output_name, inner_expr, agg_kind) from Agg or Alias(Agg)."""
    name = e.output_name
    while isinstance(e, Alias):
        e = e.children[0]
    if not isinstance(e, Agg):
        raise TypeError(f"expected an aggregation expression, got {e!r}")
    return name, e.children[0], e.agg


def _filter_table(t: Table, predicate: Expr) -> Table:
    from cudf_tpu_torch.ops.stream_compaction import apply_boolean_mask_table

    return apply_boolean_mask_table(t, predicate.evaluate(t))



def predicate_to_filters(pred: Expr) -> list:
    """The conjuncts of a predicate that compare a column with a literal,
    as Parquet (column, op, value) filters (predicate pushdown,
    predicate_pushdown.cpp).  Other conjuncts are left out: the scan
    applies the whole predicate after the read, so the filters only prune.
    (The reference pushes nothing when any conjunct is of another form.)"""
    from cudf_tpu_torch.engine.expr import BinOp, Col, Literal

    if isinstance(pred, BinOp) and pred.op == "and":
        return predicate_to_filters(pred.children[0]) + predicate_to_filters(pred.children[1])
    if isinstance(pred, BinOp) and pred.op in ("eq", "ne", "lt", "gt", "le", "ge"):
        left, right = pred.children
        if isinstance(left, Col) and isinstance(right, Literal) and right.value is not None:
            op = {"eq": "==", "ne": "!=", "lt": "<", "gt": ">", "le": "<=", "ge": ">="}[pred.op]
            return [(left.name, op, right.value)]
    return []
