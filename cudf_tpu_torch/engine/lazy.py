"""LazyFrame, the polars-flavoured lazy query API (port of
``cudf_tpu/engine/lazy.py``): builds the IR, optimizes it and runs it on
the in-memory executor, on the device of its source frames.

``scan_parquet`` / ``scan_csv`` read files onto a device (pushdown into
the ``Scan``); ``sink_parquet`` / ``sink_csv`` write a plan's result when
it is collected.  ``collect(mesh=n)``, ``collect(mesh="auto")`` and
``collect(streaming=True)`` run the plan on the partitioned executor
(``engine/streaming.py``) on the same device; ``collect(mesh=<a
parallel.Mesh>)`` runs it over the mesh's ranks, one process a card
(``engine/spmd.py``), and gives every rank the whole result.
"""

from __future__ import annotations

from typing import Optional, Sequence

from cudf_tpu_torch.engine import ir as IRs
from cudf_tpu_torch.engine.expr import Expr, col, lit
from cudf_tpu_torch.engine.optimizer import optimize

class LazyFrame:
    def __init__(self, node: IRs.IR):
        self._node = node

    # sources ---------------------------------------------------------
    @staticmethod
    def from_dataframe(df) -> "LazyFrame":
        return LazyFrame(IRs.DataFrameScan(df._table))

    # transformations -------------------------------------------------
    def select(self, *exprs) -> "LazyFrame":
        return LazyFrame(IRs.Select(self._node, [_as_expr(e) for e in _flatten(exprs)]))

    def with_columns(self, *exprs) -> "LazyFrame":
        return LazyFrame(IRs.HStack(self._node, [_as_expr(e) for e in _flatten(exprs)]))

    def filter(self, predicate: Expr) -> "LazyFrame":
        return LazyFrame(IRs.Filter(self._node, predicate))

    def group_by(self, *keys) -> "_LazyGroupBy":
        return _LazyGroupBy(self, [k if isinstance(k, str) else k.name for k in _flatten(keys)])

    groupby = group_by

    def join(self, other: "LazyFrame", on=None, left_on=None, right_on=None,
             how: str = "inner", suffix: str = "_right") -> "LazyFrame":
        """``how``: inner, left, outer (full), cross (no keys), semi or anti."""
        if on is not None:
            left_on = right_on = [on] if isinstance(on, str) else list(on)
        else:
            left_on = [left_on] if isinstance(left_on, str) else list(left_on or [])
            right_on = [right_on] if isinstance(right_on, str) else list(right_on or [])
        return LazyFrame(IRs.Join(self._node, other._node, left_on, right_on, how, suffix))

    def sort(self, by, descending=False, nulls_last: bool = True) -> "LazyFrame":
        by = [by] if isinstance(by, str) else list(by)
        desc = [descending] * len(by) if isinstance(descending, bool) else list(descending)
        return LazyFrame(IRs.Sort(self._node, by, desc, nulls_last))

    def unique(self, subset=None, keep: str = "first") -> "LazyFrame":
        subset = [subset] if isinstance(subset, str) else subset
        return LazyFrame(IRs.Distinct(self._node, subset, keep))

    def head(self, n: int = 5) -> "LazyFrame":
        return LazyFrame(IRs.Slice(self._node, 0, n))

    def tail(self, n: int = 5) -> "LazyFrame":
        return LazyFrame(IRs.Slice(self._node, -n, None))

    def slice(self, offset: int, length: Optional[int] = None) -> "LazyFrame":
        return LazyFrame(IRs.Slice(self._node, offset, length))

    def drop(self, *columns) -> "LazyFrame":
        dropped = set(_flatten(columns))
        return LazyFrame(IRs.Projection(self._node,
                                        [c for c in self._node.schema() if c not in dropped]))

    def rename(self, mapping: dict) -> "LazyFrame":
        exprs = [col(n).alias(mapping.get(n, n)) for n in self._node.schema()]
        return LazyFrame(IRs.Select(self._node, exprs))

    def map_batches(self, fn, name: str = "map") -> "LazyFrame":
        return LazyFrame(IRs.MapFunction(self._node, fn, name))

    def sink_parquet(self, path: str) -> "LazyFrame":
        return LazyFrame(IRs.Sink(self._node, "parquet", path))

    def sink_csv(self, path: str) -> "LazyFrame":
        return LazyFrame(IRs.Sink(self._node, "csv", path))

    def cache(self) -> "LazyFrame":
        return LazyFrame(IRs.Cache(self._node))

    def concat(self, *others: "LazyFrame") -> "LazyFrame":
        return LazyFrame(IRs.Union(self._node, *[o._node for o in others]))

    # aggregation without keys ---------------------------------------
    def agg(self, *aggs) -> "LazyFrame":
        return LazyFrame(IRs.Reduce(self._node, [_as_expr(a) for a in _flatten(aggs)]))

    # execution -------------------------------------------------------
    def optimized(self) -> IRs.IR:
        return optimize(self._node)

    def explain(self, optimized: bool = True) -> str:
        return (self.optimized() if optimized else self._node).explain()

    def collect(self, mesh=None, no_optimization: bool = False, streaming: bool = False):
        """Run the plan: a DataFrame on the device of the plan's sources.
        ``mesh``: None (the in-memory executor), a partition count or
        "auto" (the partitioned executor, which picks the count from the
        sources' bytes), or a ``parallel.Mesh`` (every rank of it calls
        ``collect`` on the same plan: ``engine/spmd.py``); ``streaming=True``
        is ``mesh="auto"``."""
        from cudf_tpu_torch.frame.dataframe import DataFrame
        from cudf_tpu_torch.frame.index import default_index

        node = self._node if no_optimization else self.optimized()
        if streaming and mesh is None:
            mesh = "auto"
        if mesh is not None:
            from cudf_tpu_torch.engine.streaming import evaluate_streaming

            t = evaluate_streaming(node, mesh)
        else:
            t = node.evaluate({})
        return DataFrame._from(t, default_index(t.num_rows))

    @property
    def columns(self):
        return self._node.schema()

    def __repr__(self):
        return f"LazyFrame\n{self._node.explain()}"


class _LazyGroupBy:
    def __init__(self, lf: LazyFrame, keys: Sequence[str]):
        self._lf = lf
        self._keys = list(keys)

    def agg(self, *aggs) -> LazyFrame:
        agg_list = []
        for a in _flatten(aggs):
            e = _as_expr(a)
            IRs.unwrap_agg(e)  # an Agg, or an aliased one
            agg_list.append(e)
        return LazyFrame(IRs.GroupBy(self._lf._node, self._keys, agg_list))


def _flatten(items):
    out = []
    for it in items:
        out.extend(it if isinstance(it, (list, tuple)) else [it])
    return out


def _as_expr(e) -> Expr:
    if isinstance(e, Expr):
        return e
    return col(e) if isinstance(e, str) else lit(e)


def scan_parquet(path, columns=None, *, device="cuda") -> LazyFrame:
    """A lazy scan of one Parquet file or a list of them onto ``device``."""
    paths = [path] if isinstance(path, (str, bytes)) or hasattr(path, "__fspath__") else list(path)
    return LazyFrame(IRs.Scan("parquet", [str(p) for p in paths], columns, device=device))


def scan_csv(path, columns=None, *, device="cuda") -> LazyFrame:
    """A lazy scan of one CSV file or a list of them onto ``device``."""
    paths = [path] if isinstance(path, (str, bytes)) or hasattr(path, "__fspath__") else list(path)
    return LazyFrame(IRs.Scan("csv", [str(p) for p in paths], columns, device=device))


def from_dataframe(df) -> LazyFrame:
    return LazyFrame.from_dataframe(df)
