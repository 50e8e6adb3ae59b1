"""DataFrameGroupBy (port of ``cudf_tpu/frame/groupby.py``).

``agg`` takes str, list and dict specs.  A request the kernel tiers serve
(``ops/groupby.py`` ``_try_onehot_fast_path``) goes there; every other
one takes the sort tier (``make_grouper`` and the aggregations over its
group ids).  Keys are one column name or a list of them; groups come in
ascending key order with ``sort=True`` (a null group last under
``dropna=False``), in order of first appearance with ``sort=False``.
``as_index=False`` gives the keys as columns, named as pandas names them.
``head``, ``nth``, ``cumcount``, ``cumsum`` and ``shift`` keep the
frame's rows; rows whose key is null (or NaN) under ``dropna=True``
belong to no group, as in pandas.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.core.table import Table
from cudf_tpu_torch.frame.dataframe import DataFrame
from cudf_tpu_torch.frame.index import Index, MultiIndex
from cudf_tpu_torch.frame.series import Series
from cudf_tpu_torch.ops import copying
from cudf_tpu_torch.ops import groupby as gb_ops
from cudf_tpu_torch.ops._utils import materialize_validity, signed_view
from cudf_tpu_torch.ops.stream_compaction import filter_indices

_SIMPLE_AGGS = ("sum", "mean", "min", "max", "count", "var", "std", "prod", "any", "all",
                "first", "last", "nunique", "median", "idxmin", "idxmax")


class DataFrameGroupBy:
    def __init__(self, obj: DataFrame, by, sort: bool = True, dropna: bool = True,
                 as_index: bool = True, observed: bool = True):
        """``observed`` is accepted for pandas' signature: a dictionary key
        gives the groups its rows hold, as pandas' observed=True does."""
        by_list = list(by) if isinstance(by, (list, tuple)) else [by]
        if not by_list:
            raise ValueError("groupby needs at least one key")
        self._obj = obj
        self._key_names = by_list
        self._key_cols = [obj._table[b] for b in by_list]
        self._sort = sort
        self._dropna = dropna
        self._as_index = as_index
        self._grouper: Optional[gb_ops.Grouper] = None

    @property
    def grouper(self) -> gb_ops.Grouper:
        if self._grouper is None:
            self._grouper = gb_ops.make_grouper(self._key_cols, dropna=self._dropna)
        return self._grouper

    @property
    def ngroups(self) -> int:
        return self.grouper.num_groups

    def _value_names(self) -> List:
        return [n for n in self._obj._table.names if n not in self._key_names]

    # ------------------------------------------------------------------
    # aggregation
    # ------------------------------------------------------------------
    def agg(self, func=None, **named):
        """func: 'sum' | ['sum', 'mean'] | {col: agg or [aggs]}, or pandas'
        named aggregation: ``agg(out=(column, agg), ...)``, one output
        column each, in the order given.

        A list, or a dict with any list value, gives (column, agg) tuple
        names, which pandas shows as MultiIndex columns."""
        if func is None:
            if not named:
                raise TypeError("agg needs a spec or named aggregations")
            return self._run_aggs([(out, col_name, agg)
                                   for out, (col_name, agg) in named.items()])
        if isinstance(func, str):
            return self.size() if func == "size" else self._apply_simple(func)
        specs: List = []  # (out_name, col_name, agg)
        if isinstance(func, dict):
            multi = any(isinstance(v, (list, tuple)) for v in func.values())
            for col_name, aggs in func.items():
                aggs_l = list(aggs) if isinstance(aggs, (list, tuple)) else [aggs]
                for a in aggs_l:
                    specs.append(((col_name, a) if multi else col_name, col_name, a))
        elif isinstance(func, (list, tuple)):
            specs = [((n, a), n, a) for n in self._value_names() for a in func]
        else:
            raise TypeError(f"unsupported agg spec {func!r}")
        return self._run_aggs(specs)

    aggregate = agg

    def _apply_simple(self, agg: str) -> DataFrame:
        return self._run_aggs([(n, n, agg) for n in self._value_names()])

    def _run_aggs(self, specs) -> DataFrame:
        for _, _, agg in specs:
            if agg not in gb_ops._AGG_DISPATCH:
                raise gb_ops._not_ported(agg)
        df = self._try_kernel_aggs(specs)
        if df is None:
            g = self.grouper
            perm = self._group_order()
            cols = {}
            for out, col_name, agg in specs:
                col = gb_ops.aggregate(self._obj._table[col_name], g, agg)
                if agg in ("idxmin", "idxmax"):
                    col = self._labels(col)
                cols[out] = col if perm is None else copying.gather(col, perm,
                                                                     bounds_check=False)
            df = DataFrame._from(Table(cols), self._result_index(perm))
        return df if self._as_index else df.reset_index()

    def _try_kernel_aggs(self, specs) -> Optional[DataFrame]:
        if len(self._key_cols) != 1:
            return None
        vals = [(out, self._obj._table[col_name], agg) for out, col_name, agg in specs]
        res = gb_ops._try_onehot_fast_path(
            Table({"__key__": self._key_cols[0]}), vals, self._dropna)
        if res is None:
            return None
        gk, ga = res
        key = gk.column(0)
        if not self._sort:
            perm = self._first_appearance(key)
            ga = copying.gather_table(ga, perm, bounds_check=False)
            key = copying.gather(key, perm, bounds_check=False)
        return DataFrame._from(ga, Index(key, name=self._key_names[0]))

    def _first_appearance(self, groups: Column) -> torch.Tensor:
        """The order of the kernel tiers' groups (ascending, unique keys)
        by each one's first row in the frame."""
        key = self._key_cols[0]
        G, n = groups.length, key.length
        slot = torch.searchsorted(groups.data.long(), key.data.long())
        if key.validity is not None:             # dropped null keys: no group
            slot = torch.where(key.validity, slot, G)
        first = torch.full((G + 1,), n, dtype=torch.int64, device=key.device)
        first.scatter_reduce_(0, slot, torch.arange(n, device=key.device), "amin")
        return torch.argsort(first[:G])

    def _group_order(self) -> Optional[torch.Tensor]:
        """None for sorted key order, else the groups by first appearance
        (each group's first kept row is its key row, the stable sort's
        run head)."""
        return None if self._sort else torch.argsort(self.grouper.key_rows)

    def _result_index(self, perm: Optional[torch.Tensor]) -> Index:
        g = self.grouper
        rows = g.frame_rows(g.key_rows)
        if perm is not None:
            rows = rows[perm]
        cols = [copying.gather(c, rows, bounds_check=False) for c in self._key_cols]
        if len(cols) == 1:
            return Index(cols[0], name=self._key_names[0])
        return MultiIndex(cols, self._key_names)

    def _labels(self, rows: Column) -> Column:
        """Frame rows (idxmin/idxmax) as the frame's index labels."""
        index = self._obj.index
        if isinstance(index, MultiIndex):
            raise NotImplementedError("idxmin/idxmax over a MultiIndex frame: ROADMAP.md "
                                      "queue 1, item 4")
        labels = index.take(rows.data).column()
        return Column(labels.dtype, labels.length, labels.data, rows.validity)

    def size(self):
        """Rows a group: a Series (a frame with a "size" column under
        as_index=False)."""
        col = gb_ops.group_size(self.grouper)
        perm = self._group_order()
        if perm is not None:
            col = copying.gather(col, perm, bounds_check=False)
        if not self._as_index:
            return DataFrame._from(Table({"size": col}), self._result_index(perm)).reset_index()
        return Series._from(col, self._result_index(perm), None)

    # ------------------------------------------------------------------
    # row filters and transforms: the frame's rows and index
    # ------------------------------------------------------------------
    def _positions(self):
        """(each kept row's position in its group, its group's size)."""
        g = self.grouper
        cc = gb_ops.group_cumcount(g).data
        return cc, gb_ops._sizes(g)[g.group_ids]

    def head(self, n: int = 5) -> DataFrame:
        """The first n rows of each group (all but the last -n when n < 0),
        in frame order."""
        cc, sizes = self._positions()
        keep = cc < n if n >= 0 else cc < sizes + n
        return self._obj.take(self.grouper.frame_rows(filter_indices(keep)))

    def nth(self, n: int) -> DataFrame:
        """The n-th row of each group (from the end when n < 0), in frame
        order, as pandas' nth filters."""
        cc, sizes = self._positions()
        keep = cc == n if n >= 0 else cc == sizes + n
        return self._obj.take(self.grouper.frame_rows(filter_indices(keep)))

    def _frame_rows(self, col: Column) -> Column:
        """A column over the kept rows, spread over the frame's rows (null
        where a row's key was dropped)."""
        g = self.grouper
        if g.kept_rows is None:
            return col
        n = len(self._obj)
        src = signed_view(col.data)
        data = torch.zeros(n, dtype=src.dtype, device=col.device)
        data[g.kept_rows] = src
        valid = torch.zeros(n, dtype=torch.bool, device=col.device)
        valid[g.kept_rows] = materialize_validity(col)
        return Column(col.dtype, n, data.view(col.data.dtype), valid)

    def cumcount(self) -> Series:
        col = self._frame_rows(gb_ops.group_cumcount(self.grouper))
        return Series._from(col, self._obj.index, None)

    def cumsum(self) -> DataFrame:
        g = self.grouper
        cols = {n: self._frame_rows(gb_ops.group_cumsum(self._obj._table[n], g))
                for n in self._value_names()}
        return DataFrame._from(Table(cols), self._obj.index)

    def shift(self, periods: int = 1) -> DataFrame:
        g = self.grouper
        cols = {n: self._frame_rows(gb_ops.group_shift(self._obj._table[n], g, periods))
                for n in self._value_names()}
        return DataFrame._from(Table(cols), self._obj.index)


def _simple(agg: str):
    def method(self) -> DataFrame:
        return self._apply_simple(agg)

    method.__name__ = agg
    method.__doc__ = f"groupby {agg} of every value column"
    return method


for _agg in _SIMPLE_AGGS:
    setattr(DataFrameGroupBy, _agg, _simple(_agg))
