"""DataFrameGroupBy and SeriesGroupBy (port of ``cudf_tpu/frame/groupby.py``).

Keys are column names, Series (aligned by label; a Series that is the
frame's own column leaves that column out of the values, as in pandas),
host arrays of the object's length, or index levels (``level=``, names
or positions, over an Index or a MultiIndex).  ``df.groupby(k)[name]`` is
a SeriesGroupBy and ``df.groupby(k)[[names]]`` a DataFrameGroupBy over
those columns; both keep ``sort``, ``dropna``, ``as_index`` and
``observed`` (a dictionary key gives the groups its rows hold, as
pandas' observed=True does).

Aggregations (``agg`` with a name, a list, a dict or named outputs, and
one method an aggregation) go to the kernel tiers when they serve the
request (``ops/groupby.py`` ``_try_onehot_fast_path``: one integer or
dictionary key), else to the sort tier (``make_grouper`` and the
aggregations over its group ids).  Groups come in ascending key order
with ``sort=True`` (a null group last under ``dropna=False``), in order
of first appearance with ``sort=False``; ``ngroup``, ``groups``,
iteration, ``apply`` and ``describe`` follow the same order.
``as_index=False`` gives the keys as columns, named as pandas names them.

``transform`` of an aggregation name takes the kernel tiers first
(``transform_kernel_tier``: K-slot results gathered by each row's code),
else the sort tier, and broadcasts to the rows; ``transform`` of a
callable, ``apply`` and ``filter`` call the function once a group on the
host (``filter`` then masks the rows by group id on the device).
``agg(list)``, ``agg(set)``, "collect", "unique", "collect_set" and
"histogram" give LIST columns (``SeriesGroupBy.unique`` too).
``rank`` ranks within groups with pandas' ties; ``describe`` gives
pandas' eight statistics under (column, statistic) names; ``cov`` and
``corr`` pandas' (keys..., column) rows by the numeric columns, in two
passes (pandas 3 drops the keys from that index under as_index=False; the
port keeps them).  ``ewm(...).mean()`` is the per-row weighted mean in
group order under a (keys..., label) MultiIndex.  Rows whose key is null
(or NaN) under ``dropna=True`` belong to no group, as in pandas.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.core.table import Table
from cudf_tpu_torch.frame.dataframe import DataFrame
from cudf_tpu_torch.frame.index import Index, MultiIndex
from cudf_tpu_torch.frame.series import BEYOND, Series, column_of
from cudf_tpu_torch.ops import binaryop, copying, unary
from cudf_tpu_torch.ops import groupby as gb_ops
from cudf_tpu_torch.ops._utils import inverse_permutation, materialize_validity, signed_view
from cudf_tpu_torch.ops.replace import nans_to_nulls
from cudf_tpu_torch.ops.row_ops import equality_keys, lex_sort_permutation, sort_operands
from cudf_tpu_torch.ops.scan import running_extreme
from cudf_tpu_torch.ops.stream_compaction import filter_indices

_SIMPLE_AGGS = ("sum", "mean", "min", "max", "count", "var", "std", "prod", "any", "all",
                "first", "last", "nunique", "median", "idxmin", "idxmax")
_DESCRIBE = ("count", "mean", "std", "min", "25%", "50%", "75%", "max")
_TRANSFORMS = ("cumsum", "cumcount", "shift", "rank", "ngroup")


def _aligned(key: Series, index: Index, device) -> Column:
    """A key Series' column over ``index``'s labels (its own when the two
    indexes are one)."""
    if key._index.equals(index):
        return key._column
    pos = key._index.get_indexer_for(index.column(device), device)
    return copying.gather(key._column, pos, bounds_check=True)


def _resolve_keys(obj, by, level):
    """(key names, key columns, names of the frame columns that are keys)."""
    names, cols, in_frame = [], [], set()
    index, dev = obj.index, obj.device
    if level is not None:
        for lv in (level if isinstance(level, (list, tuple)) else [level]):
            if isinstance(index, MultiIndex):
                i = lv if isinstance(lv, int) else list(index.names).index(lv)
                names.append(index.names[i])
                cols.append(index._columns[i])
            else:
                if lv not in (0, -1, index.name):
                    raise KeyError(f"level {lv!r} is not the index's")
                names.append(index.name)
                cols.append(index.column(dev))
        return names, cols, in_frame
    if by is None:
        raise TypeError("groupby needs by= or level=")
    if isinstance(by, (np.ndarray, torch.Tensor)) or (
            isinstance(by, list) and not isinstance(obj, DataFrame) and by
            and not isinstance(by[0], Series) and len(by) == len(obj)):
        by = [Series._from(column_of(by, dev), index)]       # one key of host values
    for b in (by if isinstance(by, (list, tuple)) else [by]):
        if isinstance(b, Series):
            col = _aligned(b, index, dev)
            if isinstance(obj, DataFrame) and b.name in obj._table \
                    and obj._table[b.name] is b._column:
                in_frame.add(b.name)                          # the frame's own column
            names.append(b.name)
            cols.append(col)
        elif isinstance(obj, DataFrame):
            names.append(b)
            cols.append(obj._table[b])
            in_frame.add(b)
        else:
            raise KeyError(f"a Series groups by Series, arrays or levels, not {b!r}")
    if not cols:
        raise ValueError("groupby needs at least one key")
    return names, cols, in_frame


class _GroupBy:
    """What DataFrameGroupBy and SeriesGroupBy share: the keys, the
    grouper, the groups' order and access to them, and the frame-shaped
    results both build on (``self._obj`` is a DataFrame of the values)."""

    def __init__(self, obj, by=None, level=None, sort: bool = True, dropna: bool = True,
                 as_index: bool = True, observed: bool = True):
        self._key_names, self._key_cols, self._in_frame = _resolve_keys(obj, by, level)
        self._list_form = isinstance(by, (list, tuple)) or isinstance(level, (list, tuple))
        self._sort = sort
        self._dropna = dropna
        self._as_index = as_index
        self._grouper: Optional[gb_ops.Grouper] = None
        self._subset: Optional[list] = None

    def _share(self, other: "_GroupBy") -> None:
        """Take other's keys, flags and grouper (a column selection)."""
        for attr in ("_key_names", "_key_cols", "_in_frame", "_list_form", "_sort", "_dropna",
                     "_as_index", "_grouper"):
            setattr(self, attr, getattr(other, attr))

    @property
    def grouper(self) -> gb_ops.Grouper:
        if self._grouper is None:
            self._grouper = gb_ops.make_grouper(self._key_cols, dropna=self._dropna)
        return self._grouper

    @property
    def ngroups(self) -> int:
        return self.grouper.num_groups

    def _value_names(self) -> List:
        if self._subset is not None:
            return list(self._subset)
        return [n for n in self._obj._table.names if n not in self._in_frame]

    # ------------------------------------------------------------------
    # the groups' order and keys
    # ------------------------------------------------------------------
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

    def _ordered(self, col: Column, perm: Optional[torch.Tensor]) -> Column:
        return col if perm is None else copying.gather(col, perm, bounds_check=False)

    def _host_keys(self, perm) -> list:
        """Each group's key in output order, as pandas' iteration gives it
        (a tuple for several keys or a list of keys)."""
        idx = self._result_index(perm)
        keys = idx.to_pylist()
        if isinstance(idx, MultiIndex) or not self._list_form:
            return keys
        return [(k,) for k in keys]

    def _group_slices(self):
        """(the kept frame rows group by group in output order, each group's
        (start, stop) in them): one host sync for the bounds."""
        g = self.grouper
        perm = self._group_order()
        sizes = gb_ops._sizes(g)
        ends = torch.cumsum(sizes if perm is None else sizes[perm], 0).tolist()
        return g.frame_rows(self._rows_in_group_order()), list(zip([0] + ends[:-1], ends))

    def _groups_of(self, obj):
        """(each group's frame rows, obj's rows of the group) in output
        order: obj is gathered once in that order, each group a slice (a
        view) of it."""
        rows, bounds = self._group_slices()
        ordered = obj.take(rows)
        for a, b in bounds:
            yield rows[a:b], ordered.iloc[a:b]

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

    def _output_position(self) -> torch.Tensor:
        """Each grouper group's position in the output order."""
        perm = self._group_order()
        g = self.grouper
        if perm is None:
            return torch.arange(g.num_groups, dtype=torch.int64, device=g.group_ids.device)
        return inverse_permutation(perm)

    def _rows_in_group_order(self) -> torch.Tensor:
        """The kept rows, group by group in output order, each group's rows
        in row order."""
        g = self.grouper
        if self._sort:
            return g.sorted_order
        return torch.sort(self._output_position()[g.group_ids], stable=True).indices

    def _selected(self):
        """The object a group of iteration, filter and get_group is a part
        of: the frame (its selected columns), or the Series."""
        raise NotImplementedError

    def _take(self, rows: torch.Tensor):
        return self._selected().take(rows)

    def _scalar_name(self):
        """The name of apply's Series of scalars: none for a frame's groups."""
        return None

    def _values_obj(self):
        """The object apply's and transform's functions see: the values
        without the key columns."""
        raise NotImplementedError

    # ------------------------------------------------------------------
    # group access
    # ------------------------------------------------------------------
    def __iter__(self):
        keys = self._host_keys(self._group_order())
        for key, (_, group) in zip(keys, self._groups_of(self._selected())):
            yield key, group

    @property
    def groups(self) -> dict:
        """{key: Index of the group's row labels}, in output order."""
        keys = self._result_index(self._group_order()).to_pylist()   # a scalar for one key
        rows, bounds = self._group_slices()
        labels = self._obj.index.take(rows)
        return {k: labels[a:b] for k, (a, b) in zip(keys, bounds)}

    def ngroup(self) -> Series:
        """Each row's group number in output order (null where the key was
        dropped)."""
        g = self.grouper
        col = Column(dt.INT64, g.group_ids.shape[0], self._output_position()[g.group_ids])
        return Series._from(self._frame_rows(col), self._obj.index, None)

    def get_group(self, key):
        """The rows whose keys equal ``key`` (a tuple for several keys)."""
        keys = key if isinstance(key, tuple) else (key,)
        if len(keys) != len(self._key_cols):
            raise KeyError(key)
        mask = None
        for c, k in zip(self._key_cols, keys):
            eq = binaryop.binary_operation(c, k, "eq")
            m = eq.data if eq.validity is None else eq.data & eq.validity
            mask = m if mask is None else mask & m
        rows = filter_indices(mask)
        if rows.shape[0] == 0:
            raise KeyError(key)
        return self._take(rows)

    def rolling(self, window, min_periods=None):
        """Trailing windows of ``window`` rows within each group
        (``frame/window.py`` ``RollingGroupby``)."""
        from cudf_tpu_torch.frame.window import RollingGroupby

        return RollingGroupby(self, window, min_periods)

    # ------------------------------------------------------------------
    # aggregation
    # ------------------------------------------------------------------
    def _run_aggs(self, specs) -> DataFrame:
        specs = [(out, col_name, _norm_agg(agg)) for out, col_name, agg in specs]
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
                cols[out] = self._ordered(col, perm)
            df = DataFrame._from(Table(cols), self._result_index(perm))
        return df if self._as_index else df.reset_index()

    def _try_kernel_aggs(self, specs) -> Optional[DataFrame]:
        if len(self._key_cols) != 1:
            return None
        vals = [(out, self._obj._table[col_name], agg) for out, col_name, agg in specs]
        res = gb_ops._try_onehot_fast_path(
            Table({"__key__": self._key_cols[0]}), vals, self._dropna, dictionary_codes=True,
            first_appearance=not self._sort)
        if res is None:
            return None
        gk, ga = res
        return DataFrame._from(ga, Index(gk.column(0), name=self._key_names[0]))

    def _labels(self, rows: Column) -> Column:
        """Frame rows (idxmin/idxmax) as the frame's index labels."""
        index = self._obj.index
        if isinstance(index, MultiIndex):
            raise NotImplementedError(f"idxmin/idxmax over a MultiIndex frame: {BEYOND}")
        labels = index.take(rows.data).column()
        return Column(labels.dtype, labels.length, labels.data, rows.validity)

    def size(self):
        """Rows a group: a Series (a frame with a "size" column under
        as_index=False)."""
        perm = self._group_order()
        col, index = self._ordered(gb_ops.group_size(self.grouper), perm), \
            self._result_index(perm)
        if not self._as_index:
            return DataFrame._from(Table({"size": col}), index).reset_index()
        return Series._from(col, index, self._scalar_name())

    def quantile(self, q: float = 0.5, interpolation: str = "linear") -> DataFrame:
        g, perm = self.grouper, self._group_order()
        cols = {n: self._ordered(gb_ops.group_quantile(self._obj._table[n], g, q,
                                                       interpolation), perm)
                for n in self._value_names()}
        df = DataFrame._from(Table(cols), self._result_index(perm))
        return df if self._as_index else df.reset_index()

    # ------------------------------------------------------------------
    # row filters and transforms: the frame's rows and index
    # ------------------------------------------------------------------
    def _positions(self):
        """(each kept row's position in its group, its group's size)."""
        g = self.grouper
        cc = gb_ops.group_cumcount(g).data
        return cc, gb_ops._sizes(g)[g.group_ids]

    def _rows_where(self, keep: torch.Tensor):
        return self._take(self.grouper.frame_rows(filter_indices(keep)))

    def head(self, n: int = 5):
        """The first n rows of each group (all but the last -n when n < 0),
        in frame order."""
        cc, sizes = self._positions()
        return self._rows_where(cc < n if n >= 0 else cc < sizes + n)

    def nth(self, n: int):
        """The n-th row of each group (from the end when n < 0), in frame
        order, as pandas' nth filters."""
        cc, sizes = self._positions()
        return self._rows_where(cc == n if n >= 0 else cc == sizes + n)

    def cumcount(self) -> Series:
        col = self._frame_rows(gb_ops.group_cumcount(self.grouper))
        return Series._from(col, self._obj.index, None)

    def _per_row(self, fn) -> DataFrame:
        """fn(column) over the kept rows, for each value column, spread over
        the frame's rows."""
        cols = {n: self._frame_rows(fn(self._obj._table[n])) for n in self._value_names()}
        return DataFrame._from(Table(cols), self._obj.index)

    def cumsum(self) -> DataFrame:
        return self._per_row(lambda c: gb_ops.group_cumsum(c, self.grouper))

    def shift(self, periods: int = 1) -> DataFrame:
        return self._per_row(lambda c: gb_ops.group_shift(c, self.grouper, periods))

    def rank(self, method: str = "average", ascending: bool = True, na_option: str = "keep",
             pct: bool = False) -> DataFrame:
        cols = {}
        for n in self._value_names():
            c = self._obj._table[n]
            if c.dtype.is_numeric or c.dtype.is_bool or c.dtype.is_temporal:
                cols[n] = self._frame_rows(_group_rank(c, self.grouper, method, ascending,
                                                       na_option, pct))
        return DataFrame._from(Table(cols), self._obj.index)

    def transform(self, func, *args, **kwargs):
        """Each value column's transform over the frame's rows: an
        aggregation broadcast (the kernel tiers first), a transformation
        by name, or a callable once a group; "size" gives one Series."""
        if callable(func):
            return self._transform_callable(func, *args, **kwargs)
        if func in _TRANSFORMS:
            return getattr(self, func)(*args, **kwargs)
        if func == "size":
            g = self.grouper
            return Series._from(self._frame_rows(copying.gather(
                gb_ops.group_size(g), g.group_ids, bounds_check=False)), self._obj.index,
                self._scalar_name())
        if func not in gb_ops._AGG_DISPATCH:
            raise gb_ops._not_ported(func)
        names = self._value_names()
        if len(self._key_cols) == 1 and func in gb_ops.SUPPORTED_AGGS:
            fast = gb_ops.transform_kernel_tier(
                self._key_cols[0], [(n, self._obj._table[n], func) for n in names],
                self._dropna)
            if fast is not None:
                return DataFrame._from(Table(fast), self._obj.index)
        g = self.grouper
        cols = {}
        for n in names:
            res = gb_ops.aggregate(self._obj._table[n], g, func)
            if func in ("idxmin", "idxmax"):
                res = self._labels(res)
            cols[n] = self._frame_rows(copying.gather(res, g.group_ids, bounds_check=False))
        return DataFrame._from(Table(cols), self._obj.index)

    def _transform_callable(self, func, *args, **kwargs) -> DataFrame:
        """func once a group (on the values without the keys); a scalar
        result is broadcast over the group, a like-shaped one placed back
        at the group's rows."""
        names = self._value_names()
        parts, rows_all = {n: [] for n in names}, []
        for rows, res in self._apply_groups(func, args, kwargs):
            k = rows.shape[0]
            rows_all.append(rows)
            for n in names:
                if isinstance(res, DataFrame):
                    parts[n].append(res._table[n])
                elif isinstance(res, Series):
                    parts[n].append(res._column)
                else:
                    parts[n].append(Column.full(k, res, device=rows.device))
        n_rows, dev = len(self._obj), self._obj.device
        if not rows_all:
            return DataFrame._from(Table({n: self._obj._table[n] for n in names}),
                                   self._obj.index)
        where = torch.cat(rows_all)
        cols = {}
        for n in names:
            vals = copying.concatenate(parts[n])
            cols[n] = copying.scatter(vals, where, Column.full(n_rows, None, vals.dtype,
                                                              device=dev))
        return DataFrame._from(Table(cols), self._obj.index)

    def _apply_groups(self, func, args, kwargs):
        """(the group's frame rows, func(the group's values)) a group, in
        output order: the host loop of apply and transform."""
        for rows, group in self._groups_of(self._values_obj()):
            yield rows, func(group, *args, **kwargs)

    def filter(self, func, dropna: bool = True, *args, **kwargs):
        """The rows of the groups for which func(group) is true: func runs
        once a group on the host, the kept groups become a row mask by
        group id on the device."""
        perm = self._group_order()
        g = self.grouper
        keep = [bool(func(group, *args, **kwargs))
                for _, group in self._groups_of(self._selected())]
        kept = torch.zeros(g.num_groups, dtype=torch.bool, device=g.group_ids.device)
        if keep:
            flags = torch.tensor(keep, device=kept.device)
            kept[torch.arange(g.num_groups, device=kept.device) if perm is None else perm] = flags
        mask = torch.zeros(len(self._obj), dtype=torch.bool, device=kept.device)
        mask[g.frame_rows(torch.arange(g.group_ids.shape[0], device=kept.device))] = \
            kept[g.group_ids]
        if dropna:
            return self._take(filter_indices(mask))
        obj = self._selected()          # pandas: the other rows kept, their values null
        if isinstance(obj, Series):
            return obj._new(obj._column.with_validity(materialize_validity(obj._column) & mask))
        return DataFrame._from(Table({n: c.with_validity(materialize_validity(c) & mask)
                                      for n, c in obj._table.items()}), obj.index)

    def apply(self, func, *args, **kwargs):
        """A host loop over the groups: scalar results give a Series over
        the keys; Series or DataFrame results are concatenated under the
        keys, a (keys..., label) MultiIndex."""
        perm = self._group_order()
        results = [res for _, res in self._apply_groups(func, args, kwargs)]
        index = self._result_index(perm)
        dev = self._obj.device
        if all(not isinstance(r, (Series, DataFrame)) for r in results):
            out = Series([np.nan if r is None else r for r in results], index=index,
                         name=self._scalar_name(), device=dev)
            return out if self._as_index else out.reset_index()
        if not all(isinstance(r, type(results[0])) for r in results):
            raise TypeError("apply: the groups' results mix kinds")
        counts = torch.tensor([len(r) for r in results], device=dev)
        rep = torch.repeat_interleave(torch.arange(len(results), device=dev), counts)
        levels = index._columns if isinstance(index, MultiIndex) else (index.column(dev),)
        key_cols = [copying.gather(c, rep, bounds_check=False) for c in levels]
        labels = copying.concatenate([r.index.column(dev) for r in results])
        idx = MultiIndex([*key_cols, labels], [*self._key_names, results[0].index.name])
        if isinstance(results[0], Series):
            return Series._from(copying.concatenate([r._column for r in results]), idx,
                                results[0].name)
        names = results[0].columns
        return DataFrame._from(Table({n: copying.concatenate([r._table[n] for r in results])
                                      for n in names}), idx)

    # ------------------------------------------------------------------
    # statistics
    # ------------------------------------------------------------------
    def _describe_columns(self, name) -> dict:
        """pandas' eight statistics of one column, float64, in output
        order: {statistic: column}."""
        g, perm = self.grouper, self._group_order()
        col = self._obj._table[name]

        def f64(c):
            return c if c.dtype == dt.FLOAT64 else unary.cast(c, dt.FLOAT64)

        stats = {"count": gb_ops.group_count(col, g), "mean": gb_ops.group_mean(col, g),
                 "std": gb_ops.group_std(col, g)}
        # min, the quartiles and max from one sort by (group, value)
        quantiles = gb_ops.group_quantiles(col, g, (0.0, 0.25, 0.5, 0.75, 1.0))
        stats.update(zip(("min", "25%", "50%", "75%", "max"), quantiles))
        return {s: self._ordered(f64(stats[s]), perm) for s in _DESCRIBE}

    def _numeric_names(self) -> list:
        return [n for n in self._value_names() if self._obj._table[n].dtype.is_numeric]

    def _pairwise(self, which: str, ddof: int = 1) -> DataFrame:
        """pandas' layout of groupby cov/corr: (keys..., column) rows, group
        by group in output order, by the numeric columns."""
        g, perm = self.grouper, self._group_order()
        names = self._numeric_names()
        L, G = len(names), g.num_groups
        pairs = gb_ops.group_pairwise([self._obj._table[n] for n in names], g, which, ddof)
        cells = {}
        for (i, j), r in pairs.items():
            data = torch.where(r.validity, r.data, float("nan"))
            cells[i, j] = cells[j, i] = data if perm is None else data[perm]
        out = {}
        for j, n in enumerate(names):
            stacked = torch.stack([cells[i, j] for i in range(L)], dim=1).reshape(G * L)
            out[n] = Column(dt.FLOAT64, G * L, stacked, ~torch.isnan(stacked))
        dev = g.group_ids.device
        pos = torch.arange(G * L, device=dev)
        index = self._result_index(perm)
        levels = index._columns if isinstance(index, MultiIndex) else (index.column(dev),)
        keys = [copying.gather(c, pos // max(L, 1), bounds_check=False) for c in levels]
        name_col = copying.gather(Column.from_pylist(list(names), device=dev), pos % max(L, 1),
                                  bounds_check=False)
        return DataFrame._from(Table(out), MultiIndex([*keys, name_col], [*self._key_names, None]))


def _group_rank(col: Column, g: gb_ops.Grouper, method: str, ascending: bool,
                na_option: str, pct: bool) -> Column:
    """Ranks within groups over the kept rows (float64), pandas' ties
    (average, min, max, first, dense); NaN is null; with na_option="keep"
    a null row's rank is null, "top"/"bottom" rank nulls first or last."""
    if method not in ("average", "min", "max", "first", "dense"):
        raise ValueError(f"rank method {method!r}")
    col = nans_to_nulls(gb_ops._apply_row_mask(col, g)) if col.dtype.is_float else \
        gb_ops._apply_row_mask(col, g)
    n, dev = col.length, col.device
    na_pos = "first" if na_option == "top" else "last"
    gid = g.group_ids.int() if g.num_groups < 1 << 31 else g.group_ids
    order = lex_sort_permutation([gid, *sort_operands([col], [ascending], na_pos)])
    gs = g.group_ids[order]
    neq = torch.zeros(n, dtype=torch.bool, device=dev)
    neq[:1] = True
    for k in [gs, *equality_keys(col)]:
        s = k if k is gs else k[order]
        neq[1:] |= s[1:] != s[:-1]
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    start = g.group_offsets[:-1][gs]                       # the group's first sorted row
    run = torch.cumsum(neq, 0) - 1                         # tie-run id a sorted row
    run_first = running_extreme(torch.where(neq, pos, -1), "cummax")
    run_size = torch.zeros(n, dtype=torch.int64, device=dev).index_add_(
        0, run, torch.ones_like(run))[run]
    lo = (run_first - start + 1).double()
    if method == "first":
        r = (pos - start + 1).double()
    elif method == "min":
        r = lo
    elif method == "max":
        r = lo + run_size - 1
    elif method == "average":
        r = lo + (run_size - 1) / 2.0
    else:
        r = (run - run[g.group_offsets[:-1]][gs] + 1).double()
    keep = na_option == "keep" and col.validity is not None
    if pct:
        valid_s = materialize_validity(col)[order] if keep else \
            torch.ones(n, dtype=torch.bool, device=dev)
        if method == "dense":
            denom = torch.zeros(g.num_groups, dtype=torch.int64, device=dev).index_add_(
                0, gs, (neq & valid_s).long())
        else:
            denom = torch.zeros(g.num_groups, dtype=torch.int64, device=dev).index_add_(
                0, gs, valid_s.long())
        r = r / denom[gs].clamp(min=1).double()
    out = torch.empty_like(r)
    out[order] = r
    return Column(dt.FLOAT64, n, out, col.validity if keep else None)


class DataFrameGroupBy(_GroupBy):
    def __init__(self, obj: DataFrame, by=None, level=None, sort: bool = True,
                 dropna: bool = True, as_index: bool = True, observed: bool = True):
        self._obj = obj
        super().__init__(obj, by, level, sort, dropna, as_index, observed)

    def __getitem__(self, key):
        """One name: a SeriesGroupBy; a list: a DataFrameGroupBy over those
        columns.  Both keep the keys, the flags and the grouper."""
        if isinstance(key, (list, tuple)):
            for k in key:
                self._obj._table[k]
            sub = DataFrameGroupBy.__new__(DataFrameGroupBy)
            sub._obj = self._obj
            sub._share(self)
            sub._subset = list(key)
            return sub
        sgb = SeriesGroupBy.__new__(SeriesGroupBy)
        sgb._series = self._obj[key]
        sgb._obj = DataFrame._from(Table({key: self._obj._table[key]}), self._obj.index)
        sgb._share(self)
        sgb._subset = None
        return sgb

    def __getattr__(self, name):
        obj = self.__dict__.get("_obj")
        if obj is not None and name in obj._table.names and name not in self.__dict__:
            return self[name]
        raise AttributeError(name)

    def _selected(self):
        return self._obj if self._subset is None else self._obj[self._subset]

    def _values_obj(self):
        return self._obj[self._value_names()]

    # ------------------------------------------------------------------
    # aggregation
    # ------------------------------------------------------------------
    def agg(self, func=None, **named):
        """func: 'sum' | ['sum', 'mean'] | {col: agg or [aggs]}, or pandas'
        named aggregation: ``agg(out=(column, agg), ...)``, one output
        column each, in the order given.

        A list, or a dict with any list value, gives (column, agg) tuple
        names, pandas' MultiIndex columns."""
        if func is None:
            if not named:
                raise TypeError("agg needs a spec or named aggregations")
            return self._run_aggs([(out, col_name, agg)
                                   for out, (col_name, agg) in named.items()])
        func = _norm_agg(func)
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

    def describe(self) -> DataFrame:
        """pandas' count, mean, std, min, 25%, 50%, 75% and max of each
        numeric column, float64, under (column, statistic) names."""
        cols = {}
        for n in self._numeric_names():
            for s, c in self._describe_columns(n).items():
                cols[(n, s)] = c
        df = DataFrame._from(Table(cols), self._result_index(self._group_order()))
        return df if self._as_index else df.reset_index()

    def cov(self, ddof: int = 1, **kwargs) -> DataFrame:
        return self._pairwise("cov", ddof)

    def corr(self, method: str = "pearson", **kwargs) -> DataFrame:
        if method != "pearson":
            raise NotImplementedError(f"groupby corr(method={method!r}): pearson only")
        return self._pairwise("corr")


class SeriesGroupBy(_GroupBy):
    """A Series grouped by keys: every result a Series named after it
    (a frame of the keys and it under as_index=False)."""

    def __init__(self, obj: Series, by=None, level=None, sort: bool = True,
                 dropna: bool = True, as_index: bool = True, observed: bool = True):
        self._series = obj
        self._obj = DataFrame._from(Table({obj.name: obj._column}), obj.index)
        if by is None and level is None:
            level = 0
        super().__init__(obj, by, level, sort, dropna, as_index, observed)

    @property
    def _name(self):
        return self._series.name

    def _scalar_name(self):
        return self._name

    def _selected(self):
        return self._series

    def _values_obj(self):
        return self._series

    def _one(self, df: DataFrame):
        """A one-column frame result as this Series' result."""
        if not self._as_index:
            return df
        return Series._from(df._table.column(0), df.index, self._name)

    def _per_row_series(self, df: DataFrame) -> Series:
        return Series._from(df._table.column(0), df.index, self._name)

    # ------------------------------------------------------------------
    # aggregation
    # ------------------------------------------------------------------
    def _apply_simple(self, agg: str):
        return self._one(self._run_aggs([(self._name, self._name, agg)]))

    def agg(self, func=None, **named):
        """A name (a Series), a list of names or named outputs
        (``agg(total="sum")``; a frame), or a callable (once a group)."""
        if func is None:
            if not named:
                raise TypeError("agg needs a spec or named aggregations")
            return self._run_aggs([(out, self._name, a) for out, a in named.items()])
        func = _norm_agg(func)
        if isinstance(func, str):
            if func in ("size", "nunique", "describe"):
                return getattr(self, func)()
            return self._apply_simple(func)
        if isinstance(func, (list, tuple)):
            return self._run_aggs([(a, self._name, a) for a in func])
        if callable(func):
            return self.apply(func)
        raise TypeError(f"unsupported agg spec {func!r}")

    aggregate = agg

    def quantile(self, q: float = 0.5, interpolation: str = "linear"):
        return self._one(super().quantile(q, interpolation))

    def unique(self):
        """Each group's distinct values in order of appearance (a LIST
        Series)."""
        return self._apply_simple("unique")

    def describe(self) -> DataFrame:
        df = DataFrame._from(Table(self._describe_columns(self._name)),
                             self._result_index(self._group_order()))
        return df if self._as_index else df.reset_index()

    # ------------------------------------------------------------------
    # per row
    # ------------------------------------------------------------------
    def cumsum(self) -> Series:
        return self._per_row_series(super().cumsum())

    def shift(self, periods: int = 1) -> Series:
        return self._per_row_series(super().shift(periods))

    def rank(self, method: str = "average", ascending: bool = True, na_option: str = "keep",
             pct: bool = False) -> Series:
        return self._per_row_series(super().rank(method, ascending, na_option, pct))

    def transform(self, func, *args, **kwargs) -> Series:
        out = super().transform(func, *args, **kwargs)
        return out if isinstance(out, Series) else self._per_row_series(out)

    def ewm(self, com=None, span=None, halflife=None, alpha=None, adjust: bool = True,
            ignore_na: bool = False) -> "_GroupbyEWM":
        if alpha is None:
            if com is not None:
                alpha = 1.0 / (1.0 + com)
            elif span is not None:
                alpha = 2.0 / (span + 1.0)
            elif halflife is not None:
                alpha = 1.0 - 0.5 ** (1.0 / halflife)
            else:
                raise ValueError("ewm needs one of com, span, halflife or alpha")
        return _GroupbyEWM(self, alpha, adjust, ignore_na)


class _GroupbyEWM:
    """``groupby(...)[v].ewm(...)``: ``mean()`` is each row's weighted mean
    within its group (``ops/groupby.py`` ``group_ewma``), the rows group by
    group in output order under a (keys..., label) MultiIndex."""

    def __init__(self, sgb: SeriesGroupBy, alpha: float, adjust: bool, ignore_na: bool):
        self._sgb, self._alpha, self._adjust, self._ignore_na = sgb, alpha, adjust, ignore_na

    def mean(self) -> Series:
        sgb = self._sgb
        g = sgb.grouper
        out = gb_ops.group_ewma(sgb._series._column, g, self._alpha, self._adjust,
                                self._ignore_na)
        kept = sgb._rows_in_group_order()
        rows = g.frame_rows(kept)
        keys = [copying.gather(c, rows, bounds_check=False) for c in sgb._key_cols]
        index = sgb._series.index
        labels = index.take(rows)
        if isinstance(labels, MultiIndex):
            raise NotImplementedError(f"groupby ewm over a MultiIndex: {BEYOND}")
        idx = MultiIndex([*keys, labels.column(sgb._series.device)],
                         [*sgb._key_names, index.name])
        return Series._from(copying.gather(out, kept, bounds_check=False), idx, sgb._name)


def _norm_agg(agg):
    """pandas' ``agg(list)`` and ``agg(set)`` as the aggregations "list"
    and "collect_set"."""
    return "list" if agg is list else "collect_set" if agg is set else agg


def _simple(agg: str):
    def method(self):
        return self._apply_simple(agg)

    method.__name__ = agg
    method.__doc__ = f"groupby {agg} of every value column"
    return method


for _agg in _SIMPLE_AGGS:
    setattr(DataFrameGroupBy, _agg, _simple(_agg))
    setattr(SeriesGroupBy, _agg, _simple(_agg))
