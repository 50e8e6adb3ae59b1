"""Reshapes (port of ``cudf_tpu/frame/reshape.py``): ``concat``,
``get_dummies``, ``melt``, ``pivot_table``, ``pivot``, ``crosstab``,
``stack``, ``unstack`` and ``transpose``, with pandas' results.

Everything runs on the columns' device, and nothing here imports pandas
(the reference pivots, unstacks and stacks through a pandas round trip,
and resets the index on the way).

- ``concat`` appends columns (``ops/copying.py`` ``concatenate``: numeric
  dtypes promoted, dictionaries over different keys unified); a column
  some inputs lack is null there (float64 for an integer column, as
  pandas 3 gives it).  ``axis=1`` aligns the inputs by label.
- ``get_dummies`` is one ``codes == i`` comparison a category: a
  dictionary column's codes over all its keys (pandas' categories), any
  other column's codes from ``ops/dictionary.py`` ``factorize(sort=True)``.
- ``melt`` tiles the id columns, appends the value columns and builds
  ``variable`` as a DICTIONARY32 over the value columns' names (codes by
  ``repeat_interleave``: no host string a row).
- ``pivot_table``, ``pivot``, ``crosstab`` and ``unstack`` group the rows
  by the index keys and by the column keys (``pivot_table`` aggregates
  first, through the groupby tiers), then scatter each value into a dense
  (column group x index group) grid: a missing cell is null, or
  ``fill_value``.  The index keys become the index, the column keys the
  columns (with the value names in front when there are several values,
  or a list of them), both sorted, with pandas' axis names.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import Column, holds
from cudf_tpu_torch.core.table import Table
from cudf_tpu_torch.frame.dataframe import DataFrame
from cudf_tpu_torch.frame.index import Index, MultiIndex, default_index
from cudf_tpu_torch.frame.join import merge  # noqa: F401  (the reference re-exports it)
from cudf_tpu_torch.frame.series import BEYOND, Series, column_of
from cudf_tpu_torch.ops import copying
from cudf_tpu_torch.ops import groupby as gb_ops
from cudf_tpu_torch.ops._utils import materialize_validity, signed_view
from cudf_tpu_torch.ops.replace import nans_to_nulls
from cudf_tpu_torch.ops.unary import cast

HOST_PANDAS = f"{BEYOND}: host pandas routes"


def _names(keys) -> list:
    if keys is None:
        return []
    return list(keys) if isinstance(keys, (list, tuple)) else [keys]


def _device(objs):
    for o in objs:
        if o.device is not None:
            return o.device
    raise ValueError("concat of objects without columns has no device")


# ----------------------------------------------------------------------
# concat
# ----------------------------------------------------------------------

def _missing_like(n: int, like: Column, device) -> Column:
    """n nulls for a column some inputs lack: float64 beside integers (as
    pandas 3 promotes them), else the present column's own dtype."""
    if like.dtype.is_integer:
        return Column.full(n, None, dt.FLOAT64, device=device)
    if like.dtype.is_dictionary:
        return Column.from_dictionary(torch.zeros(n, dtype=torch.int32, device=device),
                                      like.keys, torch.zeros(n, dtype=torch.bool, device=device))
    return Column.full(n, None, like.dtype, device=device)


def _appended(indexes: Sequence[Index], device) -> Index:
    out = indexes[0]
    for idx in indexes[1:]:
        out = out.append(idx, device)
    return out


def _union_in_order(indexes: Sequence[Index], join: str, device) -> Index:
    """The labels of the first index, then each later index's labels not
    yet present (outer), or the first's labels every index holds (inner):
    pandas' union and intersection with ``sort=False``."""
    from cudf_tpu_torch.ops import stream_compaction as sc
    from cudf_tpu_torch.ops.search import contains

    out = indexes[0]
    for idx in indexes[1:]:
        mine, theirs = out.column(device), idx.column(device)
        if join == "inner":
            keep = sc.filter_indices(contains(theirs, mine))
            out = Index(copying.gather(mine, keep, bounds_check=False), out.name)
        else:
            new = sc.filter_indices(~contains(mine, theirs))
            out = Index(copying.concatenate([mine, copying.gather(theirs, new,
                                                                  bounds_check=False)]),
                        out.name if out.name == idx.name else None)
    return out


def _concat_columns(objs, join: str, ignore_index: bool) -> DataFrame:
    """axis=1: the inputs side by side, aligned by label (the labels in
    order of appearance; with ``join="inner"`` those every input holds);
    an unnamed Series is named by a count of the unnamed ones."""
    dev = _device(objs)
    indexes = [o._index for o in objs]
    if all(idx.equals(indexes[0]) for idx in indexes[1:]):
        index = indexes[0]
    else:
        index = _union_in_order(indexes, join, dev)
    labels = None if index is indexes[0] else index.column(dev)
    cols: Dict = {}
    unnamed = 0
    for o in objs:
        parts = [(o.name, o._column)] if isinstance(o, Series) else list(o._table.items())
        for name, col in parts:
            if name is None:
                name, unnamed = unnamed, unnamed + 1
            if name in cols:
                raise ValueError(f"concat(axis=1) gives two columns named {name!r}")
            if labels is not None and not o._index.equals(index):
                col = copying.gather(col, o._index.get_indexer_for(labels, dev),
                                     bounds_check=True)
            cols[name] = col
    if ignore_index:
        cols = dict(zip(range(len(cols)), cols.values()))
    return DataFrame._from(Table(cols), index)


def concat(objs, axis=0, join: str = "outer", ignore_index: bool = False) -> object:
    """pandas' concat of Series and frames on their device: rows (axis 0)
    with the union (``join="outer"``) or intersection (``"inner"``) of the
    columns, or columns side by side (axis 1), aligned by label."""
    objs = [o for o in objs if o is not None]
    if not objs:
        raise ValueError("No objects to concatenate")
    if join not in ("outer", "inner"):
        raise ValueError(f"join={join!r}: 'outer' or 'inner'")
    if axis in (1, "columns"):
        return _concat_columns(objs, join, ignore_index)
    dev = _device(objs)
    n = sum(len(o) for o in objs)
    index = default_index(n) if ignore_index else _appended([o._index for o in objs], dev)
    if all(isinstance(o, Series) for o in objs):
        col = copying.concatenate([o._column for o in objs])
        name = objs[0].name if all(o.name == objs[0].name for o in objs) else None
        return Series._from(col, index, name)
    frames = [o.to_frame() if isinstance(o, Series) else o for o in objs]
    if join == "outer":
        names: List = []
        for f in frames:
            names += [nm for nm in f._table.names if nm not in names]
    else:
        names = [nm for nm in frames[0]._table.names if all(nm in f._table for f in frames)]
    cols = {}
    for nm in names:
        like = next(f._table[nm] for f in frames if nm in f._table)
        cols[nm] = copying.concatenate([f._table[nm] if nm in f._table
                                        else _missing_like(len(f), like, dev) for f in frames])
    return DataFrame._from(Table(cols), index)


# ----------------------------------------------------------------------
# get_dummies, melt
# ----------------------------------------------------------------------

def _categories(col: Column):
    """(int64 codes, the categories as host values): a dictionary's codes
    over all its keys, else factorize's codes over the sorted values."""
    if col.dtype.is_dictionary:
        return col.data.long(), col.keys.to_numpy().tolist()
    from cudf_tpu_torch.ops.dictionary import factorize

    codes, keys = factorize(nans_to_nulls(col), sort=True)
    return codes.long(), keys.to_numpy().tolist()


def get_dummies(data, prefix=None, prefix_sep: str = "_", columns=None, dtype="bool",
                drop_first: bool = False) -> DataFrame:
    """One-hot columns, one ``codes == i`` comparison a category (a
    missing value is False in each), in pandas' layout: the frame's other
    columns first, then each encoded column's categories named
    ``<column><prefix_sep><category>`` (a Series without ``prefix``: the
    categories themselves)."""
    if isinstance(data, Series):
        df, single = data.to_frame(), True
        columns = list(df._table.names)
    else:
        df, single = data, False
        if columns is None:
            columns = [nm for nm, c in df._table.items()
                       if c.dtype.is_string or c.dtype.is_dictionary]
    target = dt.dtype(dtype) if dtype is not None else dt.BOOL8
    out = {nm: c for nm, c in df._table.items() if nm not in columns}
    for i, nm in enumerate(columns):
        col = df._table[nm]
        codes, cats = _categories(col)
        valid = materialize_validity(nans_to_nulls(col))
        if isinstance(prefix, dict):
            pfx = prefix.get(nm, nm)
        elif isinstance(prefix, (list, tuple)):
            pfx = prefix[i]
        else:
            pfx = prefix if prefix is not None else (None if single else nm)
        for ci in range(1 if drop_first else 0, len(cats)):
            hot = Column(dt.BOOL8, col.length, (codes == ci) & valid)
            if target != dt.BOOL8:
                from cudf_tpu_torch.ops.unary import cast

                hot = cast(hot, target)
            out[cats[ci] if pfx is None else f"{pfx}{prefix_sep}{cats[ci]}"] = hot
    return DataFrame._from(Table(out), df._index)


def melt(frame: DataFrame, id_vars=None, value_vars=None, var_name=None,
         value_name: str = "value") -> DataFrame:
    """Wide to long: each value column's rows in turn under the id
    columns (tiled), ``variable`` a DICTIONARY32 over the value columns'
    names (``to_pandas`` gives it as a Categorical of pandas' values) and
    ``value`` their rows appended, under a fresh RangeIndex."""
    id_vars = _names(id_vars)
    value_vars = [nm for nm in frame._table.names if nm not in id_vars] if value_vars is None \
        else _names(value_vars)
    k, n, dev = len(value_vars), len(frame), frame.device
    out = {iv: copying.tile(frame._table[iv], k) for iv in id_vars}
    codes = torch.arange(k, dtype=torch.int32, device=dev).repeat_interleave(n)
    out[var_name or "variable"] = Column.from_dictionary(
        codes, Column.from_pylist(list(value_vars), device=dev))
    out[value_name] = copying.concatenate([frame._table[v] for v in value_vars])
    return DataFrame._from(Table(out), default_index(n * k))


# ----------------------------------------------------------------------
# the grid: pivot_table, pivot, crosstab, unstack
# ----------------------------------------------------------------------

def _labels_index(cols: List[Column], names: List) -> Index:
    return Index(cols[0], names[0]) if len(cols) == 1 else MultiIndex(cols, names)


def _fill(value, like: Column):
    if not holds(like.dtype, value):
        raise TypeError(f"fill_value {value!r} for a {like.dtype!r} column")
    return value


def _spread(row_keys: List[Column], row_names: List, col_keys: List[Column],
            col_names: List, values: Dict, multi: bool, fill_value=None,
            unique: bool = False) -> DataFrame:
    """The grid: the rows (each (row key, column key) pair at most once;
    with ``unique`` a repeated pair raises, as pandas' reshape does) as
    cells of a (column group x row group) grid of each value, both key
    sets grouped in ascending order.  Columns are named by the column key
    (a tuple of several), with the value's name in front when ``multi``."""
    rg = gb_ops.make_grouper(row_keys, dropna=False)
    cg = gb_ops.make_grouper(col_keys, dropna=False)
    R, C = rg.num_groups, cg.num_groups
    pos = cg.group_ids * R + rg.group_ids
    if unique and pos.shape[0] and int(torch.bincount(pos, minlength=R * C).max()) > 1:
        raise ValueError("Index contains duplicate entries, cannot reshape")
    index = _labels_index([copying.gather(k, rg.key_rows, bounds_check=False)
                           for k in row_keys], row_names)
    heads = [copying.gather(k, cg.key_rows, bounds_check=False).to_numpy().tolist()
             for k in col_keys]
    heads = heads[0] if len(col_keys) == 1 else list(zip(*heads))
    out = {}

    def label(vname, j):
        key = heads[j] if len(col_keys) == 1 else tuple(heads[j])
        return ((vname,) + (key if isinstance(key, tuple) else (key,))) if multi else key

    for vname, col in values.items():
        if col.dtype.is_string:             # the rows gathered into the cells, null where none
            cell = torch.full((R * C,), -1, dtype=torch.int64, device=col.device)
            cell[pos] = torch.arange(col.length, device=col.device)
            grid = copying.gather(col, cell)
            if fill_value is not None:
                grid = copying.copy_if_else(materialize_validity(grid), grid, fill_value)
            for j in range(len(heads)):
                out[label(vname, j)] = copying.slice(grid, j * R, (j + 1) * R)
            continue
        data = torch.zeros(R * C, dtype=col.data.dtype, device=col.device)
        valid = torch.zeros(R * C, dtype=torch.bool, device=col.device)
        signed_view(data)[pos] = signed_view(col.data)
        valid[pos] = materialize_validity(col)
        if fill_value is not None:
            data = torch.where(valid, data, torch.tensor(_fill(fill_value, col),
                                                         dtype=data.dtype, device=data.device))
        full = valid.view(C, R).all(1).tolist()       # one host read for every column
        dtype = col.dtype
        if fill_value is None and not all(full) and dtype.is_integer:
            # pandas' unstack makes the whole block float64 when a cell is missing
            data, dtype = data.double(), dt.FLOAT64
        for j in range(len(heads)):
            cell = valid[j * R:(j + 1) * R]
            out[label(vname, j)] = Column(dtype, R, data[j * R:(j + 1) * R],
                                          None if fill_value is not None or full[j] else cell,
                                          children=col.children)
    res = DataFrame._from(Table(out), index)
    res._columns_names = tuple(([None] if multi else []) + list(col_names))
    return res


def _agg_name(aggfunc) -> str:
    if isinstance(aggfunc, str):
        return aggfunc
    raise NotImplementedError(f"pivot_table(aggfunc={aggfunc!r}): a name of a groupby "
                              f"aggregation; {BEYOND}")


def pivot_table(frame: DataFrame, values=None, index=None, columns=None, aggfunc="mean",
                fill_value=None) -> DataFrame:
    """pandas' pivot_table: the groupby of the index and column keys
    (sorted, null keys dropped; the port's tiers: one-hot, radix or sort),
    then the grid of each value.  Without ``columns`` the aggregated frame
    itself, indexed by the index keys, its value columns sorted."""
    index, columns = _names(index), _names(columns)
    if not index:
        raise NotImplementedError(f"pivot_table without index keys: {BEYOND}")
    multi = isinstance(values, (list, tuple))
    if values is None:
        multi = True
        values = [nm for nm, c in frame._table.items() if nm not in index + columns
                  and (c.dtype.is_numeric or c.dtype.is_bool)]
    values = _names(values)
    agg = frame.groupby(index + columns, sort=True).agg({v: _agg_name(aggfunc) for v in values})
    try:
        values = sorted(values)
    except TypeError:
        pass
    if not columns:
        res = DataFrame._from(agg._table.select(values), agg._index)
        return res.fillna(fill_value) if fill_value is not None else res
    idx = agg._index
    keys = list(idx._columns) if isinstance(idx, MultiIndex) else [idx.column(agg.device)]
    k = len(index)
    return _spread(keys[:k], index, keys[k:], columns,
                   {v: agg._table[v] for v in values}, multi or len(values) > 1, fill_value)


def pivot(frame: DataFrame, index=None, columns=None, values=None) -> DataFrame:
    """pandas' pivot: no aggregation, each (index, columns) pair at most
    once (else ValueError); ``index=None`` takes the frame's index."""
    columns = _names(columns)
    if index is None:
        idx = frame._index
        row_keys = list(idx._columns) if isinstance(idx, MultiIndex) else [
            idx.column(frame.device)]
        row_names = list(idx.names) if isinstance(idx, MultiIndex) else [idx.name]
    else:
        row_names = _names(index)
        row_keys = [frame._table[nm] for nm in row_names]
    multi = values is None or isinstance(values, (list, tuple))
    vals = [nm for nm in frame._table.names if nm not in row_names + columns] \
        if values is None else _names(values)
    return _spread(row_keys, row_names, [frame._table[c] for c in columns], columns,
                   {v: frame._table[v] for v in vals}, multi, unique=True)


def crosstab(index, columns, values=None, rownames=None, colnames=None, aggfunc=None):
    """pandas' crosstab of two Series (aligned by label): the count of
    each (index value, column value) pair, 0 where a pair never occurs;
    with ``values`` and ``aggfunc``, that aggregation of them (missing
    cells null).  The axes are named after the Series (``row_0``,
    ``col_0`` when unnamed)."""
    rn = (rownames or [None])[0] if isinstance(rownames, (list, tuple)) else rownames
    cn = (colnames or [None])[0] if isinstance(colnames, (list, tuple)) else colnames
    rn = rn if rn is not None else (index.name if index.name is not None else "row_0")
    cn = cn if cn is not None else (columns.name if columns.name is not None else "col_0")
    if not index._index.equals(columns._index):
        columns = Series._from(copying.gather(columns._column, columns._index.get_indexer_for(
            index._index.column(index.device), index.device), bounds_check=True),
            index._index, columns.name)
    data = {rn: index._column, cn: columns._column}
    if values is not None:
        data["__values__"] = column_of(values, index.device)
        df = DataFrame._from(Table(data), index._index)
        out = pivot_table(df, values="__values__", index=rn, columns=cn,
                          aggfunc=aggfunc or "mean")
        return out
    df = DataFrame._from(Table(data), index._index)
    size = df.groupby([rn, cn], sort=True).size()
    lv = size._index._columns
    return _spread([lv[0]], [rn], [lv[1]], [cn], {None: size._column}, False, fill_value=0)


def unstack(obj, level=-1, fill_value=None) -> DataFrame:
    """A MultiIndex level moved into the columns: a Series gives a column
    for each of the level's values, a frame a (column, value) pair for
    each; the remaining levels are the index; both sorted, as pandas."""
    idx = obj._index
    if not isinstance(idx, MultiIndex):
        raise NotImplementedError(f"unstack of a single-level index: {BEYOND}")
    names = list(idx.names)
    lv = level if isinstance(level, int) else names.index(level)
    lv = lv % len(names)
    rows = [i for i in range(len(names)) if i != lv]
    if isinstance(obj, Series):
        values, multi = {obj.name: obj._column}, False
    else:
        values, multi = dict(obj._table.items()), True
    res = _spread([idx._columns[i] for i in rows], [names[i] for i in rows],
                  [idx._columns[lv]], [names[lv]], values, multi, fill_value, unique=True)
    if multi and obj._columns_names is not None:
        res._columns_names = tuple(obj._columns_names) + (names[lv],)
    return res


# ----------------------------------------------------------------------
# stack, transpose
# ----------------------------------------------------------------------

def _common_numeric_dtype(frame: DataFrame, what: str) -> dt.DType:
    """The dtype a stack or transpose gives: the numeric columns' common
    dtype (numpy's promotion, as pandas), or the one dtype of bool
    columns; other frames take pandas on the host in the reference."""
    dtypes = [c.dtype for c in frame._table.columns]
    if dtypes and all(d.is_numeric for d in dtypes):
        out = dtypes[0]
        for d in dtypes[1:]:
            out = dt.common_dtype(out, d)
        return out
    if dtypes and all(d == dt.BOOL8 for d in dtypes):
        return dt.BOOL8
    raise NotImplementedError(f"{what} of a frame of mixed or non-numeric columns: "
                              f"{HOST_PANDAS}")


def stack(frame: DataFrame) -> Series:
    """The columns as a last index level, row by row (pandas 3's stack:
    missing values kept), for a numeric or bool frame."""
    d = _common_numeric_dtype(frame, "stack")
    n, k, dev = len(frame), frame._table.num_columns, frame.device
    values = copying.interleave_columns([cast(c, d) for c in frame._table.columns])
    rows = torch.arange(n, device=dev).repeat_interleave(k)
    idx = frame._index.take(rows)
    levels = list(idx._columns) if isinstance(idx, MultiIndex) else [idx.column(dev)]
    names = list(idx.names) if isinstance(idx, MultiIndex) else [idx.name]
    heads = copying.tile(Column.from_pylist(list(frame._table.names), device=dev), n)
    return Series._from(values, MultiIndex(levels + [heads], names + [None]))


def transpose(frame: DataFrame) -> DataFrame:
    """Rows as columns for a numeric or bool frame (a stack of the column
    buffers in their common dtype, read back by row, on the device): the columns
    are named by the index labels, the index holds the column names."""
    d = _common_numeric_dtype(frame, "transpose")
    dev = frame.device
    cols = [cast(c, d) for c in frame._table.columns]
    data = torch.stack([c.data for c in cols], 1)
    valid = None
    if any(c.validity is not None for c in cols):
        valid = torch.stack([materialize_validity(c) for c in cols], 1)
    labels = frame._index.to_pylist()
    out = {lab: Column(d, len(cols), data[i].contiguous(),
                       None if valid is None else valid[i].contiguous())
           for i, lab in enumerate(labels)}
    if len(out) != len(labels):
        raise ValueError("transpose of a frame with duplicate index labels")
    return DataFrame._from(Table(out), Index(Column.from_pylist(list(frame._table.names),
                                                                device=dev)))


__all__ = ["concat", "crosstab", "get_dummies", "melt", "merge", "pivot", "pivot_table",
           "stack", "transpose", "unstack"]
