"""DataFrame merge with pandas semantics (port of
``cudf_tpu/frame/join.py`` ``merge``) over ``ops/join.py``'s gather maps.

- ``how``: inner, left, right, outer (or full), cross, and the
  reference's semi (leftsemi) and anti (leftanti), which return the left
  rows with (without) a match under their own index labels.
- Keys: ``on``, ``left_on`` with ``right_on``, the index on both sides
  (``left_index`` and ``right_index``), or else the columns both sides
  share.  A key may name an index level instead of a column; the levels
  used become columns first.
- A key given by ``on`` (or a ``left_on`` / ``right_on`` pair naming the
  same column on both sides) comes out once, from the left; an outer or
  right join fills its nulls from the right side's key.  Other columns
  whose names appear on both sides get ``suffixes``.
- Null keys match null keys, as in pandas.  Rows come in left-row order,
  with right-row order inside each left row (a right join the other way
  round; an outer join appends the unmatched right rows), under a fresh
  RangeIndex, or the joined index when both sides join on theirs.
  ``sort=True`` orders the rows by the keys (stably).

``join`` is pandas' ``DataFrame.join``: the left frame's ``on`` column,
or its index, against the other frame's index, over the same gather maps
(an inner join reaches the same kernel tiers as ``merge``).  It keeps the
left frame's index labels (the other's for ``how="right"``), puts the
columns both sides hold under ``lsuffix`` and ``rsuffix``, and sorts an
outer join by the key, as pandas does.
"""

from __future__ import annotations

from typing import Tuple

from cudf_tpu_torch.core.table import Table
from cudf_tpu_torch.frame.dataframe import DataFrame
from cudf_tpu_torch.frame.index import Index, MultiIndex, default_index
from cudf_tpu_torch.frame.series import BEYOND, Series
from cudf_tpu_torch.ops import copying
from cudf_tpu_torch.ops import join as join_ops
from cudf_tpu_torch.ops.replace import replace_nulls_column


def _names(keys):
    if keys is None:
        return []
    return [keys] if isinstance(keys, str) else list(keys)


def _materialize_levels(df: DataFrame, keys) -> DataFrame:
    """The index levels that ``keys`` name (and no column does) as columns."""
    missing = [k for k in keys if k not in df._table.names]
    idx = df._index
    idx_names = [n for n in (idx.names if isinstance(idx, MultiIndex) else [idx.name])
                 if n is not None]
    used = [k for k in missing if k in idx_names]
    if not used:
        return df
    return df.reset_index(level=used if len(used) != len(idx_names) else None)


def _index_column(df: DataFrame):
    if isinstance(df._index, MultiIndex):
        raise NotImplementedError(f"a join on a MultiIndex of several levels: {BEYOND}")
    return df._index.column(df.device)


def merge(left: DataFrame, right: DataFrame, on=None, how: str = "inner",
          left_on=None, right_on=None, left_index: bool = False,
          right_index: bool = False, suffixes: Tuple[str, str] = ("_x", "_y"),
          sort: bool = False) -> DataFrame:
    how = "outer" if how == "full" else how
    if how not in ("inner", "left", "right", "outer", "cross", "semi", "leftsemi", "anti",
                   "leftanti"):
        raise ValueError(f"unknown how={how!r}")
    both_index = left_index and right_index
    key_union = _names(on) + _names(left_on) + _names(right_on)
    if key_union and not both_index:
        left, right = _materialize_levels(left, key_union), _materialize_levels(right, key_union)
    left_names, right_names = set(left._table.names), set(right._table.names)
    if how == "cross":
        if key_union or left_index or right_index:
            raise ValueError("a cross merge takes no on, left_on, right_on, left_index "
                             "or right_index")
        device = left.device or right.device
        if device is None:
            raise ValueError("a cross merge of two frames without columns has no device")
        li, ri = join_ops.cross_join(len(left), len(right), device=device)
        out = {}
        for n, col in left._table.items():
            out[f"{n}{suffixes[0]}" if n in right_names else n] = copying.gather(
                col, li, bounds_check=False)
        for n, col in right._table.items():
            out[f"{n}{suffixes[1]}" if n in left_names else n] = copying.gather(
                col, ri, bounds_check=False)
        return DataFrame._from(Table(out), default_index(li.shape[0]))

    if left_index != right_index:
        raise NotImplementedError(f"a merge of one side's index with the other side's "
                                  f"columns: {BEYOND}")
    if both_index:
        lkeys, rkeys = [_index_column(left)], [_index_column(right)]
        lnames, key_names = [], set()
    else:
        if on is not None:
            lnames = rnames = _names(on)
            key_names = set(lnames)
        elif left_on is not None and right_on is not None:
            lnames, rnames = _names(left_on), _names(right_on)
            # a key that names the same column on both sides comes out once
            key_names = {a for a, b in zip(lnames, rnames) if a == b}
        elif left_on is None and right_on is None:
            lnames = rnames = [n for n in left._table.names if n in right_names]
            if not lnames:
                raise ValueError("no common columns to merge on")
            key_names = set(lnames)
        else:
            raise ValueError("left_on and right_on go together")
        lkeys = [left._table[k] for k in lnames]
        rkeys = [right._table[k] for k in rnames]

    if how in ("semi", "leftsemi"):
        return left.take(join_ops.semi_join(lkeys, rkeys))
    if how in ("anti", "leftanti"):
        return left.take(join_ops.anti_join(lkeys, rkeys))
    if how == "right":
        ri, li = join_ops.left_join(rkeys, lkeys)
    else:
        li, ri = join_ops._join(lkeys, rkeys, how)
    coalesce = how in ("outer", "right")
    # a side's map holds -1 (no match: null) only where the join keeps the
    # other side's unmatched rows; elsewhere its gathers need no check
    l_nulls, r_nulls = how in ("outer", "right"), how in ("outer", "left")
    out = {}
    for n, col in left._table.items():
        col = copying.gather(col, li, bounds_check=l_nulls)
        if coalesce and n in key_names and n in right_names:
            col = replace_nulls_column(col, copying.gather(right._table[n], ri,
                                                           bounds_check=True))
        out[f"{n}{suffixes[0]}" if n in right_names and n not in key_names else n] = col
    for n, col in right._table.items():
        if n in key_names and n in left_names:
            continue                                   # the key, emitted from the left
        name = f"{n}{suffixes[1]}" if n in left_names else n
        out[name] = copying.gather(col, ri, bounds_check=r_nulls)
    if both_index:
        idx = copying.gather(lkeys[0], li, bounds_check=l_nulls)
        if coalesce:
            idx = replace_nulls_column(idx, copying.gather(rkeys[0], ri, bounds_check=True))
        index = Index(idx, name=left._index.name)
    else:
        index = default_index(li.shape[0])
    res = DataFrame._from(Table(out), index)
    if not sort:
        return res
    if both_index:
        return res.sort_index()
    keys = [k for k in lnames if k in res._table.names]
    return res.sort_values(keys, ignore_index=True) if keys else res


def join(left: DataFrame, other, on=None, how: str = "left", lsuffix: str = "",
         rsuffix: str = "", sort: bool = False) -> DataFrame:
    """pandas' ``DataFrame.join``: ``on`` (a column of ``left``) or
    ``left``'s index against ``other``'s index.  Rows come in left-row
    order (right-row order for ``how="right"``; an outer join sorted by
    the key) under the left index's labels, null where a row has no left
    side (the other's labels for an index join with ``how="right"``)."""
    if isinstance(other, Series):
        other = other.to_frame()
    if how not in ("inner", "left", "right", "outer"):
        raise ValueError(f"unknown how={how!r}")
    rkey = _index_column(other)
    if on is not None:
        on = _names(on)
        if len(on) != 1:
            raise NotImplementedError(f"a join of several columns on a MultiIndex: {BEYOND}")
        lkey = left._table[on[0]]
    else:
        lkey = _index_column(left)
    overlap = [n for n in left._table.names if n in other._table]
    if overlap and not (lsuffix or rsuffix):
        raise ValueError(f"columns overlap but no suffix specified: {overlap}")
    if how == "right":
        ri, li = join_ops.left_join([rkey], [lkey])
    else:
        li, ri = join_ops._join([lkey], [rkey], how)
    l_nulls, r_nulls = how in ("outer", "right"), how in ("outer", "left")
    key = copying.gather(lkey, li, bounds_check=l_nulls)
    if l_nulls:                                       # a row without a left side: other's key
        key = replace_nulls_column(key, copying.gather(rkey, ri, bounds_check=True))
    out = {}
    for n, col in left._table.items():
        col = key if on is not None and n == on[0] else copying.gather(col, li,
                                                                       bounds_check=l_nulls)
        out[f"{n}{lsuffix}" if n in overlap else n] = col
    for n, col in other._table.items():
        out[f"{n}{rsuffix}" if n in overlap else n] = copying.gather(col, ri,
                                                                     bounds_check=r_nulls)
    if on is not None:
        index = left._index.take(li) if not l_nulls else Index(
            copying.gather(left._index.column(left.device), li, bounds_check=True),
            left._index.name)
    else:
        lname, rname = left._index.name, other._index.name
        name = {"left": lname, "right": rname}.get(how, lname if lname == rname else None)
        index = Index(key, name)
    res = DataFrame._from(Table(out), index)
    if how == "outer" or sort:
        from cudf_tpu_torch.ops import sort as sort_ops

        res = res.take(sort_ops.sorted_order([key]))
    return res
