"""DataFrame merge with pandas semantics, for inner joins (port of
``cudf_tpu/frame/join.py`` ``merge``).

The key columns are given by ``on`` (emitted once, from the left), or by
``left_on`` / ``right_on`` (both emitted, except a pair that names the
same column on both sides: that key is emitted once, from the left, as
pandas does).  Other columns whose names
appear on both sides get ``suffixes``.  Rows come in left-row order, with
right-row order inside each left row, under a fresh RangeIndex.  Other
``how`` values, ``sort=True`` and index joins need the sort-merge and
sort tiers, which are not ported yet: they raise NotImplementedError.
"""

from __future__ import annotations

from typing import Tuple

from cudf_tpu_torch.core.table import Table
from cudf_tpu_torch.frame.dataframe import DataFrame
from cudf_tpu_torch.frame.index import default_index
from cudf_tpu_torch.ops import copying
from cudf_tpu_torch.ops import join as join_ops


def _names(keys):
    return [keys] if isinstance(keys, str) else list(keys)


def merge(left: DataFrame, right: DataFrame, on=None, how: str = "inner",
          left_on=None, right_on=None, left_index: bool = False,
          right_index: bool = False, suffixes: Tuple[str, str] = ("_x", "_y"),
          sort: bool = False) -> DataFrame:
    if how != "inner" or sort or left_index or right_index:
        raise NotImplementedError(join_ops.SORT_MERGE_MISSING)
    if on is not None:
        lnames = rnames = _names(on)
        key_names = set(lnames)
    elif left_on is not None and right_on is not None:
        lnames, rnames = _names(left_on), _names(right_on)
        # a key that names the same column on both sides comes out once
        key_names = {a for a, b in zip(lnames, rnames) if a == b}
    else:
        raise NotImplementedError("merge needs on= or both left_on= and right_on= "
                                  "(keys from the common columns are not ported yet)")
    li, ri = join_ops.inner_join([left._table[k] for k in lnames],
                                 [right._table[k] for k in rnames])
    left_names, right_names = set(left._table.names), set(right._table.names)
    out = {}
    for n, col in left._table.items():
        name = f"{n}{suffixes[0]}" if n in right_names and n not in key_names else n
        out[name] = copying.gather(col, li, bounds_check=True)
    for n, col in right._table.items():
        if n in key_names and n in left_names:
            continue                                   # the key, emitted from the left
        name = f"{n}{suffixes[1]}" if n in left_names else n
        out[name] = copying.gather(col, ri, bounds_check=True)
    return DataFrame._from(Table(out), default_index(li.shape[0]))
