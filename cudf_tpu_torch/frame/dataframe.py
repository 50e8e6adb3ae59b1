"""DataFrame (port of ``cudf_tpu/frame/dataframe.py``: construction
from tensors, numpy arrays (numeric, temporal, strings), lists and
Categoricals, pandas round trip, column access, ``take``, ``head``, ``sort_values``,
``sort_index``, ``drop_duplicates``, ``groupby``, ``merge`` (every join
type) and ``reset_index``, of some index levels too).

A frame lives where its tensors live.  Host data (numpy arrays, pandas
frames) needs an explicit ``device=``; nothing picks one by looking for
a GPU.  pandas is imported only inside ``to_pandas``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.core.table import Table
from cudf_tpu_torch.frame.index import Index, MultiIndex, RangeIndex, default_index
from cudf_tpu_torch.frame.series import Series
from cudf_tpu_torch.ops import copying
from cudf_tpu_torch.ops import sort as sort_ops
from cudf_tpu_torch.ops import stream_compaction as sc
from cudf_tpu_torch.ops.replace import nans_to_nulls


def _on(have: torch.device, want: torch.device) -> bool:
    """Whether a tensor on ``have`` is on ``want`` ("cuda" names the
    current card, as torch.device("cuda") does)."""
    if have.type != want.type:
        return False
    index = want.index if want.index is not None or want.type != "cuda" \
        else torch.cuda.current_device()
    return have.index == index


def _as_column(value, device) -> Column:
    if isinstance(value, Series):
        value = value._column
    if isinstance(value, Column):
        col = value
    elif isinstance(value, torch.Tensor):
        col = Column.from_tensor(value)
    elif isinstance(value, (np.ndarray, list)):
        if device is None:
            raise ValueError("a host column needs an explicit device=")
        if isinstance(value, list):
            return Column.from_pylist(value, device=device)
        return Column.from_numpy(value, device=device)
    elif type(value).__name__ == "Categorical":
        if device is None:
            raise ValueError("a host column needs an explicit device=")
        import pandas as pd

        return Column.from_pandas(pd.Series(value), device=device)
    else:
        raise TypeError(f"cannot build a column from {type(value).__name__}")
    if device is not None and not _on(col.device, torch.device(device)):
        raise ValueError(f"column is on {col.device}, frame asked for {device}")
    return col


class DataFrame:
    def __init__(self, data: Optional[Dict] = None, index: Optional[Index] = None,
                 *, device=None):
        """data: {name: torch.Tensor | numpy array | list | pandas
        Categorical | Column | Series}.  Tensors and columns stay on their
        device; host data (numeric, bool, datetime64 / timedelta64, str or
        object strings, Categoricals as dictionary columns) goes to
        ``device``, which it requires."""
        self._table = Table({k: _as_column(v, device) for k, v in (data or {}).items()})
        self._index = index if index is not None else default_index(self._table.num_rows)
        if self._table.num_columns and len(self._index) != self._table.num_rows:
            raise ValueError("index length mismatch")

    @classmethod
    def _from(cls, table: Table, index: Index) -> "DataFrame":
        df = cls.__new__(cls)
        df._table = table
        df._index = index
        return df

    @property
    def index(self) -> Index:
        return self._index

    @property
    def device(self) -> Optional[torch.device]:
        return self._table.column(0).device if self._table.num_columns else None

    def __len__(self) -> int:
        return self._table.num_rows

    # ------------------------------------------------------------------
    # pandas round trip
    # ------------------------------------------------------------------
    @classmethod
    def from_pandas(cls, pdf, *, device) -> "DataFrame":
        """numpy-backed numeric, bool and temporal columns, strings and
        Categoricals onto ``device``; NaN in a float column and NaT are
        nulls.  A non-range index becomes an Index."""
        cols = {name: Column.from_pandas(pdf.iloc[:, i], device=device)
                for i, name in enumerate(pdf.columns)}
        pidx = pdf.index
        if type(pidx).__name__ == "RangeIndex":
            index = RangeIndex(pidx.start, pidx.stop, pidx.step, name=pidx.name)
        else:
            index = Index(Column.from_numpy(np.asarray(pidx), device=device),
                          name=pidx.name)
        return cls._from(Table(cols), index)

    def to_pandas(self):
        import pandas as pd

        data = {n: c.to_pandas_array() for n, c in self._table.items()}
        return pd.DataFrame(data, index=self._index.to_pandas())

    # ------------------------------------------------------------------
    # access
    # ------------------------------------------------------------------
    def __getitem__(self, key):
        if isinstance(key, list):
            return DataFrame._from(self._table.select(key), self._index)
        return Series._from(self._table[key], self._index, key)

    def reset_index(self, level=None, drop: bool = False) -> "DataFrame":
        """The index becomes the first columns (a MultiIndex one a level),
        named after it (or "index", "level_<i>"), unless drop; the new
        index is a RangeIndex.  ``level`` (names or positions) resets
        only those levels of a MultiIndex: the others stay the index.
        Beside (column, agg) tuple names a new name is padded like
        pandas' MultiIndex columns: ("k", "")."""
        index = default_index(len(self))
        if isinstance(self._index, MultiIndex):
            levels = [(name if name is not None else f"level_{i}", col)
                      for i, (name, col) in enumerate(zip(self._index.names,
                                                          self._index._columns))]
            if level is not None:
                names = list(self._index.names)
                sel = {names[lv] if isinstance(lv, int) else lv
                       for lv in (level if isinstance(level, (list, tuple)) else [level])}
                keep = [(c, n) for c, n in zip(self._index._columns, names) if n not in sel]
                levels = [lv for lv, n in zip(levels, names) if n in sel]
                if len(keep) == 1:
                    index = Index(keep[0][0], name=keep[0][1])
                elif keep:
                    index = MultiIndex([c for c, _ in keep], [n for _, n in keep])
        else:
            name = self._index.name if self._index.name is not None else "index"
            levels = [(name, self._index.column(self.device))]
        if drop:
            return DataFrame._from(self._table, index)
        widths = {len(n) for n in self._table.names if isinstance(n, tuple)}
        table = self._table
        for loc, (name, col) in enumerate(levels):
            if widths:
                name = (name,) + ("",) * (max(widths) - 1)
            table = table.insert(name, col, loc=loc)
        return DataFrame._from(table, index)

    # ------------------------------------------------------------------
    # row selection, sorting, dedup
    # ------------------------------------------------------------------
    def take(self, indices: torch.Tensor) -> "DataFrame":
        """The rows at these positions (int64), with their index labels."""
        indices = indices.long()
        return DataFrame._from(copying.gather_table(self._table, indices, bounds_check=False),
                               self._index.take(indices))

    def head(self, n: int = 5) -> "DataFrame":
        """The first n rows (all but the last -n when n < 0)."""
        n = len(self) + n if n < 0 else n
        n = max(0, min(n, len(self)))
        table = Table({name: copying.slice(c, 0, n) for name, c in self._table.items()})
        return DataFrame._from(table, self._index.slice(0, n))

    def sort_values(self, by, ascending=True, na_position: str = "last",
                    ignore_index: bool = False, kind=None) -> "DataFrame":
        """A stable lexicographic sort by the named columns (any ``kind``
        gives the stable order); NaN sorts as null, at ``na_position``
        whatever the direction."""
        by = [by] if not isinstance(by, (list, tuple)) else list(by)
        asc = [ascending] * len(by) if isinstance(ascending, bool) else list(ascending)
        keys = [nans_to_nulls(self._table[name]) for name in by]
        out = self.take(sort_ops.sorted_order(keys, asc, na_position))
        if ignore_index:
            out._index = default_index(len(out))
        return out

    def sort_index(self, ascending: bool = True) -> "DataFrame":
        idx = self._index
        cols = list(idx._columns) if isinstance(idx, MultiIndex) else [idx.column(self.device)]
        return self.take(sort_ops.sorted_order(cols, [ascending] * len(cols), "last"))

    def drop_duplicates(self, subset=None, keep="first",
                        ignore_index: bool = False) -> "DataFrame":
        """The first (last; none when keep=False) row of each distinct
        combination of the subset's values, in row order."""
        names = ([subset] if subset is not None and not isinstance(subset, (list, tuple))
                 else list(subset or self._table.names))
        out = self.take(sc.distinct_indices([self._table[n] for n in names],
                                            keep if keep is not False else "none"))
        if ignore_index:
            out._index = default_index(len(out))
        return out

    def merge(self, right, on=None, how="inner", left_on=None, right_on=None,
              left_index=False, right_index=False, suffixes=("_x", "_y"), sort=False):
        """Join with ``right`` (see ``frame/join.py``): inner, left,
        right, outer, cross, semi and anti, on columns or both indexes."""
        from cudf_tpu_torch.frame.join import merge as _merge

        return _merge(self, right, on=on, how=how, left_on=left_on, right_on=right_on,
                      left_index=left_index, right_index=right_index,
                      suffixes=suffixes, sort=sort)

    def groupby(self, by, sort: bool = True, dropna: bool = True, as_index: bool = True,
                observed: bool = True):
        """Group by one key column or a list of them (see
        ``frame/groupby.py``)."""
        from cudf_tpu_torch.frame.groupby import DataFrameGroupBy

        return DataFrameGroupBy(self, by, sort=sort, dropna=dropna, as_index=as_index,
                                observed=observed)

    def __repr__(self) -> str:
        cols = ", ".join(f"{n}: {c.dtype!r}" for n, c in self._table.items())
        return f"DataFrame[{len(self)} rows on {self.device}]({cols})"
