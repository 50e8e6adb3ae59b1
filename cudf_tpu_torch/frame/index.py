"""Index, RangeIndex and MultiIndex (port of ``cudf_tpu/frame/index.py``:
the labels of rows, what alignment, ``loc`` and groupby results need).

A RangeIndex stays lazy: no buffer until a column is asked for, on a
device the caller names; its lookups are arithmetic.  ``equals`` first
asks whether the two are one object (or two RangeIndexes of one range),
so an operator between two columns of one frame compares no labels and
does not sync the host.  A filter of a RangeIndex by a mask gives an
Index of the kept int64 positions, on their device.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.ops import copying
from cudf_tpu_torch.utils import tracing


def label_column(labels, device) -> Column:
    """Labels (an Index, Column, tensor, scalar or host list) as a column."""
    if isinstance(labels, Index):
        return labels.column(device)
    if isinstance(labels, Column):
        return labels
    if isinstance(labels, torch.Tensor):
        return Column.from_tensor(labels.reshape(-1))
    if device is None:
        raise ValueError("host labels need an explicit device=")
    if isinstance(labels, np.ndarray):
        return Column.from_numpy(labels, device=device)
    if np.isscalar(labels) or labels is None:
        labels = [labels]
    return Column.from_pylist(list(labels), device=device)


class Index:
    def __init__(self, column: Column, name=None):
        self._column = column
        self.name = name

    # ------------------------------------------------------------------
    # attributes
    # ------------------------------------------------------------------
    @property
    def dtype(self):
        return self._column.dtype

    @property
    def device(self) -> Optional[torch.device]:
        return self._column.device

    def __len__(self) -> int:
        return self._column.length

    @property
    def size(self) -> int:
        return len(self)

    @property
    def nlevels(self) -> int:
        return 1

    @property
    def values(self):
        return self.to_numpy()

    def column(self, device: Optional[torch.device] = None) -> Column:
        return self._column

    def to_numpy(self):
        return self._column.to_numpy()

    def to_pylist(self):
        return self.to_numpy().tolist()

    def __iter__(self):
        return iter(self.to_pylist())

    def to_pandas(self):
        import pandas as pd

        return pd.Index(self._column.to_pandas_array(), name=self.name)

    def __repr__(self):
        return f"Index({self._column!r}, name={self.name!r})"

    def copy(self) -> "Index":
        return Index(self._column, self.name)

    def rename(self, name) -> "Index":
        out = self.copy()
        out.name = name
        return out

    # ------------------------------------------------------------------
    # positions
    # ------------------------------------------------------------------
    def take(self, indices: torch.Tensor) -> "Index":
        return Index(copying.gather(self._column, indices, bounds_check=False), self.name)

    def slice(self, start: int, stop: int) -> "Index":
        return Index(copying.slice(self._column, start, stop), self.name)

    def __getitem__(self, i):
        if isinstance(i, slice):
            start, stop, step = i.indices(len(self))
            if step == 1:
                return self.slice(start, stop)
            return self.take(torch.arange(start, stop, step, device=self.device))
        return copying.get_element(self._column, int(i))

    def append(self, other: "Index", device=None) -> "Index":
        """The labels of both, in order (numeric dtypes promoted, strings
        beside a dictionary decoded), on ``device`` (by default the first
        that either index has); the name when both share it."""
        if isinstance(other, MultiIndex):
            raise TypeError("append of a MultiIndex to an Index")
        dev = device or self.device or other.device
        cols = [self.column(dev), other.column(dev)]
        if len({c.dtype.is_dictionary for c in cols}) > 1:
            cols = [c.decode_dictionary() for c in cols]
        return Index(copying.concatenate(cols), self.name if self.name == other.name else None)

    # ------------------------------------------------------------------
    # comparisons and lookups
    # ------------------------------------------------------------------
    def equals(self, other) -> bool:
        """Same labels in the same order.  One object, or two views of one
        column, is equal without a look at the labels; else one host sync."""
        if other is self:
            return True
        if not isinstance(other, Index) or isinstance(other, MultiIndex):
            return False
        if len(self) != len(other):
            return False
        if len(self) == 0:
            return True
        dev = self.device or other.device
        mine, theirs = self.column(dev), other.column(dev)
        if mine is theirs or (mine.data is theirs.data and mine.validity is theirs.validity):
            return True
        from cudf_tpu_torch.ops.binaryop import binary_operation

        try:
            eq = binary_operation(mine, theirs, "null_equals")
        except TypeError:
            return False
        return tracing.to_bool(eq.data.all(), "scalar_result")

    @property
    def is_unique(self) -> bool:
        from cudf_tpu_torch.ops.stream_compaction import distinct_count

        return distinct_count(self._column, dropna=False) == len(self)

    def get_indexer_for(self, labels, device=None) -> torch.Tensor:
        """int64 positions of the labels in this index (the first match),
        -1 where a label is missing; host labels go to ``device`` (the
        index's own by default)."""
        from cudf_tpu_torch.ops.search import first_match

        return first_match(self._column, label_column(labels, device or self.device))

    def _positions_of(self, label, device=None) -> torch.Tensor:
        """Every position holding the label (duplicate labels give several)."""
        from cudf_tpu_torch.ops.search import is_in_list

        hit = is_in_list(self._column, [label])
        return tracing.synced("label_lookup", hit, torch.nonzero, hit).squeeze(1)

    def get_loc(self, key):
        pos = self._positions_of(key)
        if pos.shape[0] == 0:
            raise KeyError(key)
        if pos.shape[0] == 1:
            return tracing.to_int(pos[0], "label_lookup")
        return tracing.synced("export", pos, pos.cpu).numpy()

    def isin(self, values) -> np.ndarray:
        from cudf_tpu_torch.ops.search import contains, is_in_list

        if isinstance(values, (Index, Column, torch.Tensor)):
            mask = contains(label_column(values, self.device), self._column)
        else:
            mask = is_in_list(self._column, list(values))
        return tracing.synced("export", mask, mask.cpu).numpy()

    def _sorted_distinct(self, col: Column, name) -> "Index":
        from cudf_tpu_torch.ops import sort as sort_ops
        from cudf_tpu_torch.ops import stream_compaction as sc

        col = copying.gather(col, sc.distinct_indices([col], "first"), bounds_check=False)
        return Index(copying.gather(col, sort_ops.sorted_order([col]), bounds_check=False),
                     name)

    def union(self, other) -> "Index":
        """The distinct labels of both, sorted."""
        other = as_index(other, self.device)
        dev = self.device or other.device
        both = copying.concatenate([self.column(dev), other.column(dev)])
        return self._sorted_distinct(both, self.name if self.name == other.name else None)

    def intersection(self, other) -> "Index":
        from cudf_tpu_torch.ops.search import contains
        from cudf_tpu_torch.ops.stream_compaction import filter_indices

        other = as_index(other, self.device)
        dev = self.device or other.device
        mine = self.column(dev)
        keep = filter_indices(contains(other.column(dev), mine))
        return self._sorted_distinct(copying.gather(mine, keep, bounds_check=False), self.name)

    def difference(self, other) -> "Index":
        from cudf_tpu_torch.ops.search import contains
        from cudf_tpu_torch.ops.stream_compaction import filter_indices

        other = as_index(other, self.device)
        dev = self.device or other.device
        mine = self.column(dev)
        keep = filter_indices(~contains(other.column(dev), mine))
        return self._sorted_distinct(copying.gather(mine, keep, bounds_check=False), self.name)

    def unique(self) -> "Index":
        from cudf_tpu_torch.ops import stream_compaction as sc

        col = self.column(self.device)
        return Index(copying.gather(col, sc.distinct_indices([col], "first"),
                                    bounds_check=False), self.name)

    def argsort(self, ascending: bool = True) -> np.ndarray:
        from cudf_tpu_torch.ops import sort as sort_ops

        order = sort_ops.sorted_order([self.column(self.device)], [ascending])
        return tracing.synced("export", order, order.cpu).numpy()

    def sort_values(self, ascending: bool = True) -> "Index":
        from cudf_tpu_torch.ops import sort as sort_ops

        order = sort_ops.sorted_order([self.column(self.device)], [ascending])
        return self.take(order)

    def astype(self, dtype) -> "Index":
        from cudf_tpu_torch.ops.unary import cast

        return Index(cast(self.column(self.device), dt.dtype(dtype)), self.name)

    def min(self):
        from cudf_tpu_torch.ops import reductions

        return reductions.min(self.column(self.device))

    def max(self):
        from cudf_tpu_torch.ops import reductions

        return reductions.max(self.column(self.device))

    def to_series(self):
        from cudf_tpu_torch.frame.series import Series

        return Series._from(self.column(self.device), self.copy(), self.name)

    def to_frame(self, name=None):
        from cudf_tpu_torch.core.table import Table
        from cudf_tpu_torch.frame.dataframe import DataFrame

        nm = name if name is not None else (self.name if self.name is not None else 0)
        return DataFrame._from(Table({nm: self.column(self.device)}), default_index(len(self)))


class RangeIndex(Index):
    def __init__(self, start=0, stop=None, step=1, name=None):
        if stop is None:
            start, stop = 0, start
        self.start, self.stop, self.step = int(start), int(stop), int(step)
        self.name = name

    @property
    def dtype(self):
        return dt.INT64

    @property
    def device(self) -> Optional[torch.device]:
        return None

    def __len__(self) -> int:
        return len(range(self.start, self.stop, self.step))

    def column(self, device: Optional[torch.device] = None) -> Column:
        """The index materialised as an int64 column on ``device``."""
        data = torch.arange(self.start, self.stop, self.step, dtype=torch.int64,
                            device=device)
        return Column(dt.INT64, data.shape[0], data)

    @property
    def _column(self) -> Column:
        return self.column()

    def to_numpy(self):
        return np.arange(self.start, self.stop, self.step, dtype=np.int64)

    def copy(self) -> "RangeIndex":
        return RangeIndex(self.start, self.stop, self.step, self.name)

    def take(self, indices: torch.Tensor) -> Index:
        """The labels at these positions, as an int64 Index on their device."""
        data = self.start + indices.long() * self.step
        return Index(Column(dt.INT64, data.shape[0], data), self.name)

    def append(self, other: Index, device=None) -> Index:
        """A RangeIndex when ``other`` is one that continues this one (or
        either is empty), else the labels of both as an Index."""
        if isinstance(other, RangeIndex):
            name = self.name if self.name == other.name else None
            if len(other) == 0 or len(self) == 0:
                keep = self if len(other) == 0 else other
                return RangeIndex(keep.start, keep.stop, keep.step, name)
            if other.start == self.start + len(self) * self.step and (
                    other.step == self.step or len(other) == 1):
                return RangeIndex(self.start, other.start + other.step * len(other) if
                                  other.step == self.step else other.start + self.step,
                                  self.step, name)
        return super().append(other, device)

    def slice(self, start: int, stop: int) -> "RangeIndex":
        r = range(self.start, self.stop, self.step)[start:stop]
        return RangeIndex(r.start, r.stop, r.step, self.name)

    def __getitem__(self, i):
        r = range(self.start, self.stop, self.step)[i]
        if isinstance(i, slice):
            return RangeIndex(r.start, r.stop, r.step, self.name)
        return r

    def equals(self, other) -> bool:
        if isinstance(other, RangeIndex):
            a = range(self.start, self.stop, self.step)
            return a == range(other.start, other.stop, other.step)
        return super().equals(other)

    def get_indexer_for(self, labels, device=None) -> torch.Tensor:
        """Arithmetic: (label - start) / step where that lands in range, on
        the labels' device (host labels on ``device``, by default the CPU)."""
        col = label_column(labels, device or "cpu")
        if not (col.dtype.is_integer or col.dtype.is_float):
            return torch.full((col.length,), -1, dtype=torch.int64, device=col.device)
        lab = col.data.double() if col.dtype.is_float else col.data.long()
        off = lab - self.start
        pos = torch.div(off, self.step, rounding_mode="floor").long()
        ok = (off % self.step == 0) & (pos >= 0) & (pos < len(self))
        if col.validity is not None:
            ok &= col.validity
        return torch.where(ok, pos, -1)

    def _positions_of(self, label, device=None) -> torch.Tensor:
        pos = self.get_indexer_for([label], device)
        return pos[pos >= 0]

    def min(self):
        return self[0] if self.step > 0 else self[-1]

    def max(self):
        return self[-1] if self.step > 0 else self[0]

    def to_pandas(self):
        import pandas as pd

        return pd.RangeIndex(self.start, self.stop, self.step, name=self.name)

    def __repr__(self):
        return f"RangeIndex(start={self.start}, stop={self.stop}, step={self.step})"


class MultiIndex(Index):
    """A multi-level index as parallel columns, one a level."""

    def __init__(self, columns: Sequence[Column], names: Sequence):
        self._columns: Tuple[Column, ...] = tuple(columns)
        self.names: Tuple = tuple(names)
        self.name = None

    @property
    def nlevels(self) -> int:
        return len(self._columns)

    @property
    def device(self) -> Optional[torch.device]:
        return self._columns[0].device if self._columns else None

    def __len__(self) -> int:
        return self._columns[0].length if self._columns else 0

    def column(self, device: Optional[torch.device] = None) -> Column:
        raise TypeError("a MultiIndex has one column a level: get_level_values")

    def get_level_values(self, level) -> Index:
        i = level if isinstance(level, int) else self.names.index(level)
        return Index(self._columns[i], self.names[i])

    def copy(self) -> "MultiIndex":
        return MultiIndex(self._columns, self.names)

    def take(self, indices: torch.Tensor) -> "MultiIndex":
        return MultiIndex([copying.gather(c, indices, bounds_check=False)
                           for c in self._columns], self.names)

    def slice(self, start: int, stop: int) -> "MultiIndex":
        return MultiIndex([copying.slice(c, start, stop) for c in self._columns], self.names)

    def append(self, other: Index, device=None) -> "MultiIndex":
        """Both indexes' rows, level by level (names kept where equal)."""
        if not isinstance(other, MultiIndex) or other.nlevels != self.nlevels:
            raise TypeError("append of a MultiIndex and an index of other levels")
        return MultiIndex([copying.concatenate([a, b]) for a, b in zip(self._columns,
                                                                       other._columns)],
                          [a if a == b else None for a, b in zip(self.names, other.names)])

    def equals(self, other) -> bool:
        if other is self:
            return True
        if not isinstance(other, MultiIndex) or other.nlevels != self.nlevels:
            return False
        return all(Index(a).equals(Index(b)) for a, b in zip(self._columns, other._columns))

    def to_pylist(self):
        return list(zip(*[c.to_numpy().tolist() for c in self._columns]))

    def to_pandas(self):
        import pandas as pd

        return pd.MultiIndex.from_arrays([c.to_pandas_array() for c in self._columns],
                                         names=list(self.names))

    def __repr__(self):
        return f"MultiIndex({list(self._columns)!r}, names={list(self.names)!r})"


def as_index(obj, device=None) -> Index:
    """An Index from an Index, a column, a tensor, a pandas Index or host
    labels (which need ``device``)."""
    if isinstance(obj, Index):
        return obj
    if type(obj).__name__ == "RangeIndex" and hasattr(obj, "start"):
        return RangeIndex(obj.start, obj.stop, obj.step, name=obj.name)
    if type(obj).__name__ == "MultiIndex" and hasattr(obj, "levels"):
        return MultiIndex([label_column(np.asarray(obj.get_level_values(i)), device)
                           for i in range(obj.nlevels)], list(obj.names))
    name = getattr(obj, "name", None) if not isinstance(obj, (list, tuple)) else None
    if type(obj).__name__ in ("Index", "Series") and hasattr(obj, "to_numpy"):
        from cudf_tpu_torch.core.column import Column as _Column

        return Index(_Column.from_pandas(obj if type(obj).__name__ == "Series"
                                         else obj.to_series(), device=device), name)
    return Index(label_column(obj, device), name if isinstance(name, (str, int)) else None)


def default_index(n: int) -> RangeIndex:
    return RangeIndex(n)
