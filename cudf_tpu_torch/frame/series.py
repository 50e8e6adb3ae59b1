"""Series (port of ``cudf_tpu/frame/series.py``: construction,
``to_pandas``, ``take`` and ``sort_values``).  Its index may
be a MultiIndex, as a multi-key groupby's ``size()`` gives."""

from __future__ import annotations

import torch

from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.frame.index import Index, default_index
from cudf_tpu_torch.ops import copying
from cudf_tpu_torch.ops import sort as sort_ops
from cudf_tpu_torch.ops.replace import nans_to_nulls


class Series:
    def __init__(self, column: Column, index: Index, name=None):
        if len(index) != column.length:
            raise ValueError("index length mismatch")
        self._column = column
        self._index = index
        self.name = name

    @classmethod
    def _from(cls, column: Column, index: Index, name=None) -> "Series":
        return cls(column, index, name)

    @property
    def index(self) -> Index:
        return self._index

    def __len__(self) -> int:
        return self._column.length

    def take(self, indices: torch.Tensor) -> "Series":
        """The rows at these positions, with their index labels."""
        return Series(copying.gather(self._column, indices, bounds_check=False),
                      self._index.take(indices), self.name)

    def sort_values(self, ascending: bool = True, na_position: str = "last",
                    ignore_index: bool = False, kind=None) -> "Series":
        """A stable sort (any ``kind``); NaN sorts as null."""
        order = sort_ops.sorted_order([nans_to_nulls(self._column)], [ascending], na_position)
        out = self.take(order)
        if ignore_index:
            out._index = default_index(len(out))
        return out

    def to_pandas(self):
        import pandas as pd

        return pd.Series(self._column.to_pandas_array(), index=self._index.to_pandas(),
                         name=self.name)

    def __repr__(self) -> str:
        return f"Series({self.name!r}, {self._column!r})"
