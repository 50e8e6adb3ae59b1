"""Index, RangeIndex and MultiIndex (port of ``cudf_tpu/frame/index.py``,
the part groupby results and row selections need).  A RangeIndex stays
lazy: no buffer until a column is asked for, on a device the caller
names."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.ops import copying


class Index:
    def __init__(self, column: Column, name=None):
        self._column = column
        self.name = name

    def __len__(self) -> int:
        return self._column.length

    def column(self, device: Optional[torch.device] = None) -> Column:
        return self._column

    def take(self, indices: torch.Tensor) -> "Index":
        return Index(copying.gather(self._column, indices, bounds_check=False), self.name)

    def slice(self, start: int, stop: int) -> "Index":
        return Index(copying.slice(self._column, start, stop), self.name)

    def to_pandas(self):
        import pandas as pd

        return pd.Index(self._column.to_pandas_array(), name=self.name)

    def __repr__(self):
        return f"Index({self._column!r}, name={self.name!r})"


class RangeIndex(Index):
    def __init__(self, start=0, stop=None, step=1, name=None):
        if stop is None:
            start, stop = 0, start
        self.start, self.stop, self.step = int(start), int(stop), int(step)
        self.name = name

    def __len__(self) -> int:
        return len(range(self.start, self.stop, self.step))

    def column(self, device: Optional[torch.device] = None) -> Column:
        """The index materialised as an int64 column on ``device``."""
        data = torch.arange(self.start, self.stop, self.step, dtype=torch.int64,
                            device=device)
        return Column(dt.INT64, data.shape[0], data)

    def take(self, indices: torch.Tensor) -> Index:
        """The labels at these positions, as an int64 Index on their device."""
        data = self.start + indices.long() * self.step
        return Index(Column(dt.INT64, data.shape[0], data), self.name)

    def slice(self, start: int, stop: int) -> "RangeIndex":
        r = range(self.start, self.stop, self.step)[start:stop]
        return RangeIndex(r.start, r.stop, r.step, self.name)

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

    def __len__(self) -> int:
        return self._columns[0].length if self._columns else 0

    def column(self, device: Optional[torch.device] = None) -> Column:
        raise TypeError("a MultiIndex has one column a level: get_level_values")

    def get_level_values(self, level) -> Index:
        i = level if isinstance(level, int) else self.names.index(level)
        return Index(self._columns[i], self.names[i])

    def take(self, indices: torch.Tensor) -> "MultiIndex":
        return MultiIndex([copying.gather(c, indices, bounds_check=False)
                           for c in self._columns], self.names)

    def slice(self, start: int, stop: int) -> "MultiIndex":
        return MultiIndex([copying.slice(c, start, stop) for c in self._columns], self.names)

    def to_pandas(self):
        import pandas as pd

        return pd.MultiIndex.from_arrays([c.to_pandas_array() for c in self._columns],
                                         names=list(self.names))

    def __repr__(self):
        return f"MultiIndex({list(self._columns)!r}, names={list(self.names)!r})"


def default_index(n: int) -> RangeIndex:
    return RangeIndex(n)
