"""Time-series resampling (port of ``cudf_tpu/frame/resample.py``;
python/cudf/cudf/core/resample.py).

A row's bin is ``floor((t - origin) / step)`` as an int64 code, the
origin pandas' ``start_day`` (midnight of the first timestamp's day, one
host sync), and the aggregation is ``ops/groupby.py`` ``groupby_agg`` by
that code: a few thousand bins reach the one-hot tier (kernel A), more
the radix or sort tiers.  The observed bins are then spread over the
regular grid from the first bin to the last, as pandas emits it: an
empty bin sums and counts to 0 and is null (NaN) for every other
aggregation (the reference fills only count and size).
"""

from __future__ import annotations

from typing import Optional

import torch

from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.core.table import Table
from cudf_tpu_torch.frame.index import Index
from cudf_tpu_torch.frame.series import Series
from cudf_tpu_torch.ops import copying
from cudf_tpu_torch.ops import datetime as dto
from cudf_tpu_torch.ops import groupby as gb_ops
from cudf_tpu_torch.ops.replace import replace_nulls_scalar

_ZERO_WHEN_EMPTY = ("sum", "count", "size")


class Resampler:
    def __init__(self, obj, rule: str, on: Optional[str] = None):
        self._obj, self._rule, self._on = obj, rule, on
        ts = obj._table[on] if on is not None else obj._index.column(obj.device)
        ts = dto.days_as_seconds(ts)
        if not ts.dtype.is_timestamp:
            raise TypeError("resample needs a datetime index or an 'on' column")
        self._ts = ts

    def __getitem__(self, key):
        """The resampler of one column (a Series result) or of a list of
        them, as pandas' ``resample(...)[key]``."""
        if isinstance(key, (list, tuple)):
            keep = list(key) + ([self._on] if self._on is not None else [])
            return Resampler(self._obj[keep], self._rule, self._on)
        return Resampler(Series._from(self._obj._table[key], Index(self._ts), key), self._rule)

    def __getattr__(self, name):
        if name.startswith("_") or isinstance(self._obj, Series) or \
                name not in self._obj._table.names:
            raise AttributeError(name)
        return self[name]

    def _codes(self):
        """(int64 bin codes, origin ticks, step ticks)."""
        unit = self._ts.dtype.time_unit
        step = dto.freq_ticks(self._rule, unit)
        day = dto.freq_ticks("D", unit)
        t = self._ts.data
        valid = self._ts.validity
        first = int((t if valid is None else t[valid]).min()) if self._ts.length else 0
        origin = first // day * day
        return torch.div(t - origin, step, rounding_mode="floor"), origin, step

    def _values(self):
        if isinstance(self._obj, Series):
            return [(self._obj.name, self._obj._column)]
        return [(n, c) for n, c in self._obj._table.items()
                if n != self._on and (c.dtype.is_numeric or c.dtype.is_bool)]

    def _agg(self, agg: str):
        from cudf_tpu_torch.frame.dataframe import DataFrame

        codes, origin, step = self._codes()
        keys = Table({"__bin": Column(dt.INT64, codes.shape[0], codes, self._ts.validity)})
        values = self._values() if agg != "size" else [("size", self._ts)]
        gk, ga = gb_ops.groupby_agg(keys, [(i, c, agg) for i, (_, c) in enumerate(values)])
        present = gk["__bin"].data
        if present.shape[0]:
            lo, hi = torch.stack([present[0], present[-1]]).tolist()
        else:
            lo, hi = 0, -1
        src = torch.full((hi - lo + 1,), -1, dtype=torch.int64, device=present.device)
        src[present - lo] = torch.arange(present.shape[0], device=present.device)
        cols = {}
        for i, (name, _) in enumerate(values):
            filled = copying.gather(ga[i], src, bounds_check=True)
            cols[name] = replace_nulls_scalar(filled, 0) if agg in _ZERO_WHEN_EMPTY else filled
        grid = origin + (lo + torch.arange(hi - lo + 1, device=present.device)) * step
        name = self._on if self._on is not None else self._obj._index.name
        idx = Index(Column(self._ts.dtype, grid.shape[0], grid), name=name)
        if isinstance(self._obj, Series) or agg == "size":
            out_name = None if agg == "size" and not isinstance(self._obj, Series) else \
                self._obj.name
            return Series._from(next(iter(cols.values())), idx, out_name)
        return DataFrame._from(Table(cols), idx)

    def agg(self, func):
        if isinstance(func, str):
            return self._agg(func)
        raise NotImplementedError("resample.agg takes one aggregation's name, as the "
                                  "reference; ROADMAP.md, beyond the reference")


for _name in ("sum", "mean", "min", "max", "count", "first", "last", "std", "var", "median",
              "size"):
    def _method(self, _name=_name):
        return self._agg(_name)
    _method.__name__ = _name
    setattr(Resampler, _name, _method)
