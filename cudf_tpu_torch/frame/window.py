"""Rolling windows and EWM (port of ``cudf_tpu/frame/window.py``;
libcudf's rolling).

Every window is a range of rows [s, e) at most B rows long.  The rows are
cut into blocks of B; a window then lies in one block, starting at its
first row, or is the suffix of one block and the prefix of the next (van
Herk / Gil-Werman).  Each block's running sums (and minima, maxima) from
either end are one ``cumsum`` (``cummin``, ``cummax``) along the rows of
a [blocks, B] view, so a window's sum adds at most two partial sums of B
values each: its rounding grows with B, not with the column's length (the
reference's global prefix-sum differences lose what a long running sum
loses).

- Fixed windows (``rolling(w)``; ``center=True`` ends a row's window
  (w - 1) // 2 rows after it, clipped at the column's ends) take B = w,
  with w rows of padding in front, so that every window is exactly w
  rows long and min/max are two lookups.
- Offset windows (``rolling("7D")`` over a datetime index: the rows whose
  time is within the offset before a row's, that row included) and
  grouped windows (``groupby(...).rolling(w)``, never crossing a group)
  have a start of their own; B is the longest window (one host sync),
  and min/max take a sparse table that stops at the longest window, one
  level at a time, each row answered at its level (memory of one level).
- ``var``/``std`` are centred: each block's values less its mean, the
  window's one or two parts each a (count, mean, M2) combined by Chan's
  formula, so values far from zero keep their digits; a window whose
  values are all equal gives 0, as pandas does.
- ``apply(func, raw=True)`` over fixed full windows runs ``func`` under
  ``torch.func.vmap`` over ``x.unfold(0, w, 1)`` (views), a chunk of
  windows at a time (``frame/series.py`` ``UDF_ROUTES["vmap"]``); any
  other function or window takes the counted host route.

Results are float64, NaN where a window has fewer valid values than
``min_periods``, as pandas gives them.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.core.table import Table
from cudf_tpu_torch.frame.index import MultiIndex
from cudf_tpu_torch.frame.series import UDF_ROUTES, Series, vmap_udf

# windows a chunk of vmapped ``apply`` (bounds its temporaries)
APPLY_CHUNK_VALUES = 1 << 26
_FUNCS = ("sum", "mean", "min", "max", "var", "std", "count")


def _values(col: Column) -> Tuple[torch.Tensor, torch.Tensor]:
    """(float64 values, 0 where invalid; bool valid: not null, not NaN)."""
    x = col.data.double()
    valid = ~torch.isnan(x)
    if col.validity is not None:
        valid &= col.validity
    return torch.where(valid, x, 0.0), valid


def _grid(v: torch.Tensor, B: int) -> torch.Tensor:
    """v padded with zeros to whole blocks, as [blocks, B]."""
    pad = -v.shape[0] % B
    if pad:
        v = torch.cat([v, v.new_zeros(pad)])
    return v.view(-1, B)


def _parts(v: torch.Tensor, s: torch.Tensor, e: torch.Tensor, B: int):
    """Each window's sum over [s, e) (e - s <= B) as (first part, second
    part): within one block, (the block's running sum at e - 1 less it
    before s, 0); over two, (the first block's sum from s, the second's
    through e - 1).  Empty windows give (0, 0)."""
    g = _grid(v, B)
    pre = torch.cumsum(g, 1)
    suf = torch.flip(torch.cumsum(torch.flip(g, [1]), 1), [1]).reshape(-1)
    before = torch.cat([pre.new_zeros(pre.shape[0], 1), pre[:, :-1]], 1).reshape(-1)
    pre = pre.reshape(-1)
    last = torch.clamp(e - 1, min=0)
    sc = torch.clamp(s, max=pre.shape[0] - 1)
    same = (sc // B) == (last // B)
    empty = e <= s
    a = torch.where(same, pre[last] - before[sc], suf[sc])
    b = torch.where(same, 0.0, pre[last])
    return torch.where(empty, 0.0, a), torch.where(empty, 0.0, b)


def _block_extremes(v: torch.Tensor, s: torch.Tensor, e: torch.Tensor, B: int, which: str):
    """min/max over windows [s, s + B) that start at a block's first row or
    span two blocks (fixed windows in padded positions)."""
    g = _grid(v, B)
    run = torch.cummin if which == "min" else torch.cummax
    fn = torch.minimum if which == "min" else torch.maximum
    pre = run(g, 1).values.reshape(-1)
    suf = torch.flip(run(torch.flip(g, [1]), 1).values, [1]).reshape(-1)
    last = e - 1
    return torch.where(s % B == 0, pre[last], fn(suf[s], pre[last]))


def _level_extremes(v: torch.Tensor, s: torch.Tensor, e: torch.Tensor, longest: int,
                    which: str, fill: float):
    """min/max over windows [s, e) of any length up to ``longest`` (>= 1):
    a sparse table built one level at a time (level k holds each row's
    reduce over the 2^k rows ending at it), each window answered from two
    entries of the level of its length's highest bit."""
    fn = torch.minimum if which == "min" else torch.maximum
    n = v.shape[0]
    length = torch.clamp(e - s, min=1)
    k_of = torch.floor(torch.log2(length.double())).long()
    last = torch.clamp(e - 1, 0, max(n - 1, 0))
    out = torch.full_like(v, fill)
    level = v
    for k in range(max(int(longest), 1).bit_length()):
        if k:
            d = 1 << (k - 1)
            level = fn(level, torch.cat([level.new_full((min(d, n),), fill), level[:n - d]]))
        at = k_of == k
        first = torch.clamp(s + (1 << k) - 1, 0, max(n - 1, 0))
        out = torch.where(at, fn(level[last], level[first]), out)
    return torch.where(e > s, out, fill)


def _moment(n_a, s_a, ss_a, shift):
    """(mean, M2) of a part from its count and its sums of y = x - shift
    and y^2."""
    safe = torch.clamp(n_a, min=1.0)
    return shift + s_a / safe, torch.where(n_a > 0, ss_a - s_a * s_a / safe, 0.0)


def _reduce(x, valid, s, e, B, fn_name, min_periods, extremes, rows):
    """One reduction over windows [s, e) of the rows (positions of x),
    float64 [windows], NaN under ``min_periods`` valid values (``count``:
    under ``min_periods`` rows, ``rows`` a window, as pandas counts the
    non-null flags).  ``extremes(v, which, fill)`` gives the windows'
    min/max of v."""
    cnt_a, cnt_b = _parts(valid.double(), s, e, B)
    cnt = cnt_a + cnt_b
    if fn_name in ("sum", "mean"):
        a, b = _parts(x, s, e, B)
        out = a + b
        if fn_name == "mean":
            out = out / cnt
    elif fn_name == "count":
        return torch.where(rows >= min_periods, cnt, math.nan), cnt
    elif fn_name in ("min", "max"):
        fill = math.inf if fn_name == "min" else -math.inf
        out = extremes(torch.where(valid, x, fill), fn_name, fill)
        out = torch.where(cnt > 0, out, math.nan)
    elif fn_name in ("var", "std"):
        g_x, g_n = _grid(x, B), _grid(valid.double(), B)
        shift = (g_x.sum(1) / torch.clamp(g_n.sum(1), min=1.0))
        block = torch.arange(x.shape[0], device=x.device) // B
        y = torch.where(valid, x - shift[block], 0.0)
        y_a, y_b = _parts(y, s, e, B)
        yy_a, yy_b = _parts(y * y, s, e, B)
        last = torch.clamp(e - 1, min=0)
        mean_a, m2_a = _moment(cnt_a, y_a, yy_a, shift[torch.clamp(s, max=x.shape[0] - 1) // B])
        mean_b, m2_b = _moment(cnt_b, y_b, yy_b, shift[last // B])
        total = torch.clamp(cnt, min=1.0)
        delta = mean_b - mean_a
        m2 = m2_a + m2_b + delta * delta * cnt_a * cnt_b / total
        var = torch.clamp(m2 / torch.clamp(cnt - 1.0, min=1.0), min=0.0)
        lo = extremes(torch.where(valid, x, math.inf), "min", math.inf)
        hi = extremes(torch.where(valid, x, -math.inf), "max", -math.inf)
        var = torch.where(lo == hi, 0.0, var)
        out = torch.where(cnt >= 2, var if fn_name == "var" else torch.sqrt(var), math.nan)
    else:
        raise NotImplementedError(f"rolling {fn_name}")
    return torch.where(cnt >= min_periods, out, math.nan), cnt


def fixed_windows(x, valid, w: int, fn_name: str, min_periods: int, center: bool = False):
    """Every row's window of w rows ending at it ((w - 1) // 2 rows after it
    with ``center``), clipped at the ends; float64 [n] and the counts."""
    n = x.shape[0]
    offset = (w - 1) // 2 if center else 0
    length = -(-(w + n + offset) // w) * w
    pad_x = x.new_zeros(length)
    pad_v = valid.new_zeros(length)
    pad_x[w:w + n], pad_v[w:w + n] = x, valid
    s = torch.arange(n, device=x.device) + 1 + offset
    e = s + w

    def extremes(v, which, fill):
        return _block_extremes(v, s, e, w, which)

    rows = torch.clamp(s, max=n) - torch.clamp(s - w, min=0)
    return _reduce(pad_x, pad_v, s, e, w, fn_name, min_periods, extremes, rows)


def range_windows(x, valid, s, e, fn_name: str, min_periods: int):
    """Windows [s[i], e[i]) of any lengths (offset and grouped windows)."""
    longest = int((e - s).max()) if s.numel() else 1
    B = max(longest, 1)

    def extremes(v, which, fill):
        return _level_extremes(v, s, e, B, which, fill)

    return _reduce(x, valid, s, e, B, fn_name, min_periods, extremes, e - s)[0]


class Rolling:
    """``Series.rolling`` / ``DataFrame.rolling``: a window of rows (an
    int) or a time offset ("7D", "2h") over a datetime index."""

    def __init__(self, obj, window, min_periods=None, center: bool = False):
        self._obj = obj
        self._center = center
        if isinstance(window, str):
            self._time_window, self._window = window, None
            self._min_periods = 1 if min_periods is None else int(min_periods)
        else:
            self._time_window, self._window = None, int(window)
            self._min_periods = self._window if min_periods is None else int(min_periods)

    def _columns(self):
        if isinstance(self._obj, Series):
            return None
        return [n for n, c in self._obj._table.items() if c.dtype.is_numeric or c.dtype.is_bool]

    def _apply(self, fn_name: str):
        from cudf_tpu_torch.frame.dataframe import DataFrame

        if isinstance(self._obj, Series):
            return self._series(self._obj, fn_name)
        out = {n: self._series(self._obj[n], fn_name)._column for n in self._columns()}
        return DataFrame._from(Table(out), self._obj._index)

    def _time_bounds(self, s: Series):
        from cudf_tpu_torch.ops import datetime as dto

        idx = dto.days_as_seconds(s._index.column(s.device))
        if not idx.dtype.is_timestamp:
            raise TypeError("an offset window needs a datetime index")
        t = idx.data
        delta = dto.freq_ticks(self._time_window, idx.dtype.time_unit)
        lo = torch.searchsorted(t, t - delta, right=True)
        return lo, torch.arange(t.shape[0], device=t.device) + 1

    def _series(self, s: Series, fn_name: str) -> Series:
        x, valid = _values(s._column)
        if self._time_window is not None:
            lo, hi = self._time_bounds(s)
            out = range_windows(x, valid, lo, hi, fn_name, self._min_periods)
        else:
            out, _ = fixed_windows(x, valid, self._window, fn_name, self._min_periods,
                                   self._center)
        return Series._from(Column(dt.FLOAT64, out.shape[0], out), s._index, s.name)

    def sum(self):
        return self._apply("sum")

    def mean(self):
        return self._apply("mean")

    def min(self):
        return self._apply("min")

    def max(self):
        return self._apply("max")

    def var(self):
        return self._apply("var")

    def std(self):
        return self._apply("std")

    def count(self):
        return self._apply("count")

    def apply(self, func, raw: bool = False):
        """``func`` of each window: vmapped on the device for raw=True over
        full fixed windows (min_periods = window, no centre), else a host
        loop (counted in ``UDF_ROUTES["host"]``)."""
        from cudf_tpu_torch.frame.dataframe import DataFrame

        if isinstance(self._obj, Series):
            return self._apply_series(self._obj, func, raw)
        out = {n: self._apply_series(self._obj[n], func, raw)._column for n in self._columns()}
        return DataFrame._from(Table(out), self._obj._index)

    def _apply_series(self, s: Series, func, raw: bool) -> Series:
        x, valid = _values(s._column)
        out = self._vmapped(x, valid, func) if raw else None
        if out is None:
            out = self._host_apply(s, x, valid, func, raw)
        return Series._from(Column(dt.FLOAT64, out.shape[0], out), s._index, s.name)

    def _vmapped(self, x, valid, func) -> Optional[torch.Tensor]:
        w, n = self._window, x.shape[0]
        if w is None or self._center or self._min_periods != w or w < 1 or n < w:
            return None
        data = torch.where(valid, x, math.nan)
        windows = data.unfold(0, w, 1)                      # a view, [n - w + 1, w]
        step = max(1, APPLY_CHUNK_VALUES // w)
        parts = []
        for a in range(0, windows.shape[0], step):
            got = vmap_udf(func, windows[a:a + step], x.device)
            if got is None or not isinstance(got, torch.Tensor) or got.dim() != 1:
                return None
            parts.append(got.double())
        UDF_ROUTES["vmap"] += 1
        _, cnt = fixed_windows(x, valid, w, "count", w)
        out = torch.cat([x.new_full((w - 1,), math.nan), torch.cat(parts)])
        # pandas calls func on no window with fewer than min_periods valid values
        return torch.where(cnt >= w, out, math.nan)

    def _host_apply(self, s: Series, x, valid, func, raw: bool) -> torch.Tensor:
        UDF_ROUTES["host"] += 1
        n = x.shape[0]
        if self._time_window is not None:
            lo, hi = self._time_bounds(s)
        else:
            offset = (self._window - 1) // 2 if self._center else 0
            hi = torch.clamp(torch.arange(n, device=x.device) + 1 + offset, max=n)
            lo = torch.clamp(hi - self._window, min=0)
        vals = torch.where(valid, x, math.nan).cpu().numpy()
        ok = valid.cpu().numpy()
        lo, hi = lo.cpu().tolist(), hi.cpu().tolist()
        labels = None
        if not raw:
            import pandas as pd

            labels = s._index.to_pandas()
        out = np.full(n, np.nan)
        for i in range(n):
            a, b = lo[i], hi[i]
            if ok[a:b].sum() < self._min_periods:
                continue
            window = vals[a:b] if raw else pd.Series(vals[a:b], index=labels[a:b])
            out[i] = float(func(window))
        return torch.from_numpy(out).to(x.device)


class EWM:
    """``ewm(...).mean()``: ``ops/scan.py`` ``ewm_mean`` with NaN as null."""

    def __init__(self, obj, alpha: float, adjust: bool = True, ignore_na: bool = False):
        self._obj, self._alpha, self._adjust, self._ignore_na = obj, float(alpha), adjust, \
            ignore_na

    def _series(self, s: Series) -> Series:
        from cudf_tpu_torch.ops.replace import nans_to_nulls
        from cudf_tpu_torch.ops.scan import ewm_mean

        col = nans_to_nulls(s._column) if s.dtype.is_float else s._column
        return Series._from(ewm_mean(col, self._alpha, self._adjust, self._ignore_na),
                            s._index, s.name)

    def mean(self):
        from cudf_tpu_torch.frame.dataframe import DataFrame

        if isinstance(self._obj, Series):
            return self._series(self._obj)
        out = {n: self._series(self._obj[n])._column for n, c in self._obj._table.items()
               if c.dtype.is_numeric}
        return DataFrame._from(Table(out), self._obj._index)


def ewm_alpha(com=None, span=None, halflife=None, alpha=None) -> float:
    """pandas' decay parameter from exactly one of com, span, halflife and
    alpha."""
    if alpha is not None:
        return float(alpha)
    if com is not None:
        return 1.0 / (1.0 + com)
    if span is not None:
        return 2.0 / (span + 1.0)
    if halflife is not None:
        return 1.0 - math.exp(-math.log(2.0) / halflife)
    raise ValueError("ewm needs one of com, span, halflife or alpha")


class RollingGroupby:
    """``groupby(keys).rolling(w)``: trailing windows of w rows that never
    cross a group, the rows group by group (in the groupby's order) under
    a (keys..., row label) MultiIndex, as pandas gives them."""

    def __init__(self, gb, window: int, min_periods: Optional[int] = None):
        if isinstance(window, str):
            raise NotImplementedError("groupby rolling over a time offset: the reference "
                                      "takes a window of rows; ROADMAP.md, beyond the "
                                      "reference")
        self._gb = gb
        self._window = int(window)
        self._min_periods = self._window if min_periods is None else int(min_periods)

    def _reduce(self, fn_name: str):
        from cudf_tpu_torch.frame.dataframe import DataFrame
        from cudf_tpu_torch.ops import copying

        gb = self._gb
        g = gb.grouper
        kept = gb._rows_in_group_order()
        rows = g.frame_rows(kept)
        gid = g.group_ids[kept]
        n = rows.shape[0]
        pos = torch.arange(n, device=rows.device)
        head = torch.ones(n, dtype=torch.bool, device=rows.device)
        head[1:] = gid[1:] != gid[:-1]
        seg_start = torch.cummax(torch.where(head, pos, 0), 0).values
        s = torch.maximum(pos - self._window + 1, seg_start)
        e = pos + 1
        series = isinstance(gb._values_obj(), Series)
        names = [gb._name] if series else \
            [nm for nm in gb._value_names() if gb._obj._table[nm].dtype.is_numeric]
        out = {}
        for nm in names:
            col = gb._series._column if series else gb._obj._table[nm]
            x, valid = _values(copying.gather(col, rows, bounds_check=False))
            data = range_windows(x, valid, s, e, fn_name, self._min_periods) if n else x
            out[nm] = Column(dt.FLOAT64, n, data)
        keys = [copying.gather(c, rows, bounds_check=False) for c in gb._key_cols]
        labels = gb._obj.index.take(rows)
        idx = MultiIndex([*keys, labels.column(rows.device)],
                         [*gb._key_names, gb._obj.index.name])
        if series:
            return Series._from(out[names[0]], idx, gb._name)
        return DataFrame._from(Table(out), idx)


for _fn in _FUNCS:
    def _method(self, _fn=_fn):
        return self._reduce(_fn)
    _method.__name__ = _fn
    setattr(RollingGroupby, _fn, _method)
