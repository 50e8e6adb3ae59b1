"""Top-level tools (port of ``cudf_tpu/frame/tools.py``): ``to_datetime``,
``to_numeric``, ``cut``, ``qcut``, ``date_range``, ``factorize``,
``unique``, ``isna`` / ``isnull`` and ``notna`` / ``notnull``.

Columns stay on their device: ``cut`` is one ``torch.searchsorted`` of
the values over the bin edges, its result a DICTIONARY32 over pandas'
interval labels (``labels=False``: the bin numbers); ``date_range`` is a
``torch.arange`` over the ticks of a fixed frequency.  pandas is imported
only for host input to ``to_datetime`` (lists and scalars), as the
reference does; string columns wait on ``ops/strings.py`` (ROADMAP.md
queue 1, item 6) and calendar frequencies on ``ops/datetime.py`` (item 2).
"""

from __future__ import annotations

import re

import numpy as np
import torch

from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import Column, is_null_scalar
from cudf_tpu_torch.frame.index import Index
from cudf_tpu_torch.frame.series import Series, where_ported
from cudf_tpu_torch.ops import reductions
from cudf_tpu_torch.ops._utils import maybe_mask
from cudf_tpu_torch.ops.replace import nans_to_nulls

STRINGS = where_ported(6)
CALENDAR = where_ported(2)
# a numeric to_datetime unit: (the timestamp unit it lands in, ticks a step)
_TO_DATETIME_UNITS = {"D": ("s", 86400), "h": ("s", 3600), "m": ("s", 60), "min": ("s", 60),
                      "s": ("s", 1), "ms": ("ms", 1), "us": ("us", 1), "ns": ("ns", 1)}
_NS_PER = {"s": 10 ** 9, "ms": 10 ** 6, "us": 10 ** 3, "ns": 1}
# a fixed frequency's alias: (the coarsest timestamp unit that holds it, ticks)
_FIXED = {"D": ("s", 86400), "h": ("s", 3600), "H": ("s", 3600), "min": ("s", 60),
          "T": ("s", 60), "s": ("s", 1), "S": ("s", 1), "ms": ("ms", 1), "L": ("ms", 1),
          "us": ("us", 1), "U": ("us", 1), "ns": ("ns", 1), "N": ("ns", 1)}
_UNIT_ORDER = ("s", "ms", "us", "ns")


def _as_series(values, device=None) -> Series:
    return values if isinstance(values, Series) else Series(values, device=device)


def to_datetime(arg, format=None, errors: str = "raise", unit=None, *, device=None):
    """A Series of timestamps as it is; of numbers, ticks of ``unit``
    ("ns" by default; D, h and min land in seconds, as pandas gives
    them), a float's fraction kept in nanoseconds.  Host lists and
    scalars go through pandas' own ``to_datetime`` on the host (a list
    comes back as an Index on ``device``)."""
    if isinstance(arg, Series):
        col = arg._column
        if col.dtype.is_timestamp:
            return arg
        if col.dtype.is_string or col.dtype.is_dictionary:
            raise NotImplementedError(f"to_datetime of strings: {STRINGS}")
        if not (col.dtype.is_numeric or col.dtype.is_bool):
            raise TypeError(f"to_datetime of a {col.dtype!r} column")
        land, step = _TO_DATETIME_UNITS[unit or "ns"]
        if col.dtype.is_float:
            x = col.data.double() * (step * _NS_PER[land])
            valid = torch.isfinite(x)
            if col.validity is not None:
                valid &= col.validity
            ticks, target = torch.round(torch.where(valid, x, 0.0)).long(), dt.TIMESTAMP_NS
        else:
            valid, ticks = col.validity, col.data.long() * step
            target = dt.unit_dtype("M", land)
        return arg._new(Column(target, len(arg), ticks, maybe_mask(valid)))
    import pandas as pd

    out = pd.to_datetime(arg, format=format, errors=errors, unit=unit)
    if isinstance(out, (pd.Series, pd.Index)):
        if device is None:
            raise ValueError("a list to_datetime needs an explicit device=")
        return Index(Column.from_numpy(out.to_numpy(), device=device))
    return out


def to_numeric(arg, errors: str = "raise"):
    """Numbers as they are (a Series, or a host array or list of numbers
    as a numpy array), whatever ``errors`` says, as in pandas; strings
    wait on ``ops/strings.py``."""
    if isinstance(arg, Series):
        if arg.dtype.is_numeric or arg.dtype.is_bool:
            return arg
        raise NotImplementedError(f"to_numeric of a {arg.dtype!r} column: {STRINGS}")
    arr = np.asarray(arg)
    if arr.dtype.kind in "biuf":
        return arr
    raise NotImplementedError(f"to_numeric of {arr.dtype} values: {STRINGS}")


def _round_frac(x, precision: int):
    """pandas' rounding of a bin edge for its label: ``precision``
    significant digits after the leading zeros of a fraction."""
    if not np.isfinite(x) or x == 0:
        return x
    frac, whole = np.modf(x)
    digits = -int(np.floor(np.log10(abs(frac)))) - 1 + precision if whole == 0 else precision
    return np.around(x, digits)


def _interval_labels(edges: np.ndarray, right: bool, include_lowest: bool,
                     precision: int = 3) -> list:
    """pandas' interval labels of the bins (``IntervalIndex`` as text):
    the smallest precision from ``precision`` up that keeps the edges
    apart, the first edge lowered by 10**-precision when it is included."""
    for prec in range(precision, 20):
        if np.unique([_round_frac(b, prec) for b in edges]).size == edges.size:
            precision = prec
            break
    breaks = [_round_frac(b, precision) for b in edges]
    if right and include_lowest:
        breaks[0] = breaks[0] - 10 ** (-precision)
    if all(isinstance(b, (int, np.integer)) for b in breaks):
        text = [str(int(b)) for b in breaks]
    else:
        text = [str(float(b)) for b in breaks]
    lo, hi = ("(", "]") if right else ("[", ")")
    return [f"{lo}{a}, {b}{hi}" for a, b in zip(text[:-1], text[1:])]


def cut(x, bins, right: bool = True, labels=None, precision: int = 3,
        include_lowest: bool = False, *, device=None) -> Series:
    """pandas' cut: each value's bin, by a search of the edges on the
    values' device.  ``bins`` an int (that many equal bins over the
    values' range, widened by 0.1% on the open side, as pandas) or the
    edges; a value outside every bin is null.  The result is a
    DICTIONARY32 over pandas' interval labels (or ``labels``), or with
    ``labels=False`` the bin numbers."""
    s = _as_series(x, device)
    col = nans_to_nulls(s._column)
    if isinstance(bins, (int, np.integer)):
        mn, mx = float(reductions.min(col)), float(reductions.max(col))
        if mn == mx:                                  # pandas widens a point by 0.1%
            pad = 0.001 * abs(mn) if mn else 0.001
            edges = np.linspace(mn - pad, mx + pad, int(bins) + 1)
        else:
            edges = np.linspace(mn, mx, int(bins) + 1)
            adj = (mx - mn) * 0.001
            if right:
                edges[0] -= adj
            else:
                edges[-1] += adj
    else:
        edges = np.asarray(bins)
        if np.any(np.diff(edges.astype(np.float64)) <= 0):
            raise ValueError("bins must increase monotonically and be unique")
    values = col.data.double()
    e = torch.as_tensor(edges.astype(np.float64), device=values.device)
    pos = torch.searchsorted(e, values, right=not right) - 1
    if include_lowest:
        pos = torch.where(values == e[0], 0, pos)
    ok = (pos >= 0) & (pos < len(edges) - 1)
    if col.validity is not None:
        ok &= col.validity
    valid = maybe_mask(ok)
    if labels is False:
        return s._new(Column(dt.INT64, len(s), torch.where(ok, pos, 0), valid))
    cats = _interval_labels(edges, right, include_lowest, precision) if labels is None \
        else [str(lab) for lab in labels]
    if len(cats) != len(edges) - 1:
        raise ValueError("labels must be one fewer than the number of bin edges")
    keys = Column.from_strings(cats, device=values.device)
    return s._new(Column.from_dictionary(torch.where(ok, pos, 0), keys, valid))


def qcut(x, q, labels=None, precision: int = 3, *, device=None) -> Series:
    """pandas' qcut: ``cut`` at the values' quantiles (``q`` a count of
    equal-sized bins or the quantiles), the lowest edge included."""
    s = _as_series(x, device)
    qs = np.linspace(0, 1, int(q) + 1) if isinstance(q, (int, np.integer)) else np.asarray(q)
    edges = np.asarray(s.quantile([float(v) for v in qs]).to_numpy(), dtype=np.float64)
    if np.unique(edges).size != edges.size:
        raise ValueError(f"Bin edges must be unique: {edges.tolist()}")
    return cut(s, edges, labels=labels, precision=precision, include_lowest=True)


def _stamp(value):
    """A host timestamp as numpy's datetime64: a string or datetime in
    microseconds (pandas 3's unit for them), numpy's and pandas' own in
    theirs (at least seconds)."""
    if isinstance(value, np.datetime64):
        stamp = value
    elif hasattr(value, "to_datetime64"):
        stamp = value.to_datetime64()
    else:
        stamp = np.datetime64(value, "us")
    if np.datetime_data(stamp.dtype)[0] not in _UNIT_ORDER:
        stamp = stamp.astype("datetime64[s]")
    return stamp


def date_range(start=None, end=None, periods=None, freq=None, name=None, *,
               device=None) -> Index:
    """pandas' date_range for fixed frequencies (a multiple of D, h, min,
    s, ms, us or ns): ``torch.arange`` over the ticks on ``device``, in the
    finer of the endpoints' unit and the frequency's.  Without ``freq``,
    ``periods`` stamps spread evenly from ``start`` to ``end``.  Calendar
    frequencies (month, year, business day ...) wait on
    ``ops/datetime.py``."""
    if device is None:
        raise ValueError("date_range needs an explicit device=")
    given = [v for v in (start, end) if v is not None]
    stamps = [_stamp(v) for v in given]
    units = [np.datetime_data(st.dtype)[0] for st in stamps]
    if freq is None and periods is not None and len(given) == 2:
        unit = max(units, key=_UNIT_ORDER.index)
        a, b = (int(st.astype(f"datetime64[{unit}]").astype(np.int64)) for st in stamps)
        ticks = torch.from_numpy(np.linspace(a, b, int(periods)).astype(np.int64)).to(device)
        return Index(Column(dt.unit_dtype("M", unit), int(periods), ticks), name)
    m = re.fullmatch(r"(\d*)([A-Za-z]+)", freq or "D")
    if m is None or m.group(2) not in _FIXED:
        raise NotImplementedError(f"date_range(freq={freq!r}): fixed frequencies only; "
                                  f"calendar frequencies are {CALENDAR} (ops/datetime.py)")
    funit, per = _FIXED[m.group(2)]
    unit = max(units + [funit], key=_UNIT_ORDER.index)
    step = int(m.group(1) or 1) * per * _NS_PER[funit] // _NS_PER[unit]
    ticks = [int(st.astype(f"datetime64[{unit}]").astype(np.int64)) for st in stamps]
    if start is not None and end is not None:
        first, count = ticks[0], (ticks[1] - ticks[0]) // step + 1
    elif start is not None:
        first, count = ticks[0], int(periods)
    elif end is not None:
        first, count = ticks[0] - (int(periods) - 1) * step, int(periods)
    else:
        raise ValueError("date_range needs two of start, end and periods")
    data = first + step * torch.arange(max(count, 0), dtype=torch.int64, device=device)
    return Index(Column(dt.unit_dtype("M", unit), data.shape[0], data), name)


def factorize(values, sort: bool = False, *, device=None):
    """(int64 codes, -1 for a missing value; the distinct values as an
    Index): ``Series.factorize``."""
    return _as_series(values, device).factorize(sort=sort)


def unique(values, *, device=None) -> np.ndarray:
    """The distinct values in order of appearance: ``Series.unique``."""
    return _as_series(values, device).unique()


def isna(obj):
    """Missing values: a Series or frame's own ``isna``, an Index's as a
    numpy array, a host scalar's as a bool, a host list's as a numpy
    array."""
    if isinstance(obj, Index):
        return Series._from(obj.column(obj.device), obj).isna().to_numpy()
    if hasattr(obj, "isna"):
        return obj.isna()
    if np.isscalar(obj) or obj is None or is_null_scalar(obj):
        return bool(is_null_scalar(obj))
    return np.array([bool(is_null_scalar(v)) for v in obj])


isnull = isna


def notna(obj):
    out = isna(obj)
    return (not out) if isinstance(out, bool) else ~out


notnull = notna
