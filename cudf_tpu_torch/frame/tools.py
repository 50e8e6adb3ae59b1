"""Top-level tools (port of ``cudf_tpu/frame/tools.py``): ``to_datetime``,
``to_numeric``, ``cut``, ``qcut``, ``date_range``, ``factorize``,
``unique``, ``isna`` / ``isnull`` and ``notna`` / ``notnull``.

Columns stay on their device: ``cut`` is one ``torch.searchsorted`` of
the values over the bin edges, its result a DICTIONARY32 over pandas'
interval labels (``labels=False``: the bin numbers); ``date_range`` is a
``torch.arange`` over the ticks of a fixed frequency.  pandas is imported
only for host input to ``to_datetime`` (lists and scalars), as the
reference does.  ``to_datetime`` and ``to_numeric`` of string columns
parse on the device (``ops/strings.py``); the calendar frequencies of
``date_range`` (month, quarter and year starts and ends) add months on
the device (``ops/datetime.py`` ``add_calendrical_months``).
"""

from __future__ import annotations

import re

import numpy as np
import torch

from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import Column, is_null_scalar
from cudf_tpu_torch.frame.index import Index
from cudf_tpu_torch.frame.series import BEYOND, Series
from cudf_tpu_torch.ops import reductions, unary
from cudf_tpu_torch.ops._utils import maybe_mask
from cudf_tpu_torch.ops.replace import nans_to_nulls
from cudf_tpu_torch.utils import tracing

# a calendar frequency: (months a step, anchored at the month's "start" or "end")
_CALENDAR = {"MS": (1, "start"), "ME": (1, "end"), "QS": (3, "start"), "QE": (3, "end"),
             "YS": (12, "start"), "YE": (12, "end")}
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


def to_datetime(arg, format=None, errors: str = "raise", unit=None, utc: bool = False, *,
                device=None):
    """A Series of timestamps as it is; of strings (or a dictionary of
    them), parsed on its device by ``ops/strings.py`` ``to_timestamps``
    (ISO 8601 or ``format``'s fixed-width fields; ``errors="coerce"``:
    NaT where a row does not parse, ``"ignore"``: the input back); of
    numbers, ticks of ``unit`` ("ns" by default; D, h and min land in
    seconds, as pandas gives them), a float's fraction kept in
    nanoseconds.  Host lists and scalars go through pandas' own
    ``to_datetime`` on the host (a list comes back as an Index on
    ``device``).  ``utc=True`` raises NotImplementedError (neither
    package has it)."""
    if utc:
        raise NotImplementedError(f"to_datetime(utc=True): {BEYOND}")
    if isinstance(arg, Series):
        col = arg._column
        if col.dtype.is_timestamp:
            return arg
        if col.dtype.is_string or col.dtype.is_dictionary:
            from cudf_tpu_torch.ops.strings import over_keys, to_timestamps

            try:
                return arg._new(over_keys(col, lambda c: to_timestamps(
                    c, format, "raise" if errors == "ignore" else errors)))
            except ValueError:
                if errors == "ignore":
                    return arg
                raise
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


def to_numeric(arg, errors: str = "raise", downcast=None):
    """Numbers as they are (a Series, or a host array or list of numbers
    as a numpy array), whatever ``errors`` says, as in pandas.  A Series of
    strings is parsed on its device (``ops/strings.py``
    ``parse_numbers``): int64 when every row is an integer and none is
    missing, else float64; a row that is no number raises ValueError, is
    NaN under ``errors="coerce"``, and gives the input back under
    ``"ignore"`` (pandas 2's option).  ``downcast`` ("integer", "signed",
    "unsigned" or "float") then narrows a Series to the smallest dtype of
    that kind that holds its values, by pandas' rules (``_downcast``)."""
    if errors not in ("raise", "coerce", "ignore"):
        raise ValueError("invalid error value specified")
    if downcast not in (None, "integer", "signed", "unsigned", "float"):
        raise ValueError("invalid downcasting method provided")
    if downcast is not None and isinstance(arg, Series):
        out = to_numeric(arg, errors)
        return _downcast(out, downcast) if out.dtype.is_numeric or out.dtype.is_bool else out
    if isinstance(arg, Series):
        if arg.dtype.is_numeric or arg.dtype.is_bool:
            return arg
        if not (arg.dtype.is_string or arg.dtype.is_dictionary):
            raise TypeError(f"to_numeric of a {arg.dtype!r} column")
        from cudf_tpu_torch.ops.strings import first_unparsed, over_keys, parse_numbers

        def parsed(col):
            ints, ok = parse_numbers(col, floats=False)
            if col.validity is None and tracing.to_bool(ok.all(), "cast_check"):
                return Column(dt.INT64, col.length, ints)
            vals, ok = parse_numbers(col, floats=True)
            bad = None if errors == "coerce" else first_unparsed(col, ok)
            if bad is not None:
                if errors == "ignore":
                    raise _Unparsed
                raise ValueError(f'Unable to parse string "{bad[1]}" at position {bad[0]}')
            return Column(dt.FLOAT64, col.length, vals, maybe_mask(ok))
        try:
            return arg._new(over_keys(arg._column, parsed))
        except _Unparsed:
            return arg
    arr = np.asarray(arg)
    if arr.dtype.kind in "biuf":
        return arr
    raise TypeError(f"to_numeric of host {arr.dtype} values: make a Series on a device first")


class _Unparsed(Exception):
    """A string that is no number under ``errors="ignore"``."""


_INTS = (torch.int8, torch.int16, torch.int32, torch.int64)
_UINTS = (torch.uint8, torch.uint16, torch.uint32, torch.uint64)


def _downcast(s: Series, downcast: str) -> Series:
    """pandas' ``to_numeric`` downcast: the first dtype of the kind, from
    the smallest, no wider than the column's, whose cast of the valid
    values stays within pandas' tolerance of them (integers: within 1e-8,
    and a float column with a missing value stays; float32: within 5e-4).
    Unsigned only when no value is negative; bools stay.  A host read a
    dtype tried."""
    col = s._column
    valid = col.data if col.validity is None else col.data[col.validity]
    x = valid.to(torch.float64)
    width = col.data.element_size()
    if downcast == "float":
        if width < 4 or col.dtype == dt.FLOAT32:
            return s                         # no float dtype narrower than float32
        f32 = x.to(torch.float32).to(torch.float64)
        close = ((f32 - x).abs() <= 5e-4).logical_or(f32.isnan() & x.isnan())
        if tracing.to_bool(close.all(), "cast_check"):
            return s._new(unary.cast(col, dt.FLOAT32))
        return s
    if col.dtype.is_bool or col.dtype.is_float and col.validity is not None:
        return s                 # numpy bools are no numbers; pandas' NaN blocks the cast
    if downcast == "unsigned":
        if valid.numel() and not tracing.to_bool((x >= 0).all(), "cast_check"):
            return s
        kinds = _UINTS
    else:
        kinds = _INTS
    for kind in kinds:
        size = torch.empty(0, dtype=kind).element_size()
        if size > width:
            break
        if kind == col.data.dtype:
            return s
        info = torch.iinfo(kind)
        inside = (x >= info.min) & (x <= info.max)
        whole = (x - x.trunc()).abs() <= 1e-8
        if valid.numel() == 0 or tracing.to_bool((inside & whole).all(), "cast_check"):
            return s._new(unary.cast(col, dt.from_torch(kind)))
    return s


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
    e = tracing.synced("host_values", values.device, torch.as_tensor, edges.astype(np.float64),
                       device=values.device)
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
        ticks = torch.from_numpy(np.linspace(a, b, int(periods)).astype(np.int64))
        ticks = tracing.synced("host_values", device, ticks.to, device)
        return Index(Column(dt.unit_dtype("M", unit), int(periods), ticks), name)
    m = re.fullmatch(r"(\d*)([A-Za-z]+)", freq or "D")
    if m is not None and m.group(2) in _CALENDAR:
        return _calendar_range(stamps, start, end, periods, int(m.group(1) or 1),
                               *_CALENDAR[m.group(2)], name, device)
    if m is None or m.group(2) not in _FIXED:
        raise NotImplementedError(f"date_range(freq={freq!r}): fixed and month, quarter and "
                                  f"year frequencies; business days and weeks are {BEYOND}")
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


def _calendar_range(stamps, start, end, periods, mult, months, side, name, device):
    """Month, quarter or year starts or ends (``mult`` of them a step)
    from ``start`` rolled forward, or back from ``end``: the anchors'
    months found on the host, their ticks made on the device by
    ``add_calendrical_months`` (an end is the next month's start less a
    day), each keeping the time of day of the endpoint, as pandas does."""
    from cudf_tpu_torch.ops.datetime import add_calendrical_months

    unit = max([np.datetime_data(st.dtype)[0] for st in stamps], key=_UNIT_ORDER.index)
    step = months * mult
    ends = side == "end"

    def anchor(month: int, tod) -> np.datetime64:    # months since 1970-01
        first = np.datetime64(month + ends, "M").astype("datetime64[D]")
        return (first - int(ends)).astype(f"datetime64[{unit}]") + tod

    def on_grid(month: int) -> bool:
        return (month + ends) % months == 0

    ref = stamps[0]
    tod = ref - ref.astype("datetime64[D]")
    month = int(ref.astype("datetime64[M]").astype(np.int64))
    if start is not None:
        while not on_grid(month) or anchor(month, tod) < ref:
            month += 1
        first = month
        if end is not None:
            count = 0
            while anchor(first + count * step, tod) <= stamps[1]:
                count += 1
        else:
            count = int(periods)
    elif end is not None:
        while not on_grid(month) or anchor(month, tod) > ref:
            month -= 1
        count = int(periods)
        first = month - (count - 1) * step
    else:
        raise ValueError("date_range needs two of start, end and periods")
    base = anchor(first, tod) + (np.timedelta64(1, "D") if ends else np.timedelta64(0, "D"))
    target = dt.unit_dtype("M", unit)
    col = Column(target, count, torch.full((count,), int(base.astype(np.int64)),
                                           dtype=torch.int64, device=device))
    steps = Column(dt.INT64, count, torch.arange(count, device=device) * step)
    out = add_calendrical_months(col, steps)
    if ends:
        day = int(np.timedelta64(1, "D").astype(f"timedelta64[{unit}]").astype(np.int64))
        out = Column(target, count, out.data - day)
    return Index(out, name)


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
