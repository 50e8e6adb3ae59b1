"""Calendar fields and rounding of timestamp columns (port of
``cudf_tpu/ops/datetime.py``).

Ticks split into days since the epoch, the second of the day and the
sub-second ticks; days become (year, month, day) by Howard Hinnant's
``civil_from_days`` (libcudf's algorithm too), all in int64 on the
column's device.  A tz-aware column's fields are its wall clock's
(``ops/timezone.py`` ``wall_clock_column``, applied by the caller).

Unlike the reference, ``is_leap_year``, ``is_month_start`` and
``is_month_end`` of a null row are False in a column without nulls, as
pandas gives them (the reference keeps the row null).
"""

from __future__ import annotations

import torch

from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.core import bitmask as bm
from cudf_tpu_torch.utils import tracing

_TICKS = {"s": 1, "ms": 1_000, "us": 1_000_000, "ns": 1_000_000_000}
_SECONDS_PER_DAY = 86_400
_DAYS_IN_MONTH = (31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31)
FIELDS = ("year", "month", "day", "hour", "minute", "second", "millisecond", "microsecond",
          "nanosecond", "weekday", "dayofyear", "quarter", "days_in_month", "is_leap_year",
          "is_month_start", "is_month_end")


def _fdiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


_DAY_IDS = (dt.TypeId.TIMESTAMP_DAYS, dt.TypeId.DURATION_DAYS)


def is_day_unit(dtype: dt.DType) -> bool:
    return dtype.id in _DAY_IDS


def days_as_seconds(col: Column) -> Column:
    """A day-unit column (int32 days) as the same instants (durations) in
    seconds, int64, as pandas holds ``datetime64[D]`` data; any other
    column as it is."""
    if not is_day_unit(col.dtype):
        return col
    kind = "M" if col.dtype.is_timestamp else "m"
    return Column(dt.unit_dtype(kind, "s"), col.length, col.data.long() * _SECONDS_PER_DAY,
                  col.validity)


def to_days(col: Column, target: dt.DType) -> Column:
    """A timestamp (duration) column floored to whole days, int32: the cast
    into ``target``, a day-unit dtype."""
    ticks = days_as_seconds(col)
    per_day = _TICKS[ticks.dtype.time_unit] * _SECONDS_PER_DAY
    return Column(target, col.length, _fdiv(ticks.data, per_day).to(torch.int32), col.validity)


def days_and_time(ticks: torch.Tensor, unit: str):
    """(days since the epoch, second of the day, sub-second ticks, ticks
    a second), floored, in int64."""
    tps = _TICKS[unit]
    t = ticks.long()
    days = _fdiv(t, tps * _SECONDS_PER_DAY)
    rem = t - days * (tps * _SECONDS_PER_DAY)
    secs = _fdiv(rem, tps)
    return days, secs, rem - secs * tps, tps


def civil_from_days(z: torch.Tensor):
    """Days since 1970-01-01 -> (year, month, day)."""
    z = z + 719468
    era = _fdiv(z, 146097)
    doe = z - era * 146097                                         # [0, 146096]
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)                # [0, 365]
    mp = (5 * doy + 2) // 153                                      # [0, 11]
    d = doy - (153 * mp + 2) // 5 + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    y = yoe + era * 400 + (m <= 2).long()
    return y, m, d


def days_from_civil(y, m, d):
    y = y - (m <= 2).long()
    era = _fdiv(y, 400)
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = (153 * mp + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def is_leap(y):
    return (y % 4 == 0) & ((y % 100 != 0) | (y % 400 == 0))


def days_in_month(y, m):
    base = tracing.synced("host_values", m.device, torch.tensor, _DAYS_IN_MONTH, dtype=torch.int64,
                          device=m.device)[m - 1]
    return torch.where((m == 2) & is_leap(y), 29, base)


def extract(col: Column, field: str) -> Column:
    """One calendar field of a naive timestamp column (``FIELDS``): int32,
    or bool for the ``is_*`` fields (False on a null row)."""
    if field not in FIELDS:
        raise ValueError(f"unknown datetime field {field!r}")
    days, secs, sub, tps = days_and_time(col.data, col.dtype.time_unit)
    if field in ("hour", "minute", "second"):
        out = {"hour": secs // 3600, "minute": secs % 3600 // 60, "second": secs % 60}[field]
    elif field == "millisecond":
        out = sub * 1000 // tps
    elif field == "microsecond":
        out = sub * 1_000_000 // tps if tps <= 1_000_000 else sub // (tps // 1_000_000)
    elif field == "nanosecond":
        out = sub % 1000 if tps == 1_000_000_000 else torch.zeros_like(sub)
    elif field == "weekday":                            # Monday = 0
        out = (days + 3) % 7
    else:
        y, m, d = civil_from_days(days)
        if field == "year":
            out = y
        elif field == "month":
            out = m
        elif field == "day":
            out = d
        elif field == "quarter":
            out = (m - 1) // 3 + 1
        elif field == "dayofyear":
            out = days - days_from_civil(y, torch.ones_like(m), torch.ones_like(d)) + 1
        elif field == "days_in_month":
            out = days_in_month(y, m)
        elif field == "is_leap_year":
            out = is_leap(y)
        elif field == "is_month_start":
            out = d == 1
        else:                                           # is_month_end
            out = d == days_in_month(y, m)
    if field.startswith("is_"):
        if col.validity is not None:
            out = out & col.validity
        return Column(dt.BOOL8, col.length, out)
    return Column(dt.INT32, col.length, out.to(torch.int32), col.validity)


_FREQ_NS = {"D": 86_400 * 10 ** 9, "h": 3_600 * 10 ** 9, "H": 3_600 * 10 ** 9,
            "min": 60 * 10 ** 9, "T": 60 * 10 ** 9, "s": 10 ** 9, "S": 10 ** 9,
            "ms": 10 ** 6, "L": 10 ** 6, "us": 10 ** 3, "U": 10 ** 3, "ns": 1, "N": 1}


def freq_ticks(freq: str, unit: str) -> int:
    """Ticks of ``unit`` in a fixed frequency ("D", "h", "15min", "2s" ...)."""
    digits = len(freq) - len(freq.lstrip("0123456789"))
    mult = int(freq[:digits]) if digits else 1
    name = freq[digits:]
    if name not in _FREQ_NS:
        raise ValueError(f"{freq!r} is a non-fixed frequency")
    ns = _FREQ_NS[name] * mult
    per = 10 ** 9 // _TICKS[unit]
    if ns % per:
        raise ValueError(f"freq {freq!r} is finer than the column's unit {unit!r}")
    return ns // per


def _rounded(col: Column, ticks: torch.Tensor) -> Column:
    return Column(col.dtype, col.length, ticks, col.validity)


def _wall_rounding(col: Column, fn) -> Column:
    """Round a tz-aware column on its wall clock (pandas), then back to UTC."""
    if col.dtype.tz is None:
        return _rounded(col, fn(col.data))
    from cudf_tpu_torch.ops import timezone

    unit, tz = col.dtype.time_unit, col.dtype.tz
    wall = timezone.utc_to_wall_ticks(col.data, tz, unit)
    return _rounded(col, timezone.wall_to_utc_ticks(fn(wall), tz, unit))


def floor(col: Column, freq: str) -> Column:
    step = freq_ticks(freq, col.dtype.time_unit)
    return _wall_rounding(col, lambda t: _fdiv(t, step) * step)


def ceil(col: Column, freq: str) -> Column:
    step = freq_ticks(freq, col.dtype.time_unit)
    return _wall_rounding(col, lambda t: -_fdiv(-t, step) * step)


def round(col: Column, freq: str) -> Column:  # noqa: A001
    """Half to even on the frequency's grid (pandas' ``dt.round``)."""
    step = freq_ticks(freq, col.dtype.time_unit)

    def half_even(t):
        q = _fdiv(t, step)
        twice = 2 * (t - q * step)
        up = (twice > step) | ((twice == step) & (q % 2 == 1))
        return (q + up.long()) * step
    return _wall_rounding(col, half_even)


def add_calendrical_months(col: Column, months) -> Column:
    """cudf::datetime::add_calendrical_months: the day clamped to the
    new month's last; ``months`` an int or an integer column."""
    days, secs, sub, tps = days_and_time(col.data, col.dtype.time_unit)
    y, m, d = civil_from_days(days)
    add = months.data.long() if isinstance(months, Column) else months
    mm = m - 1 + add
    y2, m2 = y + _fdiv(mm, 12), mm % 12 + 1
    d2 = torch.minimum(d, days_in_month(y2, m2))
    ticks = (days_from_civil(y2, m2, d2) * _SECONDS_PER_DAY + secs) * tps + sub
    validity = col.validity
    if isinstance(months, Column):
        validity = bm.and_masks(validity, months.validity)
    return Column(col.dtype, col.length, ticks, validity)


def strftime_parts(col: Column) -> dict:
    """Every field a strftime format reads, int64 [n], of a timestamp
    column's wall clock (a tz-aware column's in its zone): the calendar
    and clock fields, ``year2``, ``hour12``, ``doy``, ``weekday``, ``ampm``,
    the sub-second ``milli`` / ``micro`` / ``nano``, ``offset_sec`` (the
    UTC offset in seconds: local mean time offsets have seconds), the
    weekday from Sunday (``wday_sun``, %w) and ISO's (``wday_iso``, %u),
    the weeks of %U and %W and the ISO year and week (%G, %V)."""
    ticks = col.data
    if col.dtype.tz is not None:
        from cudf_tpu_torch.ops import timezone

        ticks = timezone.utc_to_wall_ticks(col.data, col.dtype.tz, col.dtype.time_unit)
    days, secs, sub, tps = days_and_time(ticks, col.dtype.time_unit)
    y, m, d = civil_from_days(days)
    hour = secs // 3600
    ns = sub * (10 ** 9 // tps)
    weekday = (days + 3) % 7                                       # Monday = 0
    doy = days - days_from_civil(y, torch.ones_like(m), torch.ones_like(d)) + 1
    # ISO 8601: the week (Monday first) belongs to the year of its Thursday
    thursday = days - weekday + 3
    iso_year, _, _ = civil_from_days(thursday)
    iso_jan1 = days_from_civil(iso_year, torch.ones_like(m), torch.ones_like(d))
    return {"year": y, "month": m, "day": d, "hour": hour, "minute": secs % 3600 // 60,
            "second": secs % 60, "year2": y % 100, "hour12": (hour + 11) % 12 + 1,
            "doy": doy, "micro": ns // 1000, "milli": ns // 10 ** 6, "nano": ns,
            "weekday": weekday, "ampm": (hour >= 12).long(),
            "wday_sun": (weekday + 1) % 7, "wday_iso": weekday + 1,
            "week_sun": (doy - 1 + 7 - (weekday + 1) % 7) // 7,
            "week_mon": (doy - 1 + 7 - weekday) // 7,
            "iso_year": iso_year, "iso_week": (thursday - iso_jan1) // 7 + 1,
            "offset_sec": (ticks - col.data) // tps}
