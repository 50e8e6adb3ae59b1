"""IANA time zones on the device (port of ``cudf_tpu/ops/timezone.py``).

The zone's TZif file (RFC 8536, the v2+ 64-bit section, and its footer's
POSIX TZ rule for the years after the last listed transition, which the
reference drops: it keeps the last offset, so New York stays on summer
time after 2037) is read once on the host from ``$TZDIR`` (default
``/usr/share/zoneinfo``); a conversion
is one ``torch.searchsorted`` of the ticks over the transitions and one
gather of the offsets, on the ticks' device.  The tables are cached per
(zone, unit, device).

Ambiguous and missing wall times (the hour a clock repeats or skips)
take the offset after the transition, as the reference and libcudf do;
pandas raises by default there.
"""

from __future__ import annotations

import datetime as _datetime
import os
import re
import struct
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import Column

_TICKS = {"s": 1, "ms": 1_000, "us": 1_000_000, "ns": 1_000_000_000}
_UTC = ("UTC", "utc", "GMT", "Etc/UTC")
_EPOCH = _datetime.date(1970, 1, 1)


def tzdir() -> str:
    return os.environ.get("TZDIR", "/usr/share/zoneinfo")


@lru_cache(maxsize=128)
def load_transitions(tz: str) -> Tuple[np.ndarray, np.ndarray]:
    """(transitions int64[t] in UTC seconds, offsets int64[t + 1] in
    seconds): offsets[i] holds before transitions[i], offsets[t] after
    the last one."""
    if tz in _UTC:
        return np.zeros(0, np.int64), np.zeros(1, np.int64)
    root = os.path.realpath(tzdir())
    path = os.path.realpath(os.path.join(root, tz))
    if not path.startswith(root + os.sep) or not os.path.isfile(path):
        raise ValueError(f"unknown time zone {tz!r} (no TZif file under {tzdir()})")
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"TZif":
        raise ValueError(f"not a TZif file: {path}")

    def block(pos, tsize, fmt):
        isut, isstd, leap, timecnt, typecnt, charcnt = struct.unpack(">6I", data[pos:pos + 24])
        pos += 24
        times = np.frombuffer(data, fmt, timecnt, pos).astype(np.int64)
        pos += timecnt * tsize
        idx = np.frombuffer(data, np.uint8, timecnt, pos)
        pos += timecnt
        types = [struct.unpack(">iBB", data[pos + 6 * i:pos + 6 * i + 6])[:2]
                 for i in range(typecnt)]
        pos += 6 * typecnt + charcnt + leap * (tsize + 4) + isstd + isut
        return times, idx, types, pos

    times, idx, types, pos = block(20, 4, ">i4")
    footer = b""
    if data[4:5] >= b"2":               # the 64-bit block follows the 32-bit one
        times, idx, types, pos = block(pos + 20, 8, ">i8")
        footer = data[pos:].strip(b"\n").split(b"\n")[0]
    if not types:
        return np.zeros(0, np.int64), np.zeros(1, np.int64)
    # before the first transition: the first standard-time type, else type 0
    first = next((off for off, isdst in types if not isdst), types[0][0])
    offsets = [first] + [types[i][0] for i in idx]
    times = times.tolist()
    # past the last transition the footer's POSIX TZ rule holds (RFC 8536
    # section 3.3): its transitions, year by year, up to LAST_RULE_YEAR
    for at, off in _rule_transitions(footer.decode("ascii", "replace"),
                                     times[-1] if times else None):
        times.append(at)
        offsets.append(off)
    return np.array(times, np.int64), np.array(offsets, np.int64)


LAST_RULE_YEAR = 2200
_POSIX = re.compile(r"(<[^>]*>|[A-Za-z]+)([+-]?[\d:]+)(?:(<[^>]*>|[A-Za-z]+)([+-]?[\d:]+)?"
                    r"(?:,([^,]+),([^,]+))?)?")


def _seconds(text: str) -> int:
    sign = -1 if text.startswith("-") else 1
    parts = [int(p) for p in text.lstrip("+-").split(":")]
    return sign * sum(p * m for p, m in zip(parts, (3600, 60, 1)))


def _rule_day(year: int, rule: str) -> int:
    """Days since the epoch of a POSIX date rule (Mm.w.d, Jn or n) in ``year``."""
    jan1 = (_datetime.date(year, 1, 1) - _EPOCH).days
    if rule.startswith("M"):
        month, week, weekday = (int(v) for v in rule[1:].split("."))
        first = (_datetime.date(year, month, 1) - _EPOCH).days
        day = first + (weekday - (first + 4) % 7) % 7 + 7 * (week - 1)   # 1970-01-01: a Thursday
        nxt = (_datetime.date(year + month // 12, month % 12 + 1, 1) - _EPOCH).days
        while day >= nxt:
            day -= 7
        return day
    if rule.startswith("J"):                    # 1..365, February 29 never counted
        n = int(rule[1:])
        leap = year % 4 == 0 and (year % 100 != 0 or year % 400 == 0)
        return jan1 + n - 1 + (leap and n >= 60)
    return jan1 + int(rule)


def _rule_transitions(footer: str, after):
    """(UTC second, offset after it) of every transition of the POSIX TZ
    rule ``footer`` later than ``after``, through LAST_RULE_YEAR."""
    m = _POSIX.fullmatch(footer)
    if m is None or not m.group(5):
        return []
    std = -_seconds(m.group(2))
    dst = -_seconds(m.group(4)) if m.group(4) else std + 3600
    rules = []
    for text in (m.group(5), m.group(6)):
        date, _, at = text.partition("/")
        rules.append((date, _seconds(at) if at else 7200))
    start_year = 1970 if after is None else \
        (_EPOCH + _datetime.timedelta(seconds=after)).year
    out = []
    for year in range(start_year, LAST_RULE_YEAR + 1):
        to_dst = _rule_day(year, rules[0][0]) * 86400 + rules[0][1] - std
        to_std = _rule_day(year, rules[1][0]) * 86400 + rules[1][1] - dst
        out += sorted([(to_dst, dst), (to_std, std)])
    return [(at, off) for at, off in out if after is None or at > after]


def _tables(tz: str, unit: str, device) -> Tuple[torch.Tensor, torch.Tensor]:
    return _device_tables(tz, unit, str(torch.device(device)))


@lru_cache(maxsize=64)
def _device_tables(tz: str, unit: str, device: str):
    trans, offs = load_transitions(tz)
    mult = _TICKS[unit]
    return (torch.from_numpy(trans * mult).to(device),
            torch.from_numpy(offs * mult).to(device))


def utc_to_wall_ticks(ticks: torch.Tensor, tz: str, unit: str) -> torch.Tensor:
    trans, offs = _tables(tz, unit, ticks.device)
    if trans.numel() == 0:
        return ticks + offs[0]
    return ticks + offs[torch.searchsorted(trans, ticks, right=True)]


def wall_to_utc_ticks(ticks: torch.Tensor, tz: str, unit: str) -> torch.Tensor:
    trans, offs = _tables(tz, unit, ticks.device)
    if trans.numel() == 0:
        return ticks - offs[0]
    # each transition's instant on the wall clock after it
    wall = trans + offs[1:]
    return ticks - offs[torch.searchsorted(wall, ticks, right=True)]


@lru_cache(maxsize=128)
def abbreviations(tz: str) -> Tuple[str, ...]:
    """The zone's abbreviation ("EST", "EDT" ...) in force with each of
    ``load_transitions(tz)``'s offsets, read by the standard library's
    ``zoneinfo`` from the same TZif file."""
    import datetime as _dt
    import zoneinfo

    trans, offs = load_transitions(tz)
    if tz in _UTC:
        return ("UTC",) * offs.shape[0]
    with open(os.path.join(os.path.realpath(tzdir()), tz), "rb") as f:
        zone = zoneinfo.ZoneInfo.from_file(f, key=tz)
    lo, hi = -62135510400, 253402214400          # 0001-01-02 .. 9999-12-30
    at = [int(trans[0]) - 1 if trans.shape[0] else 0] + [int(t) for t in trans]
    return tuple(_dt.datetime.fromtimestamp(min(max(t, lo), hi), zone).tzname() for t in at)


def abbreviation_ids(ticks: torch.Tensor, tz: str, unit: str) -> torch.Tensor:
    """Each UTC instant's index into ``abbreviations(tz)``."""
    trans, _ = _tables(tz, unit, ticks.device)
    if trans.numel() == 0:
        return torch.zeros_like(ticks)
    return torch.searchsorted(trans, ticks, right=True)


def tz_localize(col: Column, tz, ambiguous="raise", nonexistent="raise") -> Column:
    """Naive wall-clock timestamps -> tz-aware (UTC ticks); ``None`` drops
    the zone of a tz-aware column, keeping its wall clock (pandas).

    A wall time in a fold (it happens twice) or a gap (it never happens)
    is decided as pandas decides it: ``ambiguous`` is "raise", "NaT" or a
    bool per row (True: the first of the two, daylight time);
    ``nonexistent`` is "raise", "NaT", "shift_forward" (to the first
    instant after the gap) or "shift_backward" (to the last before it).
    "infer" and a timedelta raise NotImplementedError, whatever the rows
    (neither package has them).
    One host sync when a zone has transitions (whether any row is in a
    fold or a gap)."""
    if not col.dtype.is_timestamp:
        raise TypeError("tz_localize needs timestamps")
    if isinstance(ambiguous, str) and ambiguous == "infer":
        raise NotImplementedError("tz_localize(ambiguous='infer'): ROADMAP.md, beyond the "
                                  "reference")
    if not isinstance(nonexistent, str):
        raise NotImplementedError(f"tz_localize(nonexistent={nonexistent!r}): ROADMAP.md, "
                                  "beyond the reference")
    if col.dtype.tz is not None:
        if tz is None:
            return Column(dt.DType(col.dtype.id), col.length,
                          utc_to_wall_ticks(col.data, col.dtype.tz, col.dtype.time_unit),
                          col.validity)
        raise TypeError("Already tz-aware, use tz_convert to convert.")
    if tz is None:
        return col
    tz = str(tz)
    out = dt.DType(col.dtype.id, tz=tz)
    trans, offs = _tables(tz, col.dtype.time_unit, col.device)
    if trans.numel() == 0:
        return Column(out, col.length, col.data - offs[0], col.validity)
    w = col.data
    # interval k (offset offs[k]) covers the wall times
    # [trans[k - 1] + offs[k], trans[k] + offs[k]); k is the last to start by w
    k = torch.searchsorted(trans + offs[1:], w, right=True)
    big = torch.iinfo(torch.int64).max
    end = torch.cat([trans, torch.tensor([big], device=w.device)]) + \
        torch.cat([offs[:-1], torch.zeros(1, dtype=offs.dtype, device=w.device)])
    end_prev = torch.where(k > 0, end[(k - 1).clamp(min=0)], torch.iinfo(torch.int64).min)
    utc = w - offs[k]
    live = torch.ones_like(w, dtype=torch.bool) if col.validity is None else col.validity
    gap = live & (w >= end[k])
    fold = live & (w < end_prev)
    validity = col.validity
    bad_gap, bad_fold = torch.stack([gap.any(), fold.any()]).tolist()
    if bad_fold:
        if isinstance(ambiguous, str):
            if ambiguous == "raise":
                raise ValueError(f"Cannot infer dst time from {_wall_text(col, fold)}, try "
                                 "using the 'ambiguous' argument")
            if ambiguous != "NaT":
                raise NotImplementedError(f"tz_localize(ambiguous={ambiguous!r}): "
                                          "ROADMAP.md, beyond the reference")
            validity = _null_where(validity, fold)
        else:
            first = torch.as_tensor(np.asarray(ambiguous, bool), device=w.device)
            utc = torch.where(fold & first, w - offs[(k - 1).clamp(min=0)], utc)
    if bad_gap:
        if nonexistent == "raise":
            raise ValueError(f"{_wall_text(col, gap)} is a nonexistent time in {tz}")
        if nonexistent == "NaT":
            validity = _null_where(validity, gap)
        elif nonexistent in ("shift_forward", "shift_backward"):
            after = trans[k.clamp(max=trans.numel() - 1)]
            utc = torch.where(gap, after - int(nonexistent == "shift_backward"), utc)
        else:
            raise NotImplementedError(f"tz_localize(nonexistent={nonexistent!r}): "
                                      "ROADMAP.md, beyond the reference")
    return Column(out, col.length, utc, validity)


def _null_where(validity, rows: torch.Tensor) -> torch.Tensor:
    return ~rows if validity is None else validity & ~rows


def _wall_text(col: Column, rows: torch.Tensor) -> str:
    at = int(torch.nonzero(rows)[0, 0])
    return str(np.int64(col.data[at].item()).astype(col.dtype.to_numpy()))


def tz_convert(col: Column, tz) -> Column:
    """tz-aware -> another zone: the UTC ticks stay, the zone changes
    (``None``: naive UTC wall clock, as pandas)."""
    if col.dtype.tz is None:
        raise TypeError("Cannot convert tz-naive timestamps, use tz_localize to localize")
    if tz is not None:
        load_transitions(str(tz))        # the zone must exist
    return Column(dt.DType(col.dtype.id, tz=None if tz is None else str(tz)), col.length,
                  col.data, col.validity)


def wall_clock_column(col: Column) -> Column:
    """A tz-aware column's local wall-clock ticks as a naive column (what
    the calendar fields read)."""
    if col.dtype.tz is None:
        return col
    return Column(dt.DType(col.dtype.id), col.length,
                  utc_to_wall_ticks(col.data, col.dtype.tz, col.dtype.time_unit), col.validity)
