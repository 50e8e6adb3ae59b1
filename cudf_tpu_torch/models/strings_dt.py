"""The string and temporal requests on the card: the ``str`` accessor
over db-benchmark G1's ``id3`` as text, the ``dt`` accessor over TPC-H's
``l_shipdate``, and the groupbys pandas users write on keys made from
them, each beside a plain PyTorch version written apart from the port.

- ``frames`` holds ``g1`` (G1's columns: ``id1`` and ``id3`` DICTIONARY32
  over "id001".."id100" and "id0000000001"..., ``v1`` in 1..5, ``v3`` in
  [0, 100)) and ``id3s`` (``g1["id3"].astype(str)``: the first request,
  made by ``prepare``), or ``lineitem`` (TPC-H's, ``l_shipdate`` midnight
  timestamps) and ``ship_text`` (``l_shipdate.dt.strftime("%Y-%m-%d")``).
- ``REQUESTS[name](frames)`` is the call a pandas user writes;
  ``ANSWERS[name](result, frames)`` and ``PLAIN[name](frames)`` give the
  same ``{key: tensor}``: a STRING column as its bytes and offsets (and
  validity where it has nulls), other columns as their values, a
  groupby as its keys and sums.  The ``dict_*`` requests run the ``str``
  methods on the dictionary ``id3`` itself and must give what the same
  request gives over ``id3s``.
- ``NEEDS[name]`` are the kernels a request must launch (the groupbys
  by a category or the year take the kernel tiers; the STRING key the
  sort tier, none), ``RTOL[name]`` the float tolerance (sums 1e-12, the
  rest exact), ``ROUTE[name]`` the ``STRING_ROUTES`` route ("device"
  for all).
- The plain versions read the fixed-width byte matrices of the 12-,
  10- and 7-byte columns (``data.view(n, width)``), offsets differences,
  int64 calendar arithmetic over tables of month starts made by numpy,
  and the UTC offset of every ship day from the standard library's
  ``zoneinfo``.
"""

from __future__ import annotations

import datetime as _datetime

import numpy as np
import torch

from cudf_tpu_torch.frame.tools import to_datetime, to_numeric

RADIX = ["digit_histogram", "tile_sort_data", "merge_scatter", "bucket_aggregate"]
ONEHOT = ["onehot_groupby_aggregate"]
ZONE = "America/New_York"
_NS_DAY = 86_400 * 10 ** 9
_BASE_YEAR = 1900                       # the month-start tables cover 1900-2099


# ----------------------------------------------------------------------
# answers
# ----------------------------------------------------------------------

def _col(key, col) -> dict:
    """A column as its buffers: STRING bytes and offsets, dictionary
    codes' decoded text, else values (0 where null); the validity under
    ``<key>_valid`` where it has nulls."""
    if col.dtype.is_dictionary:
        col = col.decode_dictionary()
    out = {f"{key}_chars": col.data, f"{key}_offsets": col.offsets} if col.dtype.is_string \
        else {key: col.data if col.validity is None else
              torch.where(col.validity, col.data, torch.zeros_like(col.data))}
    if col.validity is not None and not bool(col.validity.all()):
        out[f"{key}_valid"] = col.validity
    return out


def _series(res) -> dict:
    return _col("values", res._column)


def _frame(res) -> dict:
    out = {}
    for name, col in res._table.items():
        out.update(_col(str(name), col))
    return out


def _grouped(res) -> dict:
    """A groupby's keys (its index) and sums."""
    out = _col("keys", res._index.column(res.device))
    out.update(_col("sums", res._column))
    return out


def _text(mat: torch.Tensor, key="values") -> dict:
    """A fixed-width byte matrix (every row ``mat.shape[1]`` bytes) as
    ``_col`` gives a STRING column."""
    n, w = mat.shape
    return {f"{key}_chars": mat.reshape(-1),
            f"{key}_offsets": torch.arange(n + 1, device=mat.device) * w}


def _ragged(mat: torch.Tensor, keep: torch.Tensor, key: str, valid=None) -> dict:
    """The bytes ``keep`` marks of each row of a byte matrix, as text."""
    lens = keep.sum(1)
    if valid is not None:
        lens = torch.where(valid, lens, 0)
        keep = keep & valid[:, None]
    offsets = torch.zeros(mat.shape[0] + 1, dtype=torch.int64, device=mat.device)
    offsets[1:] = torch.cumsum(lens, 0)
    out = {f"{key}_chars": mat[keep], f"{key}_offsets": offsets}
    if valid is not None and not bool(valid.all()):
        out[f"{key}_valid"] = valid
    return out


# ----------------------------------------------------------------------
# plain PyTorch
# ----------------------------------------------------------------------

def _matrix(frames, name="id3s") -> torch.Tensor:
    col = frames[name]._column
    n = col.length
    return col.data.view(n, -1) if n else col.data.view(0, 1)


def _digits_value(mat: torch.Tensor) -> torch.Tensor:
    out = torch.zeros(mat.shape[0], dtype=torch.int64, device=mat.device)
    for j in range(mat.shape[1]):
        out = out * 10 + (mat[:, j].long() - 48)
    return out


def _digits_text(v: torch.Tensor, width: int) -> torch.Tensor:
    """uint8[n, width]: v's decimal digits, zero-padded."""
    p = torch.tensor([10 ** (width - 1 - i) for i in range(width)], device=v.device)
    return (48 + v[:, None] // p % 10).to(torch.uint8)


def _const(text: str, n: int, device) -> torch.Tensor:
    return torch.tensor(list(text.encode()), dtype=torch.uint8, device=device).expand(n, -1)


def _window_all(mat, start, text):
    ok = torch.ones(mat.shape[0], dtype=torch.bool, device=mat.device)
    for j, c in enumerate(text.encode()):
        ok &= mat[:, start + j] == c
    return ok


def _first_window(mat, text):
    """(index of the first occurrence of text in each row, found)."""
    w, k = mat.shape[1], len(text)
    hits = torch.stack([_window_all(mat, j, text) for j in range(w - k + 1)], 1)
    found = hits.any(1)
    return torch.where(found, hits.int().argmax(1), w), found


def plain_len(frames):
    off = frames["id3s"]._column.offsets
    return {"values": off[1:] - off[:-1]}


def plain_number(frames):
    return {"values": _digits_value(_matrix(frames)[:, 2:])}


def plain_contains_zeros(frames):
    return {"values": _first_window(_matrix(frames), "00000")[1]}


def plain_contains_re(frames):
    m = _matrix(frames)
    ok = _window_all(m, 0, "id") & (m[:, 2:9] == 48).all(1) & (m[:, 9] >= 49) & (m[:, 9] <= 57)
    return {"values": ok & ((m[:, 10:] >= 48) & (m[:, 10:] <= 57)).all(1)}


def plain_startswith(frames):
    return {"values": _window_all(_matrix(frames), 0, "id00000")}


def plain_upper(frames):
    m = _matrix(frames)
    return _text(torch.where((m >= 97) & (m <= 122), m - 32, m))


def plain_replace_zeros(frames):
    m = _matrix(frames)
    zero = m == 48
    prev = torch.zeros_like(zero)
    prev[:, 1:] = zero[:, :-1]
    return _ragged(torch.where(zero, 45, m).to(torch.uint8), ~(zero & prev), "values")


def plain_split(frames):
    m = _matrix(frames)
    at, found = _first_window(m, "0000")
    pos = torch.arange(m.shape[1], device=m.device)[None, :]
    out = _ragged(m, pos < at[:, None], "0")
    out.update(_ragged(m, pos >= at[:, None] + 4, "1", found))
    return out


def plain_concat(frames):
    g1 = frames["g1"]
    id1 = g1["id1"]._column
    keys = id1.keys.data.view(id1.keys.length, -1)
    v1 = g1["v1"]._column.data
    n = v1.shape[0]
    return _text(torch.cat([keys[id1.data.long()], _const("_", n, v1.device),
                            (48 + v1[:, None]).to(torch.uint8)], 1))


def _grouped_plain(number, v, width, digits):
    """Sums of v by the key "id" + the top ``digits`` of a ``width``-digit
    number, in ascending key order."""
    group = number // 10 ** (width - digits)
    present, inv = torch.unique(group, return_inverse=True)
    sums = torch.zeros(present.shape[0], dtype=torch.float64, device=v.device)
    sums.index_add_(0, inv, v)
    n = present.shape[0]
    out = _text(torch.cat([_const("id", n, v.device), _digits_text(present, digits)], 1),
                key="keys")
    out["sums"] = sums
    return out


def plain_prefix(digits):
    def plain(frames):
        return _grouped_plain(_digits_value(_matrix(frames)[:, 2:]),
                              frames["g1"]["v3"]._column.data, 10, digits)
    return plain


def plain_codes(frames):
    return {"values": frames["g1"]["id1"]._column.data.to(torch.int8)}


def plain_categories(frames):
    keys = frames["g1"]["id1"]._column.keys
    return {"values_chars": keys.data, "values_offsets": keys.offsets}


# -- TPC-H lineitem dates ----------------------------------------------------

def _month_starts(device) -> torch.Tensor:
    """Days since 1970-01-01 of every month start of 1900-2100 (numpy)."""
    months = np.arange(np.datetime64(f"{_BASE_YEAR}-01"), np.datetime64("2100-02"),
                       dtype="datetime64[M]")
    return torch.from_numpy(months.astype("datetime64[D]").astype(np.int64)).to(device)


def _calendar(ticks: torch.Tensor):
    """(days, year, month, day, day of year, month index) of midnight-or-later
    ns ticks, by a search of the month starts."""
    days = torch.div(ticks, _NS_DAY, rounding_mode="floor")
    starts = _month_starts(ticks.device)
    k = torch.searchsorted(starts, days, right=True) - 1
    year, month = _BASE_YEAR + k // 12, k % 12 + 1
    return days, year, month, days - starts[k] + 1, days - starts[k - (month - 1)] + 1, k


def _ship(frames):
    return frames["lineitem"]["l_shipdate"]._column.data


def plain_field(name):
    def plain(frames):
        days, y, m, d, doy, k = _calendar(_ship(frames))
        starts = _month_starts(days.device)
        value = {"year": y, "month": m, "day": d, "dayofweek": (days + 3) % 7,
                 "quarter": (m - 1) // 3 + 1, "dayofyear": doy,
                 "is_month_end": days + 1 == starts[k + 1]}[name]
        return {"values": value if name == "is_month_end" else value.to(torch.int32)}
    return plain


def plain_floor_day(frames):
    t = _ship(frames)
    return {"values": t - t % _NS_DAY}


def plain_ceil_hour(frames):
    t, h = _ship(frames), 3600 * 10 ** 9
    return {"values": (t + h - 1) // h * h}


def _ymd_text(frames, with_day=True):
    days, y, m, d, _, _ = _calendar(_ship(frames))
    n, dev = y.shape[0], y.device
    parts = [_digits_text(y, 4), _const("-", n, dev), _digits_text(m, 2)]
    if with_day:
        parts += [_const("-", n, dev), _digits_text(d, 2)]
    return torch.cat(parts, 1)


def plain_strftime(frames):
    return _text(_ymd_text(frames))


def plain_to_datetime(frames):
    m = _matrix(frames, "ship_text")
    y, mo, d = _digits_value(m[:, :4]), _digits_value(m[:, 5:7]), _digits_value(m[:, 8:10])
    days = _month_starts(m.device)[(y - _BASE_YEAR) * 12 + mo - 1] + d - 1
    return {"values": days * (86_400 * 10 ** 6)}            # pandas 3 parses to us


def _zone_offsets(days: torch.Tensor) -> torch.Tensor:
    """The zone's UTC offset in seconds at each ship day's midnight UTC: the
    distinct days' offsets from ``zoneinfo``, searched."""
    from zoneinfo import ZoneInfo

    distinct = torch.unique(days)
    zone = ZoneInfo(ZONE)
    offs = [int(_datetime.datetime.fromtimestamp(int(dd) * 86400, zone).utcoffset()
                .total_seconds()) for dd in distinct.tolist()]
    table = torch.tensor(offs, dtype=torch.int64, device=days.device)
    return table[torch.searchsorted(distinct, days)]


def plain_tz_hour(frames):
    t = _ship(frames)
    secs = torch.div(t, 10 ** 9, rounding_mode="floor")
    local = secs + _zone_offsets(torch.div(secs, 86400, rounding_mode="floor"))
    return {"values": (local % 86400 // 3600).to(torch.int32)}


def _revenue(frames):
    li = frames["lineitem"]
    return li["l_extendedprice"]._column.data * (1 - li["l_discount"]._column.data)


def plain_revenue_by_year(frames):
    _, y, _, _, _, _ = _calendar(_ship(frames))
    present, inv = torch.unique(y, return_inverse=True)
    sums = torch.zeros(present.shape[0], dtype=torch.float64, device=y.device)
    return {"keys": present.to(torch.int32), "sums": sums.index_add_(0, inv, _revenue(frames))}


def plain_revenue_by_month(frames):
    _, y, m, _, _, k = _calendar(_ship(frames))
    present, inv = torch.unique(k, return_inverse=True)
    sums = torch.zeros(present.shape[0], dtype=torch.float64, device=y.device)
    sums.index_add_(0, inv, _revenue(frames))
    n = present.shape[0]
    out = _text(torch.cat([_digits_text(_BASE_YEAR + present // 12, 4),
                           _const("-", n, y.device), _digits_text(present % 12 + 1, 2)], 1),
                key="keys")
    out["sums"] = sums
    return out


# ----------------------------------------------------------------------
# the requests
# ----------------------------------------------------------------------

def prepare(frames) -> dict:
    """The text columns the other requests read: ``id3s`` from ``g1``,
    ``ship_text`` from ``lineitem``."""
    if "g1" in frames and "id3s" not in frames:
        frames["id3s"] = REQUESTS["id3_astype_str"](frames)
    if "lineitem" in frames and "ship_text" not in frames:
        frames["ship_text"] = REQUESTS["strftime_ymd"](frames)
    return frames


def _str(frames, dictionary):
    return (frames["g1"]["id3"] if dictionary else frames["id3s"]).str


def _by(key_fn):
    return lambda f: f["g1"]["v3"].groupby(key_fn(f)).sum()


def _dt(frames):
    return frames["lineitem"]["l_shipdate"].dt


STR_REQUESTS = {
    "len": lambda s: s.len(),
    "slice_astype_int64": lambda s: s.slice(2).astype("int64"),
    "slice_to_numeric": lambda s: to_numeric(s.slice(2)),
    "contains_00000": lambda s: s.contains("00000", regex=False),
    "contains_regex": lambda s: s.contains(r"^id0+[1-9]\d{2}$"),
    "startswith_id00000": lambda s: s.startswith("id00000"),
    "upper": lambda s: s.upper(),
    "replace_zeros": lambda s: s.replace(r"0+", "-", regex=True),
    "split_0000": lambda s: s.split("0000", n=1, expand=True),
}
_STR_ANSWERS = {"split_0000": lambda r, f: _frame(r)}
_STR_PLAIN = {
    "len": plain_len, "slice_astype_int64": plain_number, "slice_to_numeric": plain_number,
    "contains_00000": plain_contains_zeros, "contains_regex": plain_contains_re,
    "startswith_id00000": plain_startswith, "upper": plain_upper,
    "replace_zeros": plain_replace_zeros, "split_0000": plain_split,
}

REQUESTS = {
    "id3_astype_str": lambda f: f["g1"]["id3"].astype(str),
    **{name: (lambda f, fn=fn: fn(_str(f, False))) for name, fn in STR_REQUESTS.items()},
    "concat_id1_v1": lambda f: f["g1"]["id1"].astype(str) + "_" + f["g1"]["v1"].astype(str),
    "groupby_prefix8": _by(lambda f: f["id3s"].str.slice(0, 8)),
    "groupby_prefix8_category": _by(lambda f: f["id3s"].str.slice(0, 8).astype("category")),
    "groupby_prefix10_category": _by(lambda f: f["id3s"].str.slice(0, 10).astype("category")),
    **{f"dict_{name}": (lambda f, fn=fn: fn(_str(f, True))) for name, fn in STR_REQUESTS.items()},
    "cat_codes": lambda f: f["g1"]["id1"].cat.codes,
    "cat_categories": lambda f: f["g1"]["id1"].cat.categories,
    **{f"dt_{name}": (lambda f, name=name: getattr(_dt(f), name)) for name in (
        "year", "month", "day", "dayofweek", "quarter", "dayofyear", "is_month_end")},
    "dt_floor_D": lambda f: _dt(f).floor("D"),
    "dt_ceil_h": lambda f: _dt(f).ceil("h"),
    "strftime_ymd": lambda f: _dt(f).strftime("%Y-%m-%d"),
    "to_datetime_ymd": lambda f: to_datetime(f["ship_text"]),
    "tz_new_york_hour": lambda f: _dt(f).tz_localize("UTC").dt.tz_convert(ZONE).dt.hour,
    "revenue_by_year": lambda f: _revenue_series(f).groupby(_dt(f).year).sum(),
    "revenue_by_month_category": lambda f: _revenue_series(f).groupby(
        _dt(f).strftime("%Y-%m").astype("category")).sum(),
}


def _revenue_series(frames):
    li = frames["lineitem"]
    return li["l_extendedprice"] * (1 - li["l_discount"])


def _answer(name):
    base = name[len("dict_"):] if name.startswith("dict_") else name
    return _STR_ANSWERS.get(base, lambda r, f: _series(r))


ANSWERS = {name: _answer(name) for name in REQUESTS}
ANSWERS.update({
    "cat_categories": lambda r, f: _col("values", r.column(r.device)),
    **{name: (lambda r, f: _grouped(r)) for name in REQUESTS if "by" in name},
})

PLAIN = {
    "id3_astype_str": lambda f: _text(torch.cat([
        _const("id", len(f["g1"]), f["g1"].device),
        _digits_text(f["g1"]["id3"]._column.data.long() + 1, 10)], 1)),
    **_STR_PLAIN, **{f"dict_{name}": fn for name, fn in _STR_PLAIN.items()},
    "concat_id1_v1": plain_concat,
    "groupby_prefix8": plain_prefix(6), "groupby_prefix8_category": plain_prefix(6),
    "groupby_prefix10_category": plain_prefix(8),
    "cat_codes": plain_codes, "cat_categories": plain_categories,
    **{f"dt_{name}": plain_field(name) for name in (
        "year", "month", "day", "dayofweek", "quarter", "dayofyear", "is_month_end")},
    "dt_floor_D": plain_floor_day, "dt_ceil_h": plain_ceil_hour,
    "strftime_ymd": plain_strftime, "to_datetime_ymd": plain_to_datetime,
    "tz_new_york_hour": plain_tz_hour, "revenue_by_year": plain_revenue_by_year,
    "revenue_by_month_category": plain_revenue_by_month,
}

NEEDS = {name: [] for name in REQUESTS}
NEEDS.update({"groupby_prefix8_category": ONEHOT, "groupby_prefix10_category": RADIX,
              "revenue_by_year": ONEHOT, "revenue_by_month_category": ONEHOT})

RTOL = {name: 0.0 for name in REQUESTS}
RTOL.update({name: 1e-12 for name in REQUESTS if "by" in name})

ROUTE = {name: "device" for name in REQUESTS}

GROUPS = {
    "g1": [n for n in REQUESTS if n in STR_REQUESTS or n == "id3_astype_str"
           or n in ("concat_id1_v1", "cat_codes", "cat_categories") or n.startswith("groupby")],
    "g1_dict": [f"dict_{name}" for name in STR_REQUESTS],
    "lineitem": [n for n in REQUESTS if n.startswith(("dt_", "strftime", "to_datetime", "tz_",
                                                      "revenue"))],
}
