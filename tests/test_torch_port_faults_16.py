"""Nine faults of the port's string, temporal and accessor code (ROADMAP.md
§3, open port faults 1-9), each held to pandas 3: faults 5-9 were copied
from the reference, which stays as it is.

1. text dates outside 1677-09-21 .. 2262-04-11 parse in microseconds
   instead of wrapping, and ``astype("datetime64[ns]")`` of one raises
   ``OutOfBoundsDatetime``;
2. the text "-9223372036854775808" is INT64_MIN under ``astype("int64")``
   and ``to_numeric``;
3. a tz-aware timestamp's text keeps the seconds of its UTC offset;
4. ``str.wrap``, ``cat.as_ordered`` and ``cat.as_unordered``;
5. ``str.extract`` names its columns by the named groups;
6. Series reductions of temporal columns give timestamps and durations;
7. pandas' and the standard library's temporal scalars (and ISO text in
   comparisons) in binary ops;
8. ``tz_localize`` in a DST fold or gap raises, or takes ``ambiguous=`` and
   ``nonexistent=``;
9. ``astype("int64")`` of timestamps with NaT gives INT64_MIN for NaT.
"""

import datetime

import numpy as np
import pandas as pd
import pytest
import torch

import cudf_tpu_torch as ct
from cudf_tpu_torch.ops.strings import OutOfBoundsDatetime

torch.set_num_threads(1)

CPU = "cpu"
ZONE = "America/New_York"


def _same(got, exp):
    pd.testing.assert_series_equal(got.to_pandas(), exp, check_names=False)


# 1 -------------------------------------------------------------------
def test_dates_outside_nanoseconds_parse_in_microseconds():
    text = ["0001-01-01", "9999-12-31", None, "2020-02-29 12:34:56"]
    got = ct.to_datetime(ct.Series(text, device=CPU))
    exp = pd.to_datetime(pd.Series(text), format="ISO8601")
    assert str(got.dtype) == "datetime64[us]"
    _same(got, exp)


def test_nanosecond_cast_out_of_bounds_raises():
    with pytest.raises(OutOfBoundsDatetime):
        ct.Series(["2500-01-01"], device=CPU).astype("datetime64[ns]")
    with pytest.raises(pd.errors.OutOfBoundsDatetime):
        pd.Series(["2500-01-01"]).astype("datetime64[ns]")
    inside = ["2262-04-11 23:47:16", "1677-09-22"]
    _same(ct.Series(inside, device=CPU).astype("datetime64[ns]"),
          pd.Series(inside).astype("datetime64[ns]"))


# 2 -------------------------------------------------------------------
def test_int64_min_text():
    text = ["-9223372036854775808", "9223372036854775807", "12"]
    _same(ct.Series(text, device=CPU).astype("int64"), pd.Series(text).astype("int64"))
    got = ct.to_numeric(ct.Series(text, device=CPU))
    assert got.dtype == ct.core.dtypes.INT64
    _same(got, pd.to_numeric(pd.Series(text)))


# 3 -------------------------------------------------------------------
@pytest.mark.parametrize("zone,wall", [("Asia/Kolkata", "1900-01-01 00:00"),
                                       (ZONE, "1880-06-01 12:00"), (ZONE, "2021-06-01 12:00")])
def test_offset_seconds_in_text(zone, wall):
    exp = pd.Series(pd.to_datetime([wall])).dt.tz_localize(zone)
    got = ct.Series(pd.Series(pd.to_datetime([wall])), device=CPU).dt.tz_localize(zone)
    assert got.astype(str).to_pandas().tolist() == exp.astype(str).tolist()


# 4 -------------------------------------------------------------------
def test_str_wrap():
    text = ["a b c d", None, "xyzzy w", ""]
    _same(ct.Series(text, device=CPU).str.wrap(3), pd.Series(text).str.wrap(3))


def test_cat_as_ordered_sets_the_flag():
    p = pd.Series(["b", "a", None, "b"], dtype="category")
    s = ct.Series(p, device=CPU)
    assert s.cat.ordered is False
    o = s.cat.as_ordered()
    assert o.cat.ordered is True
    _same(o, p.cat.as_ordered())
    assert o.cat.as_unordered().cat.ordered is False
    _same(o.cat.as_unordered(), p.cat.as_ordered().cat.as_unordered())


# 5 -------------------------------------------------------------------
@pytest.mark.parametrize("pat", [r"(?P<x>[a-z])(?P<y>\d)", r"(?P<x>[a-z])(\d)"])
def test_extract_named_groups(pat):
    text = ["a1", "b2", None, "zz"]
    got = ct.Series(text, device=CPU).str.extract(pat).to_pandas()
    exp = pd.Series(text).str.extract(pat)
    assert list(got.columns) == list(exp.columns)
    pd.testing.assert_frame_equal(got, exp, check_dtype=False)


# 6 -------------------------------------------------------------------
TIMES = ["2020-01-01", "2020-01-03 07:00:01.25", None, "2019-12-31 23:59:59"]


@pytest.mark.parametrize("how", ["mean", "median", "min", "max"])
def test_timestamp_reductions(how):
    p = pd.Series(pd.to_datetime(TIMES, format="ISO8601"))
    got = getattr(ct.Series(p, device=CPU), how)()
    assert pd.Timestamp(got) == getattr(p, how)()


def test_timestamp_std_is_a_duration():
    p = pd.Series(pd.to_datetime(TIMES, format="ISO8601"))
    got = ct.Series(p, device=CPU).std()
    assert isinstance(got, np.timedelta64)
    assert pd.Timedelta(got) == p.std()


def test_duration_sum_and_mean():
    p = pd.Series(pd.to_timedelta(["1h", "2h 30min", None]))
    s = ct.Series(p, device=CPU)
    assert pd.Timedelta(s.sum()) == p.sum()
    assert pd.Timedelta(s.mean()) == p.mean()
    with pytest.raises(TypeError):
        ct.Series(pd.Series(pd.to_datetime(TIMES, format="ISO8601")), device=CPU).sum()


def test_tz_aware_max_keeps_its_zone():
    p = pd.Series(pd.to_datetime(TIMES, format="ISO8601")).dt.tz_localize("UTC")
    p = p.dt.tz_convert("Asia/Kolkata")
    got = ct.Series(p, device=CPU).max()
    assert pd.Timestamp(got) == p.max()
    assert str(pd.Timestamp(got).tz) == "Asia/Kolkata"


# 7 -------------------------------------------------------------------
SCALAR_OPS = [
    ("sub", pd.Timestamp("2020-01-01")), ("add", pd.Timedelta("1h")),
    ("eq", pd.Timestamp("2020-01-01")), ("gt", "2020-01-02"),
    ("add", datetime.timedelta(hours=1, microseconds=5)), ("lt", datetime.datetime(2020, 1, 2)),
    ("sub", datetime.datetime(2019, 1, 1)), ("ge", pd.Timestamp("2020-01-02 00:00:00.5")),
]


@pytest.mark.parametrize("op,value", SCALAR_OPS)
def test_temporal_scalars(op, value):
    p = pd.Series(pd.to_datetime(TIMES, format="ISO8601"))
    s = ct.Series(p, device=CPU)
    fn = {"sub": lambda a: a - value, "add": lambda a: a + value, "eq": lambda a: a == value,
          "gt": lambda a: a > value, "lt": lambda a: a < value, "ge": lambda a: a >= value}[op]
    _same(fn(s), fn(p))


# 8 -------------------------------------------------------------------
FOLD = ["2021-11-07 01:30", "2021-06-01 00:00"]
GAP = ["2021-03-14 02:30", "2021-03-14 01:59", "2021-03-14 03:00"]


def _walls(text):
    return pd.Series(pd.to_datetime(text))


def test_tz_localize_raises_in_a_fold_or_gap():
    for text in (FOLD, GAP):
        with pytest.raises(ValueError):
            _walls(text).dt.tz_localize(ZONE)
        with pytest.raises(ValueError):
            ct.Series(_walls(text), device=CPU).dt.tz_localize(ZONE)


@pytest.mark.parametrize("ambiguous", ["NaT", "flags"])
def test_tz_localize_ambiguous(ambiguous):
    arg = np.array([True, False]) if ambiguous == "flags" else ambiguous
    _same(ct.Series(_walls(FOLD), device=CPU).dt.tz_localize(ZONE, ambiguous=arg),
          _walls(FOLD).dt.tz_localize(ZONE, ambiguous=arg))


@pytest.mark.parametrize("nonexistent", ["NaT", "shift_forward", "shift_backward"])
def test_tz_localize_nonexistent(nonexistent):
    _same(ct.Series(_walls(GAP), device=CPU).dt.tz_localize(ZONE, nonexistent=nonexistent),
          _walls(GAP).dt.tz_localize(ZONE, nonexistent=nonexistent))


# 9 -------------------------------------------------------------------
def test_timestamps_with_nat_to_int64():
    p = pd.Series(pd.to_datetime(TIMES, format="ISO8601"))
    _same(ct.Series(p, device=CPU).astype("int64"), p.astype("int64"))
