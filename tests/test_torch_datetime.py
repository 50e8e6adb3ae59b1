"""The port's calendar and time-zone ops (``cudf_tpu_torch/ops/datetime.py``,
``ops/timezone.py``) and its device strftime / string parsing
(``ops/strings.py``) against the reference's ``cudf_tpu/ops/datetime.py``
and ``ops/timezone.py`` on the JAX CPU backend and against pandas 3, on
the same seeded timestamps (1900-2100, ns, s and ms units, NaT rows).

Every result exact: fields, ticks, text.  ``is_leap_year``,
``is_month_start`` and ``is_month_end`` of NaT are held to pandas
(False; the reference gives null in an object column).
"""

import numpy as np
import pandas as pd
import pytest
import torch

import torch_jax_cache  # noqa: F401  (the run's shared JAX compile cache)
from cudf_tpu.core.column import Column as RefColumn
from cudf_tpu.ops import datetime as ref_dto
from cudf_tpu.ops import timezone as ref_tz
import cudf_tpu_torch as ct
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.ops import datetime as dto
from cudf_tpu_torch.ops.strings import STRING_ROUTES
from cudf_tpu_torch.ops import timezone as tz

torch.set_num_threads(1)

CPU = torch.device("cpu")
N = 80
FIELDS = ["year", "month", "day", "hour", "minute", "second", "millisecond", "microsecond",
          "nanosecond", "weekday", "dayofyear", "quarter", "days_in_month", "is_leap_year",
          "is_month_start", "is_month_end"]


def _stamps(unit="ns", nulls=True):
    rng = np.random.default_rng(11)
    lo, hi = np.datetime64("1900-01-01", "s").astype(np.int64), \
        np.datetime64("2100-01-01", "s").astype(np.int64)
    secs = rng.integers(lo, hi, N)
    secs[:6] = [0, -1, 951782400, 951868799, 1709251199, 4102444799]   # edges, leap days
    ticks = secs.astype(np.int64) * {"s": 1, "ms": 1000, "ns": 10 ** 9}[unit]
    if unit != "s":
        ticks += rng.integers(0, {"ms": 1000, "ns": 10 ** 9}[unit], N)
    arr = ticks.view(f"datetime64[{unit}]").copy()
    if nulls:
        arr[rng.random(N) < 0.1] = np.datetime64("NaT")
    return pd.Series(arr)


def port(s):
    return Column.from_pandas(s, device=CPU)


def values(col):
    data = col.data.tolist()
    if col.validity is None:
        return data
    return [d if ok else None for d, ok in zip(data, col.validity.tolist())]


@pytest.mark.parametrize("unit", ["ns", "ms", "s"])
def test_fields_match_reference_and_pandas(unit):
    s = _stamps(unit)
    ref = RefColumn.from_numpy(s.to_numpy())
    for field in FIELDS:
        got = values(dto.extract(port(s), field))
        pandas = s.dt.microsecond // 1000 if field == "millisecond" else getattr(s.dt, field)
        exp = [None if v != v else (bool(v) if field.startswith("is_") else int(v))
               for v in pandas.tolist()]
        if field.startswith("is_"):
            exp = [False if v is None else v for v in exp]      # pandas: NaT is False
        assert got == exp, field
        if not field.startswith("is_"):
            assert got == ref_dto.extract(ref, field).to_pylist(), field


def test_is_fields_of_nat_are_false_as_pandas():
    s = pd.Series(pd.to_datetime(["2020-02-29", None]))
    for field in ("is_leap_year", "is_month_start", "is_month_end"):
        got = dto.extract(port(s), field)
        assert got.validity is None and got.data.tolist() == [field != "is_month_start", False]
        assert got.data.tolist() == getattr(s.dt, field).tolist()
    ref = ref_dto.extract(RefColumn.from_numpy(s.to_numpy()), "is_leap_year").to_pylist()
    assert ref == [True, None]                          # the reference's fault


@pytest.mark.parametrize("freq", ["D", "h", "15min", "s", "ms"])
def test_rounding_matches_reference_and_pandas(freq):
    s = _stamps("ns")
    ref = RefColumn.from_numpy(s.to_numpy())
    for op in ("floor", "ceil", "round"):
        got = values(getattr(dto, op)(port(s), freq))
        assert got == getattr(ref_dto, op)(ref, freq).to_pylist(), (op, freq)
        exp = getattr(s.dt, op)(freq)
        assert got == [None if v is pd.NaT else v.value for v in exp.tolist()], (op, freq)


@pytest.mark.parametrize("months", [1, -13, 25])
def test_add_calendrical_months_matches_reference(months):
    s = _stamps("ns")
    got = values(dto.add_calendrical_months(port(s), months))
    ref = ref_dto.add_calendrical_months(RefColumn.from_numpy(s.to_numpy()), months)
    assert got == [None if v is None else int(np.datetime64(v, "ns").astype(np.int64))
                   for v in ref.to_pylist()]


@pytest.mark.parametrize("zone", ["America/New_York", "Europe/London", "Asia/Kolkata",
                                  "Australia/Lord_Howe", "UTC"])
def test_time_zones_match_reference_and_pandas(zone):
    trans, offs = tz.load_transitions(zone)
    rtrans, roffs = ref_tz.load_transitions(zone)
    # the listed transitions are the reference's; the footer's rule goes on
    assert trans[:len(rtrans)].tolist() == rtrans.tolist()
    assert offs[:len(roffs)].tolist() == roffs.tolist()
    s = _stamps("ns", nulls=False)
    aware = tz.tz_convert(tz.tz_localize(port(s), "UTC"), zone)
    exp = s.dt.tz_localize("UTC").dt.tz_convert(zone)
    wall = tz.wall_clock_column(aware)
    assert wall.data.tolist() == exp.dt.tz_localize(None).astype("int64").tolist()
    assert dto.extract(wall, "hour").data.tolist() == exp.dt.hour.tolist()
    ref = ref_tz.wall_clock_column(ref_tz.tz_convert(
        ref_tz.tz_localize(RefColumn.from_numpy(s.to_numpy()), "UTC"), zone))
    listed = (s < pd.Timestamp(int(rtrans[-1]) if len(rtrans) else 0, unit="s")).to_numpy()
    assert np.array_equal(wall.data.numpy()[listed], np.asarray(ref.data)[listed])
    # naive wall clock -> that zone: pandas where the wall time exists once
    local = tz.tz_localize(port(s), zone)
    ok = s.dt.tz_localize(zone, ambiguous="NaT", nonexistent="NaT")
    keep = ok.notna().to_numpy()
    assert np.array_equal(local.data.numpy()[keep],
                          ok[keep].dt.tz_convert("UTC").dt.tz_localize(None)
                          .astype("int64").to_numpy())


def test_unknown_zone_raises():
    with pytest.raises(ValueError, match="unknown time zone"):
        tz.load_transitions("Mars/Olympus_Mons")
    with pytest.raises(ValueError):
        tz.load_transitions("../../etc/passwd")


FORMATS = ["%Y-%m-%d", "%Y-%m", "%d/%m/%y %H:%M:%S", "%Y%m%d %j", "%H:%M:%S.%f",
           "%a %A %b %B %p %I %%"]


@pytest.mark.parametrize("fmt", FORMATS)
def test_strftime_matches_pandas(fmt):
    s = _stamps("ns").where(lambda x: x.dt.year >= 1000)
    got = ct.Series(s, device=CPU).dt.strftime(fmt).to_pandas()
    pd.testing.assert_series_equal(got, s.dt.strftime(fmt), check_dtype=False)


@pytest.mark.parametrize("unit", ["ns", "ms", "s"])
def test_astype_str_matches_pandas(unit):
    for s in (_stamps(unit), _stamps(unit).dt.floor("D"),
              _stamps(unit, nulls=False).dt.tz_localize("UTC").dt.tz_convert("Asia/Tokyo")):
        got = ct.Series(s, device=CPU).astype(str).to_pandas()
        assert got.tolist() == s.astype(str).tolist() or \
            got.astype(object).where(got.notna(), None).tolist() == \
            s.astype(str).astype(object).where(s.notna(), None).tolist()


@pytest.mark.parametrize("fmt", [None, "%Y-%m-%d %H:%M:%S", "%Y-%m-%d"])
def test_to_datetime_of_text_matches_pandas(fmt):
    s = _stamps("s").dt.floor("D" if fmt == "%Y-%m-%d" else "s")
    text = s.dt.strftime(fmt or "%Y-%m-%dT%H:%M:%S")
    got = ct.to_datetime(ct.Series(text, device=CPU), format=fmt).to_pandas()
    exp = pd.to_datetime(text, format=fmt)
    pd.testing.assert_series_equal(got, exp)
    frac = pd.Series(["2020-01-01 00:00:00.123456789", "1999-12-31 23:59:59.5", None])
    pd.testing.assert_series_equal(ct.to_datetime(ct.Series(frac, device=CPU)).to_pandas(),
                                   pd.to_datetime(frac))


def test_to_datetime_errors():
    bad = pd.Series(["2020-01-01", "2020-02-30", "x", None])
    with pytest.raises(ValueError):
        ct.to_datetime(ct.Series(bad, device=CPU))
    got = ct.to_datetime(ct.Series(bad, device=CPU), errors="coerce").to_pandas()
    pd.testing.assert_series_equal(got, pd.to_datetime(bad, errors="coerce"))
    odd = pd.Series(["20200105", "2020-01-05T10"])               # the host route
    before = STRING_ROUTES["host"]
    got = ct.to_datetime(ct.Series(odd, device=CPU)).to_pandas()
    assert got.tolist() == [pd.Timestamp("2020-01-05"), pd.Timestamp("2020-01-05 10:00")]
    assert got.tolist() == [pd.to_datetime(v) for v in odd]
    assert STRING_ROUTES["host"] == before + 1


@pytest.mark.parametrize("freq", ["MS", "ME", "QS", "QE", "YS", "YE", "2MS", "3ME"])
def test_calendar_date_range_matches_pandas(freq):
    for kw in (dict(start="2020-01-15 10:30", periods=7), dict(start="2019-11-30",
                                                               end="2021-03-31"),
               dict(end="2020-06-30", periods=5), dict(start="2020-02-01", periods=3)):
        got = ct.date_range(freq=freq, device=CPU, **kw).to_pandas()
        exp = pd.date_range(freq=freq, **kw)
        assert got.tolist() == exp.tolist(), kw


def test_rule_years_and_dropping_the_zone_match_pandas():
    """Past the TZif file's last listed transition (2037) its footer's rule
    holds: 2040-07-01 12:00 UTC is 08:00 in New York (the reference keeps
    the last offset: 07:00).  ``tz_localize(None)`` keeps the wall clock,
    as pandas (the reference keeps the UTC ticks)."""
    s = pd.Series(pd.to_datetime(["2040-07-01 12:00", "2099-01-15 03:00"]).astype(
        "datetime64[ns]"))
    aware = ct.Series(s, device=CPU).dt.tz_localize("UTC").dt.tz_convert("America/New_York")
    exp = s.dt.tz_localize("UTC").dt.tz_convert("America/New_York")
    assert aware.dt.hour.to_pandas().tolist() == exp.dt.hour.tolist() == [8, 22]
    pd.testing.assert_series_equal(aware.dt.tz_localize(None).to_pandas(),
                                   exp.dt.tz_localize(None))
    ref = ref_tz.wall_clock_column(ref_tz.tz_convert(ref_tz.tz_localize(
        RefColumn.from_numpy(s.to_numpy()), "UTC"), "America/New_York"))
    assert np.asarray(ref.data).astype("datetime64[ns]")[0] == np.datetime64("2040-07-01T07:00")
