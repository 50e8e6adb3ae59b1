"""The port's top-level tools (``cudf_tpu_torch/frame/tools.py``:
to_datetime, to_numeric, cut, qcut, date_range, factorize, unique,
isna/notna) against the reference's ``cudf_tpu/frame/tools.py`` and
pandas on the same seeded inputs.

``cut``'s labels are held to pandas: the reference prints the edges with
``:g`` (``(0.992, 5]`` where pandas gives ``(0.992, 5.0]``); the port's
labels are a DICTIONARY32 of pandas' interval labels as text, compared
with pandas' categories as text.  Bin numbers and timestamps exact.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import cudf_tpu
import cudf_tpu_torch as ct

torch.set_num_threads(1)

CPU = torch.device("cpu")
N = 50


def _values():
    rng = np.random.default_rng(41)
    x = rng.normal(10, 4, N).round(2)
    x[[3, 17]] = np.nan
    return x


X = _values()


def like(got, exp, **kw):
    got = got.to_pandas() if hasattr(got, "to_pandas") else got
    exp = exp.to_pandas() if hasattr(exp, "to_pandas") else exp
    if isinstance(exp, pd.Index):
        pd.testing.assert_index_equal(got, exp, **kw)
    else:
        pd.testing.assert_series_equal(got, exp, **kw)


def as_text(s):
    s = s.to_pandas() if hasattr(s, "to_pandas") else s
    return s.astype(object).where(s.notna(), None).astype(str).tolist()


CUTS = {
    "int_bins": dict(bins=5),
    "int_bins_left": dict(bins=4, right=False),
    "edges": dict(bins=[0, 5, 10, 15, 30]),
    "float_edges_lowest": dict(bins=[X[0], 8.5, 12.25, 40.0], include_lowest=True),
    "labels": dict(bins=[0, 10, 20], labels=["low", "high"]),
}


@pytest.mark.parametrize("name", list(CUTS))
def test_cut_held_to_pandas(name):
    kw = CUTS[name]
    s = pd.Series(X, name="x")
    got = ct.cut(ct.Series(s, device=CPU), **kw)
    assert got.dtype.is_dictionary and got.name == "x"
    assert as_text(got) == as_text(pd.cut(s, **kw))
    codes = ct.cut(ct.Series(s, device=CPU), labels=False, **{k: v for k, v in kw.items()
                                                               if k != "labels"})
    like(codes, pd.cut(s, labels=False, **{k: v for k, v in kw.items() if k != "labels"}),
         check_dtype=False)


def test_cut_bins_agree_with_reference():
    """The reference's bin of every value (its labels aside), over values
    without NaN (the reference's range of a column with nulls is NaN)."""
    s = pd.Series(X).dropna()
    for bins in (5, [0, 5, 10, 15, 30]):
        got = ct.cut(ct.Series(s, device=CPU), bins, labels=False).to_pandas()
        exp = cudf_tpu.cut(cudf_tpu.Series(s), bins, labels=False).to_pandas()
        assert got.fillna(-1).astype(int).tolist() == exp.fillna(-1).astype(int).tolist()


@pytest.mark.parametrize("q", [4, 10, [0.0, 0.1, 0.5, 0.9, 1.0]])
def test_qcut_held_to_pandas(q):
    s = pd.Series(X)
    got = ct.qcut(ct.Series(s, device=CPU), q)
    assert as_text(got) == as_text(pd.qcut(s, q))
    like(ct.qcut(ct.Series(s, device=CPU), q, labels=False),
         pd.qcut(s, q, labels=False), check_dtype=False)
    ref = cudf_tpu.qcut(cudf_tpu.Series(s), q, labels=False).to_pandas()
    assert ct.qcut(ct.Series(s, device=CPU), q, labels=False).to_pandas().fillna(-1).astype(
        int).tolist() == ref.fillna(-1).astype(int).tolist()


RANGES = {
    "start_periods_days": dict(start="2020-01-01", periods=5, freq="D"),
    "start_end_hours": dict(start="2020-01-01", end="2020-01-03", freq="6h"),
    "end_periods_minutes": dict(end="2021-06-30 12:00", periods=4, freq="15min"),
    "seconds": dict(start="2020-01-01", periods=3, freq="90s"),
    "milliseconds": dict(start="2020-01-01", periods=3, freq="250ms"),
    "nanoseconds": dict(start=np.datetime64("2020-01-01", "ns"), periods=3, freq="7ns"),
    "linspace": dict(start="2020-01-01", end="2020-01-02", periods=5),
}


@pytest.mark.parametrize("name", list(RANGES))
def test_date_range_matches_pandas_and_reference(name):
    kw = RANGES[name]
    got = ct.date_range(device=CPU, **kw)
    exp = pd.date_range(**kw)
    like(got, pd.Index(exp.to_numpy()))
    ref = cudf_tpu.date_range(**kw).to_pandas()
    assert got.to_pandas().astype("datetime64[ns]").tolist() == \
        ref.astype("datetime64[ns]").tolist()


def test_date_range_raises_for_calendar_frequencies():
    """Month, quarter and year frequencies follow pandas since they are
    ported; business days and weeks (which the reference lacks too) raise."""
    for freq in ("ME", "MS", "YE"):
        got = ct.date_range("2020-01-01", periods=3, freq=freq, device=CPU)
        assert got.to_pandas().tolist() == pd.date_range("2020-01-01", periods=3,
                                                         freq=freq).tolist()
    for freq in ("B", "W"):
        with pytest.raises(NotImplementedError, match="beyond the reference"):
            ct.date_range("2020-01-01", periods=3, freq=freq, device=CPU)
    with pytest.raises(ValueError, match="device"):
        ct.date_range("2020-01-01", periods=3, freq="D")


def test_to_datetime_and_to_numeric():
    ints = pd.Series([1, 2, 1_600_000_000])
    for unit in ("s", "ms", "D", None):
        kw = {} if unit is None else {"unit": unit}
        like(ct.to_datetime(ct.Series(ints, device=CPU), **kw), pd.to_datetime(ints, **kw))
        if unit == "D":                 # the reference has no day unit (KeyError)
            continue
        ref = cudf_tpu.to_datetime(cudf_tpu.Series(ints), **kw).to_pandas()
        got = ct.to_datetime(ct.Series(ints, device=CPU), **kw).to_pandas()
        assert got.astype("datetime64[ns]").tolist() == ref.astype("datetime64[ns]").tolist()
    floats = pd.Series([1.5, np.nan, 3.25])
    like(ct.to_datetime(ct.Series(floats, device=CPU), unit="s"),
         pd.to_datetime(floats, unit="s"))
    stamps = ct.Series(pd.Series(pd.to_datetime(["2020-01-01", None])), device=CPU)
    assert ct.to_datetime(stamps) is stamps
    like(ct.to_datetime(["2020-01-01", "2021-02-03"], device=CPU),
         pd.Index(pd.to_datetime(["2020-01-01", "2021-02-03"]).to_numpy()))
    assert ct.to_datetime("2020-01-05") == pd.Timestamp("2020-01-05")
    text = pd.Series(["2020-01-01 00:00:00", "2021-02-03 04:05:06"])
    like(ct.to_datetime(ct.Series(text, device=CPU)), pd.to_datetime(text))
    s = ct.Series(pd.Series(X), device=CPU)
    assert ct.to_numeric(s) is s
    assert np.array_equal(ct.to_numeric([1, 2, 3]), pd.to_numeric([1, 2, 3]))
    like(ct.to_numeric(ct.Series(["1", "2"], device=CPU)), pd.to_numeric(pd.Series(["1", "2"])))


def test_factorize_unique_and_missing():
    vals = pd.Series([3, 1, 3, 7, 1, 1])
    s = ct.Series(vals, device=CPU)
    for sort in (False, True):
        codes, uniques = ct.factorize(s, sort=sort)
        e_codes, e_uniques = pd.factorize(vals, sort=sort)
        r_codes, r_uniques = cudf_tpu.factorize(cudf_tpu.Series(vals), sort=sort)
        assert codes.tolist() == e_codes.tolist() == np.asarray(r_codes).tolist()
        assert uniques.to_pylist() == e_uniques.tolist()
    assert ct.unique(s).tolist() == pd.unique(vals).tolist() == \
        np.asarray(cudf_tpu.unique(cudf_tpu.Series(vals))).tolist()
    x = ct.Series(pd.Series(X), device=CPU)
    like(ct.isna(x), pd.isna(pd.Series(X)))
    like(ct.notnull(x), pd.notnull(pd.Series(X)))
    like(ct.isnull(x), cudf_tpu.isnull(cudf_tpu.Series(pd.Series(X))))
    frame = ct.DataFrame.from_pandas(pd.DataFrame({"x": X}), device=CPU)
    pd.testing.assert_frame_equal(ct.notna(frame).to_pandas(), pd.notna(pd.DataFrame({"x": X})))
    assert ct.isna(None) and ct.isna(float("nan")) and ct.notna(3)
    assert ct.isna([1.0, None, np.nan]).tolist() == pd.isna([1.0, None, np.nan]).tolist()
