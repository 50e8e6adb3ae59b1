"""The port's ``Series`` (its pandas API) against pandas and the
reference's ``cudf_tpu.Series`` on the same seeded numpy inputs.

Every case runs one function on a pandas Series, on the port's and
(for the cases the reference serves) on the reference's; results are
compared through ``to_pandas``: values, nulls (NaN), index labels and
names.  Integers, bools, strings and labels exact; floats rtol 1e-12.
Where the reference differs from pandas the port is held to pandas.
"""

import datetime

import numpy as np
import pandas as pd
import pytest
import torch

import cudf_tpu
import cudf_tpu_torch as ct
from cudf_tpu_torch.utils.missing import NA

torch.set_num_threads(1)

CPU = torch.device("cpu")
N = 40


def _data():
    rng = np.random.default_rng(11)
    f = rng.normal(0, 1, N).round(3)
    f[[3, 17, 30]] = np.nan
    i = rng.integers(-5, 6, N)
    return {"f": f, "i": i, "b": rng.random(N) > 0.5,
            "g": rng.normal(0, 1, N).round(3)}


DATA = _data()


def _series(ns, key, name="x"):
    arr = DATA[key]
    if ns is ct:
        return ct.Series(arr, name=name, device=CPU)
    return ns.Series(arr, name=name)


def _host(x):
    """A result as pandas or Python values, whichever library made it."""
    if hasattr(x, "to_pandas"):
        return x.to_pandas()
    if isinstance(x, tuple):
        return tuple(_host(v) for v in x)
    if isinstance(x, np.ndarray) and x.dtype == object:
        return x
    return x


def assert_like(got, exp):
    got, exp = _host(got), _host(exp)
    if isinstance(exp, pd.Series):
        assert isinstance(got, pd.Series), type(got)
        got, exp = got.copy(), exp.copy()
        if exp.dtype == object or str(exp.dtype) in ("str", "string", "category"):
            got, exp = got.astype(object), exp.astype(object)
        if exp.dtype.kind in "fiu" or got.dtype.kind in "fiu" and exp.dtype.kind != "b":
            got, exp = got.astype("float64"), exp.astype("float64")
        pd.testing.assert_series_equal(got, exp, check_dtype=False, check_index_type=False,
                                       rtol=1e-12)
    elif isinstance(exp, pd.DataFrame):
        pd.testing.assert_frame_equal(got, exp, check_dtype=False, check_index_type=False,
                                      check_column_type=False, rtol=1e-12)
    elif isinstance(exp, tuple):
        for g, e in zip(got, exp):
            assert_like(g, e)
    elif isinstance(exp, (np.ndarray, pd.Index, list)):
        np.testing.assert_allclose(np.asarray(got, dtype=float), np.asarray(exp, dtype=float),
                                   rtol=1e-12)
    elif exp is None or exp is pd.NA or (isinstance(exp, float) and np.isnan(exp)):
        assert got is None or got is NA or (isinstance(got, float) and np.isnan(got)), got
    elif isinstance(exp, (float, np.floating)):
        np.testing.assert_allclose(float(got), float(exp), rtol=1e-12)
    else:
        assert got == exp, (got, exp)


# (id, column, function): each runs on pandas, the port and the reference
CASES = [
    ("add_scalar", "f", lambda s: s + 1.5),
    ("rsub_scalar", "f", lambda s: 1 - s),
    ("mul_other", "f", lambda s: s * s.abs()),
    ("truediv", "i", lambda s: s / 2),
    ("floordiv", "i", lambda s: s // 3),
    ("mod", "i", lambda s: s % 4),
    ("pow", "i", lambda s: s ** 2),
    ("rpow", "i", lambda s: 2.0 ** s),
    ("neg", "f", lambda s: -s),
    ("abs", "i", lambda s: abs(s)),
    ("gt", "f", lambda s: s > 0.2),
    ("le", "i", lambda s: s <= 1),
    ("eq_series", "i", lambda s: s == s.abs()),
    ("ne_nan", "f", lambda s: s != 0.5),
    ("and_or", "f", lambda s: ((s > 0) & (s < 1)) | (s < -1)),
    ("invert", "b", lambda s: ~s),
    ("xor", "b", lambda s: s ^ (~s)),
    ("isna", "f", lambda s: s.isna()),
    ("notna", "f", lambda s: s.notna()),
    ("fillna", "f", lambda s: s.fillna(0.0)),
    ("dropna", "f", lambda s: s.dropna()),
    ("cumsum", "f", lambda s: s.cumsum()),
    ("cummax", "i", lambda s: s.cummax()),
    ("shift", "f", lambda s: s.shift(2)),
    ("diff", "i", lambda s: s.diff()),
    ("clip", "f", lambda s: s.clip(-0.5, 0.5)),
    ("where", "f", lambda s: s.where(s > 0, -1.0)),
    ("round", "f", lambda s: s.round(1)),
    ("head", "f", lambda s: s.head(3)),
    ("tail", "f", lambda s: s.tail(4)),
    ("filter", "f", lambda s: s[s > 0]),
    ("iloc_slice", "i", lambda s: s.iloc[2:9]),
    ("iloc_list", "i", lambda s: s.iloc[[5, 1, 7]]),
    ("loc_list", "i", lambda s: s.loc[[4, 2]]),
    ("sort_values", "f", lambda s: s.sort_values(kind="stable")),
    ("sort_desc", "i", lambda s: s.sort_values(ascending=False, kind="stable")),
    ("astype_float", "i", lambda s: s.astype("float64")),
    ("isin", "i", lambda s: s.isin([1, -2, 5])),
    ("between", "f", lambda s: s.between(-0.5, 0.5)),
    ("reset_index", "f", lambda s: s.sort_values(kind="stable").reset_index(drop=True)),
    ("sum", "f", lambda s: s.sum()),
    ("mean", "f", lambda s: s.mean()),
    ("min", "i", lambda s: s.min()),
    ("max", "f", lambda s: s.max()),
    ("std", "f", lambda s: s.std()),
    ("var", "i", lambda s: s.var()),
    ("median", "f", lambda s: s.median()),
    ("count", "f", lambda s: s.count()),
    ("nunique", "i", lambda s: s.nunique()),
    ("any_all", "b", lambda s: (s.any(), s.all())),
    ("idxmax", "f", lambda s: s.idxmax()),
    ("quantile", "f", lambda s: s.quantile(0.3)),
    ("iloc_scalar", "i", lambda s: s.iloc[6]),
    ("loc_scalar", "f", lambda s: s.loc[8]),
]
# cases the reference serves, each compared with the port as well
REFERENCE = [c for c in CASES if c[0] in ("add_scalar", "rsub_scalar", "gt", "isna",
                                          "fillna", "cumsum", "shift", "sort_values",
                                          "sum", "mean", "count", "filter", "head")]


@pytest.mark.parametrize("name,key,fn", CASES, ids=[c[0] for c in CASES])
def test_series_method_matches_pandas(name, key, fn):
    assert_like(fn(_series(ct, key)), fn(_series(pd, key)))


@pytest.mark.parametrize("name,key,fn", REFERENCE, ids=[c[0] for c in REFERENCE])
def test_series_method_matches_reference(name, key, fn):
    assert_like(fn(_series(ct, key)), fn(_series(cudf_tpu, key)))


def test_more_methods_match_pandas():
    """The rest of the column API, one assertion each."""
    f, i = _series(ct, "f"), _series(ct, "i")
    pf, pi = _series(pd, "f"), _series(pd, "i")
    for got, exp in [
        (f.ffill(), pf.ffill()), (f.bfill(), pf.bfill()), (f.fillna(method="ffill"),
                                                           pf.ffill()),
        (f.cumprod(), pf.cumprod()), (i.cummin(), pi.cummin()), (f.pct_change(),
                                                                 pf.pct_change()),
        (f.mask(f > 0), pf.mask(pf > 0)), (f.rank(), pf.rank()),
        (i.rank(method="dense"), pi.rank(method="dense")),
        (i.nlargest(4), pi.nlargest(4)), (f.nsmallest(3), pf.nsmallest(3)),
        (i.drop_duplicates(), pi.drop_duplicates()), (i.duplicated(), pi.duplicated()),
        (i.value_counts(), pi.value_counts()), (i.value_counts(normalize=True),
                                                pi.value_counts(normalize=True)),
        (i.mode(), pi.mode()), (i.replace({1: 100, -1: -100}), pi.replace({1: 100, -1: -100})),
        (i.repeat(2), pi.repeat(2)), (f.add(f.shift(1), fill_value=0.0),
                                      pf.add(pf.shift(1), fill_value=0.0)),
        (i.rsub(3), pi.rsub(3)), (i.isin(i.head(5)), pi.isin(pi.head(5))),
        (f.astype("category").astype("float64"), pf.astype("category").astype("float64")),
        (i.sort_values(kind="stable").sort_index(), pi.sort_values(kind="stable").sort_index()),
        (f.loc[3:7], pf.loc[3:7]), (f[5:9], pf[5:9]), (f.to_frame(), pf.to_frame()),
        (f.rename("y"), pf.rename("y")), (f.set_axis(np.arange(N) * 2), pf.set_axis(
            np.arange(N) * 2)), (f.reset_index(), pf.reset_index()),
    ]:
        assert_like(got, exp)
    for got, exp in [(f.prod(), pf.prod()), (f.sem(), pf.sem()), (f.skew(), pf.skew()),
                     (f.kurtosis(), pf.kurtosis()), (i.argmax(), pi.argmax()),
                     (i.idxmin(), pi.idxmin()), (f.first_valid_index(),
                                                 pf.first_valid_index()),
                     (f.last_valid_index(), pf.last_valid_index()), (f.hasnans, pf.hasnans),
                     (len(f), len(pf)), (f.shape, pf.shape), (f.empty, pf.empty),
                     (i.sort_values().searchsorted(2), pi.sort_values().searchsorted(2)),
                     (i.equals(i.copy()), pi.equals(pi.copy())), (f.equals(i), False)]:
        assert_like(got, exp)
    codes, uniques = i.factorize()
    pcodes, puniques = pi.factorize()
    np.testing.assert_array_equal(codes, pcodes)
    np.testing.assert_array_equal(uniques.to_numpy(), puniques.to_numpy())
    np.testing.assert_array_equal(np.sort(i.unique()), np.sort(pi.unique()))
    assert list(i) == list(pi) and i.tolist() == pi.tolist()
    np.testing.assert_array_equal(np.asarray(f), np.asarray(pf))
    with pytest.raises(ValueError):
        bool(f)


_STAMPS = np.array(["2020-01-01", "2020-01-02", "2020-01-03T00:00:00.000000001",
                    "2020-01-01", "NaT", "2020-01-05"], "datetime64[ns]")
_SPANS = np.array([1, 2, 3, 1, "NaT", 5], "timedelta64[s]").astype("timedelta64[ns]")
_MANY_DAYS = [np.datetime64("2019-12-01") + np.timedelta64(d, "D") for d in range(40)]
TEMPORAL_VALUES = {
    "datetime64": (_STAMPS, [np.datetime64("2020-01-02")]),
    "datetime": (_STAMPS, [datetime.datetime(2020, 1, 1), datetime.datetime(2020, 1, 4)]),
    "timestamp_ns": (_STAMPS, [pd.Timestamp("2020-01-03 00:00:00.000000001")]),
    "timestamp_tz": (_STAMPS, [pd.Timestamp("2020-01-01", tz="UTC")]),
    "timestamp_many": (_STAMPS, [pd.Timestamp(d) for d in _MANY_DAYS]),
    "datetime_many": (_STAMPS, [d.astype("datetime64[us]").item() for d in _MANY_DAYS]),
    "timedelta64": (_SPANS, [np.timedelta64(2, "s")]),
    "timedelta": (_SPANS, [datetime.timedelta(seconds=1), datetime.timedelta(seconds=4)]),
    "pd_timedelta": (_SPANS, [pd.Timedelta(5, "s")]),
    "timedelta_many": (_SPANS, [datetime.timedelta(seconds=k) for k in range(0, 40, 2)]),
}


@pytest.mark.parametrize("case", sorted(TEMPORAL_VALUES))
def test_temporal_values_match_pandas(case):
    """``isin`` and ``replace`` over a timestamp or duration column take
    numpy's, the standard library's and pandas' scalars as pandas does
    (to the nanosecond; a tz-aware value matches no naive row), by one
    equality pass a value and by the search past 16 values."""
    arr, values = TEMPORAL_VALUES[case]
    s, ps = ct.Series(arr, name="t", device=CPU), pd.Series(arr, name="t")
    assert_like(s.isin(values), ps.isin(values))
    naive = [v for v in values if getattr(v, "tzinfo", None) is None]
    if naive:
        new = ps.iloc[-1]
        assert_like(s.replace(naive[0], new), ps.replace(naive[0], new))


def test_alignment_follows_labels_as_pandas():
    """Operands over different labels meet over the sorted union of both,
    a label missing on one side NaN; one index object compares nothing."""
    f, pf = _series(ct, "f"), _series(pd, "f")
    g, pg = _series(ct, "g", "y"), _series(pd, "g", "y")
    assert_like(f + g.sort_values(), pf + pg.sort_values())
    assert_like(f.iloc[5:30] * g.iloc[:20], pf.iloc[5:30] * pg.iloc[:20])
    assert_like(f.add(g.iloc[10:], fill_value=0.0), pf.add(pg.iloc[10:], fill_value=0.0))
    assert_like(f[g.sort_values() > 0], pf[pg.sort_values() > 0])
    assert f.index.equals(f.index) and (f + 1).index is f.index


def test_setitem_rebinds_and_is_strict_as_pandas_3():
    """A mask, label, slice or position assignment gives pandas' values;
    the old column's buffers are never written, and a value the dtype
    cannot hold raises TypeError (pandas 3)."""
    f, pf = _series(ct, "f"), _series(pd, "f")
    before = f._column.data.clone()
    view = ct.Series._from(f._column, f.index, "view")
    f[f > 0] = 0.0
    pf[pf > 0] = 0.0
    f[3] = 9.5
    pf[3] = 9.5
    f.iloc[0:2] = -1.0
    pf.iloc[0:2] = -1.0
    f.loc[[10, 11]] = 7.0
    pf.loc[[10, 11]] = 7.0
    assert_like(f, pf)
    assert torch.allclose(view._column.data, before, equal_nan=True)
    i = _series(ct, "i")
    with pytest.raises(TypeError):
        i[0] = 1.5
    with pytest.raises(TypeError):
        i[i > 0] = None


def test_constructor_needs_a_device_for_host_data():
    with pytest.raises(ValueError, match="device"):
        ct.Series([1, 2, 3])
    s = ct.Series(torch.arange(4), name="t")
    assert s.device == CPU and s.name == "t" and s.tolist() == [0, 1, 2, 3]
    d = ct.Series({"a": 1.0, "b": 2.0}, device=CPU)
    assert d.index.to_pylist() == ["a", "b"] and d.loc["b"] == 2.0
    full = ct.Series(3, index=[5, 6], device=CPU)
    assert_like(full, pd.Series(3, index=[5, 6]))
    assert ct.Series([1, None], dtype="Int64", device=CPU).to_pandas().dtype == "Int64"


def test_unported_methods_raise_naming_their_item():
    """The Series method that named item 7, ``to_json``, is ported: it
    writes pandas' records text; what neither package has names ROADMAP.md's
    "beyond the reference" line."""
    s = _series(ct, "f")
    assert s.to_json() == s.to_pandas().to_json(orient="records")
    with pytest.raises(NotImplementedError, match="beyond the reference"):
        ct.to_datetime(s, utc=True)


def test_index_methods_match_pandas():
    """Lookups and set operations of an Index (and a RangeIndex, whose
    lookups are arithmetic and whose mask filter keeps int64 positions)."""
    labels = np.array([5, 3, 9, 1, 7], np.int64)
    idx, pidx = ct.Index(ct.Column.from_numpy(labels, device=CPU), "k"), pd.Index(labels,
                                                                                  name="k")
    other = [3, 4, 9]
    assert idx.get_indexer_for(other).tolist() == pidx.get_indexer(other).tolist()
    assert idx.union(other).to_pylist() == pidx.union(other).tolist()
    assert idx.intersection(other).to_pylist() == pidx.intersection(other).tolist()
    assert idx.difference(other).to_pylist() == pidx.difference(other).tolist()
    assert idx.isin(other).tolist() == pidx.isin(other).tolist()
    assert idx.get_loc(9) == pidx.get_loc(9)
    dup = ct.Index(ct.Column.from_numpy(np.array([4, 2, 4]), device=CPU))
    assert list(dup.get_loc(4)) == [0, 2]
    assert idx.unique().to_pylist() == pidx.unique().tolist()
    assert idx.argsort().tolist() == pidx.argsort(kind="stable").tolist()
    assert idx.sort_values().to_pylist() == pidx.sort_values().tolist()
    assert idx.astype("float64").to_pylist() == pidx.astype("float64").tolist()
    assert (idx.min(), idx.max()) == (pidx.min(), pidx.max())
    assert_like(idx.to_series(), pidx.to_series())
    assert idx.equals(idx) and not idx.equals(idx.sort_values())
    r, pr = ct.RangeIndex(2, 30, 3), pd.RangeIndex(2, 30, 3)
    assert r[4] == pr[4] and r[2:6].to_pandas().equals(pr[2:6])
    assert r.get_indexer_for([5, 6, 29, 2]).tolist() == pr.get_indexer([5, 6, 29, 2]).tolist()
    assert r.equals(ct.RangeIndex(2, 30, 3)) and not r.equals(ct.RangeIndex(2, 31, 4))
    kept = r.take(torch.tensor([0, 3]))
    assert kept.to_pylist() == [2, 11] and kept.dtype.name == "int64"
    s = ct.Series(torch.arange(10.0))
    assert s[s > 6].index.to_pylist() == [7, 8, 9]
