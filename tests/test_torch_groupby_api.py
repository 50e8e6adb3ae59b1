"""The groupby family's public API (``cudf_tpu_torch/frame/groupby.py``,
``frame/series.py``, ``frame/dataframe.py``) against pandas and, where
the reference is right, against cudf_tpu's frames on the JAX CPU backend,
on the same seeded numpy inputs.

Covered: column selection (``df.groupby(k)[name]``, ``[[names]]``),
SeriesGroupBy, ``level=`` over an Index and a MultiIndex, Series keys,
``groups``, ``ngroup``, iteration, ``get_group``, ``apply``, ``filter``,
``transform``, every ``rank`` method, ``describe``, pairwise ``cov`` and
``corr``, ``ewm``, and the Series / DataFrame ``corr``, ``cov``,
``autocorr``, ``agg``, ``transform``, ``pipe`` and ``describe``; the
column MultiIndex of ``to_pandas``.

Tolerances: keys, counts, ranks, group numbers and row selections exact;
float sums rtol 1e-12; cov, corr, std and ewm rtol 1e-9.  The reference's
faults (ROADMAP.md queue 3) are held to pandas: rank ignoring ties,
describe's 5-statistic layout, sort=False ignored.
"""

from fractions import Fraction

import numpy as np
import pandas as pd
import pytest
import torch

import cudf_tpu
import cudf_tpu_torch as ct

torch.set_num_threads(1)

CPU = torch.device("cpu")
N = 300
STAT_RTOL = 1e-9


def _pdf(seed=0, n=N):
    """k int32 (8 keys), j int64 (3 keys), v float64 with NaN and ties, w
    int32, f float64 near 1e8 and m near 100 (multiples of 1/8, exact).
    pandas' groupby std and var (Welford updates) lose ~1e-9 of their
    value near 1e8, where the port's two passes are exact: they are held
    to pandas on m; cov and corr (pandas' two passes too) on f."""
    rng = np.random.default_rng(seed)
    v = rng.integers(0, 10, n).astype(np.float64)
    v[rng.random(n) < 0.1] = np.nan
    return pd.DataFrame({
        "k": rng.integers(0, 8, n).astype(np.int32),
        "j": rng.integers(0, 3, n).astype(np.int64),
        "v": v,
        "w": rng.integers(-20, 20, n).astype(np.int32),
        "f": 1e8 + rng.integers(0, 50, n) / 8.0,
        "m": 100 + rng.integers(0, 50, n) / 8.0,
    }, index=np.arange(n) * 3 + 7)


def _port(pdf):
    return ct.DataFrame.from_pandas(pdf, device=CPU)


def _arr(a):
    a = pd.Index(a) if not isinstance(a, pd.Index) else a
    if a.dtype.kind in "fiub" or str(a.dtype) in ("Int32", "Int64", "Float64"):
        return np.asarray(a, dtype=np.float64)
    return np.asarray(a.astype(object))


def _norm_index(idx):
    if isinstance(idx, pd.MultiIndex):
        return pd.MultiIndex.from_arrays([_arr(idx.get_level_values(i))
                                          for i in range(idx.nlevels)], names=list(idx.names))
    return pd.Index(_arr(idx), name=idx.name)


def _norm(obj):
    obj = obj.copy()
    obj.index = _norm_index(obj.index)
    if isinstance(obj, pd.DataFrame):
        for c in obj.columns:
            obj[c] = _arr(obj[c])
        return obj
    return pd.Series(_arr(obj), index=obj.index, name=obj.name)


def _like(got, exp, rtol=1e-12):
    """The port's result (to_pandas) against pandas': index and column
    labels and names, values to rtol (integers and bools as float64)."""
    if hasattr(got, "to_pandas"):
        got = got.to_pandas()
    if isinstance(exp, pd.DataFrame):
        assert list(got.columns) == list(exp.columns), (list(got.columns), list(exp.columns))
        assert isinstance(got.columns, pd.MultiIndex) == isinstance(exp.columns, pd.MultiIndex)
        pd.testing.assert_frame_equal(_norm(got), _norm(exp), check_dtype=False,
                                      check_column_type=False, rtol=rtol, atol=0)
    elif isinstance(exp, pd.Series):
        assert got.name == exp.name, (got.name, exp.name)
        pd.testing.assert_series_equal(_norm(got), _norm(exp), check_dtype=False, rtol=rtol,
                                       atol=0)
    else:
        assert np.isclose(got, exp, rtol=rtol, atol=0, equal_nan=True), (got, exp)


@pytest.mark.parametrize("as_index", [True, False])
def test_to_pandas_gives_pandas_column_multiindex(as_index):
    """Tuple column names of one length come back as pandas' column
    MultiIndex, the keys padded with '' under as_index=False."""
    pdf = pd.DataFrame({"a": [1, 2, 1, 3], "w": [1.0, 2.0, 3.0, 4.0]})
    got = _port(pdf).groupby("a", as_index=as_index).agg({"w": ["sum", "max"]}).to_pandas()
    exp = pdf.groupby("a", as_index=as_index).agg({"w": ["sum", "max"]})
    assert isinstance(got.columns, pd.MultiIndex)
    assert got.columns.equals(exp.columns)
    _like(got, exp)


def test_sort_false_orders_a_dictionary_key_by_first_appearance_on_the_kernel_tiers():
    """A port fault: the kernel tiers' sort=False reorder searched a
    dictionary key's groups by the bytes of their strings, so the groups
    came back sorted."""
    from cudf_tpu_torch.utils.config import option_context

    pdf = pd.DataFrame({"k": pd.Categorical(["b", "a", "c", "a", "b"]), "v": [1, 2, 3, 4, 5]})
    with option_context("groupby.fast_path_min_rows", 0):
        got = _port(pdf).groupby("k", sort=False).agg({"v": "sum"})
    _like(got, pdf.groupby("k", sort=False, observed=True).agg({"v": "sum"}))


def test_from_pandas_keeps_a_multiindex():
    """A port fault: from_pandas made one Index of a MultiIndex's tuples."""
    pdf = _pdf(15).set_index(["k", "j"])
    df = _port(pdf)
    assert isinstance(df.index, ct.frame.index.MultiIndex)
    _like(df, pdf)


@pytest.mark.parametrize("sort", [True, False])
def test_series_groupby_matches_pandas(sort):
    pdf = _pdf(1)
    df = _port(pdf)
    calls = {
        "sum": lambda d: d.groupby("k", sort=sort)["v"].sum(),
        "mean": lambda d: d.groupby("k", sort=sort)["v"].mean(),
        "min": lambda d: d.groupby("k", sort=sort)["w"].min(),
        "max": lambda d: d.groupby(["k", "j"], sort=sort)["w"].max(),
        "count": lambda d: d.groupby("k", sort=sort)["v"].count(),
        "std": lambda d: d.groupby("k", sort=sort)["m"].std(),
        "var": lambda d: d.groupby("k", sort=sort)["v"].var(),
        "median": lambda d: d.groupby("k", sort=sort)["v"].median(),
        "first": lambda d: d.groupby("k", sort=sort)["v"].first(),
        "last": lambda d: d.groupby("k", sort=sort)["v"].last(),
        "nunique": lambda d: d.groupby("k", sort=sort)["v"].nunique(),
        "size": lambda d: d.groupby("k", sort=sort)["v"].size(),
        "prod": lambda d: d.groupby("j", sort=sort)["w"].prod(),
        "quantile": lambda d: d.groupby("k", sort=sort)["v"].quantile(0.25),
        "agg_name": lambda d: d.groupby("k", sort=sort)["v"].agg("sum"),
        "agg_list": lambda d: d.groupby("k", sort=sort)["v"].agg(["sum", "mean", "max"]),
        "agg_named": lambda d: d.groupby("k", sort=sort)["w"].agg(total="sum", top="max"),
        "agg_callable": lambda d: d.groupby("k", sort=sort)["w"].agg(lambda s: s.max()),
        "cumsum": lambda d: d.groupby("k", sort=sort)["w"].cumsum(),
        "cumcount": lambda d: d.groupby("k", sort=sort)["w"].cumcount(),
        "shift": lambda d: d.groupby("k", sort=sort)["v"].shift(2),
        "as_index_false_sum": lambda d: d.groupby("k", sort=sort, as_index=False)["w"].sum(),
        "as_index_false_size": lambda d: d.groupby("k", sort=sort, as_index=False)["w"].size(),
        "selection_list": lambda d: d.groupby("k", sort=sort)[["v", "w"]].sum(),
        "attribute": lambda d: d.groupby("k", sort=sort).w.mean(),
        "head": lambda d: d.groupby("k", sort=sort)["w"].head(2),
    }
    for name, fn in calls.items():
        _like(fn(df), fn(pdf), STAT_RTOL if name in ("std", "var") else 1e-12)


def test_series_groupby_matches_reference():
    """The reference is right on these (sorted groups)."""
    pdf = _pdf(2)
    df, ref = _port(pdf), cudf_tpu.DataFrame.from_pandas(pdf)
    for fn in (lambda d: d.groupby("k")["w"].sum(), lambda d: d.groupby("k")["f"].mean(),
               lambda d: d.groupby("k")["w"].cumsum(), lambda d: d.groupby("j").ngroup(),
               lambda d: d.groupby("k").transform("mean")):
        _like(fn(df), fn(ref).to_pandas())
    assert {k: v.to_pylist() for k, v in df.groupby("j").groups.items()} == \
        {k: list(v) for k, v in ref.groupby("j").groups.items()}
    _like(df.groupby("j").get_group(1), ref.groupby("j").get_group(1).to_pandas())


def test_level_keys_match_pandas():
    pdf = _pdf(3)
    named = pdf.set_index("k")
    multi = pdf.set_index(["k", "j"])
    unnamed = pdf.set_axis(pdf["k"].to_numpy(), axis=0)
    cases = [
        (named, lambda d: d.groupby(level="k").sum()),
        (named, lambda d: d.groupby(level=0)["w"].mean()),
        (unnamed, lambda d: d.groupby(level=0)["w"].sum()),
        (multi, lambda d: d.groupby(level="j").sum()),
        (multi, lambda d: d.groupby(level=1)["w"].max()),
        (multi, lambda d: d.groupby(level=["j", "k"]).agg({"w": "sum", "v": "mean"})),
        (multi, lambda d: d["w"].groupby(level="k").sum()),
        (named, lambda d: d["v"].groupby(level=0).count()),
    ]
    for pdf_i, fn in cases:
        _like(fn(_port(pdf_i)), fn(pdf_i))


def test_series_keys_match_pandas():
    """An external Series (named like a column: that column stays a value),
    the frame's own column as a Series (it leaves the values), host arrays
    and Series keys of Series.groupby."""
    pdf = _pdf(4)
    df = _port(pdf)
    ext = pdf["j"].rename("w")
    key = ct.Series(ext.to_numpy(), index=df.index, name="w")
    _like(df.groupby(key).sum(), pdf.groupby(ext).sum())
    _like(df.groupby(df["k"]).sum(), pdf.groupby(pdf["k"]).sum())
    _like(df.groupby([df["k"], "j"]).agg({"w": "sum"}), pdf.groupby([pdf["k"], "j"]).agg(
        {"w": "sum"}))
    _like(df["w"].groupby(df["k"]).mean(), pdf["w"].groupby(pdf["k"]).mean())
    keys = list(np.arange(N) % 4)
    _like(df["w"].groupby(keys).sum(), pdf["w"].groupby(keys).sum())
    _like(df["w"].groupby([df["k"], df["j"]], sort=False).sum(),
          pdf["w"].groupby([pdf["k"], pdf["j"]], sort=False).sum())


@pytest.mark.parametrize("sort", [True, False])
@pytest.mark.parametrize("dropna", [True, False])
def test_group_access_matches_pandas(sort, dropna):
    """ngroups, ngroup, groups, iteration (keys as pandas gives them: a
    tuple for a list of keys) and get_group, with a null key."""
    pdf = _pdf(5)
    pdf["n"] = pdf["j"].astype("float64")
    pdf.loc[pdf.index[::7], "n"] = np.nan
    df = _port(pdf)
    for by in ("k", ["k"], ["n", "j"], "n"):
        p = pdf.groupby(by, sort=sort, dropna=dropna)
        g = df.groupby(by, sort=sort, dropna=dropna)
        assert g.ngroups == p.ngroups
        _like(g.ngroup(), p.ngroup().astype("float64"))
        got = list(g)
        exp = list(p)
        assert [_key(k) for k, _ in got] == [_key(k) for k, _ in exp]
        for (_, a), (_, b) in zip(got, exp):
            _like(a, b)
        assert {_key(k): v.to_pylist() for k, v in g.groups.items()} == \
            {_key(k): list(v) for k, v in p.groups.items() if not _has_nan(k)} | (
                {} if dropna else {_key(k): list(v) for k, v in p.groups.items()
                                   if _has_nan(k)})
    _like(df.groupby(["k", "j"]).get_group((3, 1)), pdf.groupby(["k", "j"]).get_group((3, 1)))
    _like(df.groupby("k")["w"].get_group(2), pdf.groupby("k")["w"].get_group(2))
    with pytest.raises(KeyError):
        df.groupby("k").get_group(99)


def _has_nan(key):
    return any(isinstance(x, float) and np.isnan(x) for x in (key if isinstance(key, tuple)
                                                             else (key,)))


def _key(key):
    """A group key as comparable host values (NaN as None)."""
    def one(x):
        if x is None or (isinstance(x, float) and np.isnan(x)):
            return None
        return float(x) if isinstance(x, (int, float, np.integer, np.floating)) else x
    return tuple(one(x) for x in key) if isinstance(key, tuple) else one(key)


@pytest.mark.parametrize("sort", [True, False])
def test_apply_filter_transform_match_pandas(sort):
    pdf = _pdf(6)
    df = _port(pdf)
    calls = {
        "apply_scalar": lambda d: d.groupby("k", sort=sort).apply(lambda g: g["w"].sum()),
        "apply_frame": lambda d: d.groupby("j", sort=sort).apply(lambda g: g.head(2)),
        "apply_series": lambda d: d.groupby("k", sort=sort)["w"].apply(lambda s: s * 2),
        "apply_series_scalar": lambda d: d.groupby("j", sort=sort)["m"].apply(
            lambda s: s.max() - s.min()),
        "filter": lambda d: d.groupby("k", sort=sort).filter(lambda g: g["w"].sum() > 0),
        "filter_series": lambda d: d.groupby("j", sort=sort)["w"].filter(
            lambda s: len(s) > 100),
        "filter_keep_rows": lambda d: d.groupby("k", sort=sort)[["v", "m"]].filter(
            lambda g: g["m"].mean() > 103, dropna=False),
        "transform_callable": lambda d: d.groupby("k", sort=sort)[["w", "m"]].transform(
            lambda g: g.cumsum()),
        "transform_scalar": lambda d: d.groupby("k", sort=sort)["w"].transform(
            lambda s: s.max()),
        "transform_size": lambda d: d.groupby("k", sort=sort)["w"].transform("size"),
        "frame_transform_size": lambda d: d.groupby("k", sort=sort).transform("size"),
        "transform_cumsum": lambda d: d.groupby("k", sort=sort)["w"].transform("cumsum"),
    }
    for agg in ("sum", "mean", "min", "max", "count", "std", "median", "first", "nunique"):
        calls[f"transform_{agg}"] = lambda d, a=agg: d.groupby("k", sort=sort)[
            ["v", "w"]].transform(a)
        calls[f"series_transform_{agg}"] = lambda d, a=agg: d.groupby(
            ["k", "j"], sort=sort)["v"].transform(a)
    for name, fn in calls.items():
        _like(fn(df), fn(pdf), STAT_RTOL)


@pytest.mark.parametrize("method", ["average", "min", "max", "first", "dense"])
def test_rank_matches_pandas_with_ties(method):
    """The reference ranks by position in the segmented sort, ignoring
    method and ties (ROADMAP.md queue 3): v = [5, 5, 3] in one group ranks
    [2, 3, 1] there, [2.5, 2.5, 1] in pandas' average."""
    tiny = pd.DataFrame({"k": [1, 1, 1], "v": [5.0, 5.0, 3.0]})
    _like(_port(tiny).groupby("k")["v"].rank(method=method),
          tiny.groupby("k")["v"].rank(method=method))
    pdf = _pdf(7)
    df = _port(pdf)
    for ascending in (True, False):
        for na_option in ("keep", "top", "bottom"):
            for pct in (False, True):
                for sort in (True, False):
                    kw = dict(method=method, ascending=ascending, na_option=na_option, pct=pct)
                    _like(df.groupby("k", sort=sort)["v"].rank(**kw),
                          pdf.groupby("k", sort=sort)["v"].rank(**kw))
                    _like(df.groupby(["k", "j"], sort=sort)[["v", "w"]].rank(**kw),
                          pdf.groupby(["k", "j"], sort=sort)[["v", "w"]].rank(**kw))


def test_rank_average_differs_from_the_reference_positions():
    tiny = pd.DataFrame({"k": [1, 1, 1], "v": [5.0, 5.0, 3.0]})
    ref = cudf_tpu.DataFrame.from_pandas(tiny).groupby("k").rank().to_pandas()["v"].tolist()
    got = _port(tiny).groupby("k").rank().to_pandas()["v"].tolist()
    assert got == [2.5, 2.5, 1.0] and ref != got


@pytest.mark.parametrize("sort", [True, False])
def test_describe_matches_pandas_layout(sort):
    """pandas' eight statistics under a column MultiIndex (the reference
    returns five, named v_count ..., as a pandas object)."""
    pdf = _pdf(8)
    df = _port(pdf)
    got = df.groupby("k", sort=sort)[["v", "w", "m"]].describe()
    exp = pdf.groupby("k", sort=sort)[["v", "w", "m"]].describe()
    assert isinstance(got, ct.DataFrame)
    _like(got, exp, STAT_RTOL)
    # pandas orders several keys' describe by the first key under sort=False
    _like(df.groupby(["k", "j"])["v"].describe(), pdf.groupby(["k", "j"])["v"].describe(),
          STAT_RTOL)


def test_sort_false_orders_by_first_appearance_as_pandas():
    """The reference ignores sort=False (ROADMAP.md queue 3)."""
    pdf = _pdf(9)
    df = _port(pdf)
    for fn in (lambda d: d.groupby("k", sort=False).agg({"w": "sum", "v": "mean"}),
               lambda d: d.groupby(["j", "k"], sort=False).size(),
               lambda d: d.groupby("k", sort=False)["v"].describe(),
               lambda d: d.groupby("k", sort=False).ngroup(),
               lambda d: d.groupby("k", sort=False).apply(lambda g: g["w"].max())):
        _like(fn(df), fn(pdf), STAT_RTOL)
    got = df.groupby("k", sort=False)["w"].sum().to_pandas().index.tolist()
    assert got == list(dict.fromkeys(pdf["k"].tolist()))


def _exact_cov_corr(x, y, ddof=1):
    """cov and corr in rational arithmetic (the reference for both the
    port and pandas near 1e8, where pandas loses ~1e-9 of them)."""
    x, y = [Fraction(float(a)) for a in x], [Fraction(float(b)) for b in y]
    n = len(x)
    mx, my = sum(x) / n, sum(y) / n
    sxy = sum((a - mx) * (b - my) for a, b in zip(x, y))
    sxx, syy = sum((a - mx) ** 2 for a in x), sum((b - my) ** 2 for b in y)
    return float(sxy / (n - ddof)), float(sxy) / np.sqrt(float(sxx) * float(syy))


@pytest.mark.parametrize("sort", [True, False])
def test_pairwise_cov_corr_match_pandas(sort):
    """(keys..., column) rows by the numeric columns, as pandas lays them
    out; near 1e8 (where the reference's one-pass sums cancel and pandas
    loses ~1e-9) each cell equals the exact value."""
    pdf = _pdf(10).drop(columns=["v", "f"])
    df = _port(pdf)
    _like(df.groupby("k", sort=sort).corr(), pdf.groupby("k", sort=sort).corr(), STAT_RTOL)
    _like(df.groupby("j", sort=sort)[["w", "m"]].cov(), pdf.groupby("j", sort=sort)[
        ["w", "m"]].cov(), STAT_RTOL)
    _like(df.groupby(["k", "j"], sort=sort)[["w", "m"]].cov(ddof=0),
          pdf.groupby(["k", "j"], sort=sort)[["w", "m"]].cov(ddof=0), STAT_RTOL)
    near = _pdf(10)
    got_cov = _port(near).groupby("j", sort=sort)[["w", "f"]].cov().to_pandas()
    got_corr = _port(near).groupby("j", sort=sort)[["w", "f"]].corr().to_pandas()
    for key, grp in near.groupby("j"):
        cov, corr = _exact_cov_corr(grp["w"], grp["f"])
        np.testing.assert_allclose(got_cov.loc[(key, "w"), "f"], cov, rtol=1e-12)
        np.testing.assert_allclose(got_corr.loc[(key, "w"), "f"], corr, rtol=1e-12)


@pytest.mark.parametrize("sort", [True, False])
def test_groupby_ewm_matches_pandas(sort):
    pdf = _pdf(11)
    df = _port(pdf)
    for kw in (dict(com=0.5), dict(span=4), dict(halflife=2.0), dict(alpha=0.3, adjust=False),
               dict(alpha=0.3, ignore_na=True), dict(alpha=0.2, adjust=False, ignore_na=True)):
        _like(df.groupby("k", sort=sort)["v"].ewm(**kw).mean(),
              pdf.groupby("k", sort=sort)["v"].ewm(**kw).mean(), STAT_RTOL)


def test_series_statistics_match_pandas_and_reference():
    pdf = _pdf(12)
    df = _port(pdf)
    ref = cudf_tpu.DataFrame.from_pandas(pdf)
    s, t, p, q = df["v"], df["m"], pdf["v"], pdf["m"]
    for got, exp, r in ((s.corr(t), p.corr(q), ref["v"].corr(ref["m"])),
                        (s.cov(t), p.cov(q), ref["v"].cov(ref["m"])),
                        (s.cov(t, ddof=0), p.cov(q, ddof=0), ref["v"].cov(ref["m"], ddof=0)),
                        (s.autocorr(), p.autocorr(), ref["v"].autocorr()),
                        (t.autocorr(5), q.autocorr(5), ref["m"].autocorr(5))):
        _like(got, exp, STAT_RTOL)
        _like(got, r, STAT_RTOL)
    assert np.isnan(df["w"].head(1).corr(df["v"].head(1)))
    cov, corr = _exact_cov_corr(pdf["w"], pdf["f"])
    np.testing.assert_allclose(df["w"].corr(df["f"]), corr, rtol=1e-12)
    np.testing.assert_allclose(df["w"].cov(df["f"]), cov, rtol=1e-12)
    _like(s.describe(), p.describe(), STAT_RTOL)
    _like(df["w"].describe(), pdf["w"].describe(), STAT_RTOL)
    _like(s.agg("sum"), p.agg("sum"))
    _like(s.agg(["sum", "max", "count"]), p.agg(["sum", "max", "count"]))
    _like(s.agg(lambda x: x.max()), p.agg(lambda x: x.max()))
    _like(s.transform("cumsum"), p.transform("cumsum"))
    _like(s.transform(lambda x: x * 2), p.transform(lambda x: x * 2))
    with pytest.raises(ValueError):
        s.transform("sum")
    _like(s.pipe(lambda x, y: x + y, 1.0), p.pipe(lambda x, y: x + y, 1.0))
    _like(s.pipe((lambda a, other: other * a, "other"), 2.0),
          p.pipe((lambda a, other: other * a, "other"), 2.0))


def test_frame_statistics_match_pandas_and_reference():
    pdf = _pdf(13)
    df = _port(pdf)
    ref = cudf_tpu.DataFrame.from_pandas(pdf)
    num = ["k", "j", "v", "w", "m"]
    _like(df[num].corr(), pdf[num].corr(), STAT_RTOL)
    _like(df[num].cov(), pdf[num].cov(), STAT_RTOL)
    _like(df[["w", "f"]].corr(), ref[["w", "f"]].corr().to_pandas(), STAT_RTOL)
    _like(df.describe(), pdf.describe(), STAT_RTOL)
    _like(df.agg("sum"), pdf.agg("sum"))
    _like(df.agg(["sum", "max"]), pdf.agg(["sum", "max"]))
    _like(df.agg({"w": "sum", "v": "max"}), pdf.agg({"w": "sum", "v": "max"}))
    _like(df.agg({"w": ["sum", "min"], "v": "max"}), pdf.agg({"w": ["sum", "min"], "v": "max"}))
    _like(df.transform("cumsum"), pdf.transform("cumsum"))
    _like(df.transform(lambda s: s * 3), pdf.transform(lambda s: s * 3))
    _like(df.pipe(lambda d: d[["w"]]), pdf.pipe(lambda d: d[["w"]]))


def test_what_stays_unported_raises_naming_its_item():
    """What the reference lacks too names ROADMAP.md's "beyond the
    reference" line; the rest names its queue 1 item."""
    df = _port(_pdf(14))
    for name, where in (("map", "beyond the reference"), ("applymap", "beyond the reference"),
                        ("interpolate", "beyond the reference"),
                        ("update", "beyond the reference")):
        with pytest.raises(NotImplementedError, match=where):
            getattr(df, name)()
    # item 7's writers are ported: each is a method of the port's own
    for name in ("to_json", "to_orc", "to_feather", "to_tpudf"):
        assert "not_ported" not in getattr(df, name).__qualname__
    assert df["v"].to_json() == df["v"].to_pandas().to_json(orient="records")
    with pytest.raises(NotImplementedError, match="beyond the reference"):
        df.groupby("k").rolling("2D")
    with pytest.raises(NotImplementedError, match="beyond the reference"):
        ct.Series(np.array(["2020-01-01"], dtype="datetime64[ns]"), device=CPU).describe()
