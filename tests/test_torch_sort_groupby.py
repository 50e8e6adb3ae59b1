"""The sort tier of the port's groupby (``cudf_tpu_torch/ops/groupby.py``
``make_grouper`` and its aggregations, ``frame/groupby.py``) and the
frame's sorting and row selection, against cudf_tpu's sort tier on the
JAX CPU backend and against pandas, on the same seeded numpy inputs.

Tolerances: counts, sizes, integer, bool and row results exact; float64
results rtol 1e-12 (the port sums each group with atomic adds in
float64, the reference by prefix-sum differences, pandas with Kahan
sums).  pandas computes a float32 column's sum, mean, var, std and
cumsum in float32 where the port computes in float64 and rounds once:
float32 results agree within F32_RTOL.  Dtypes and nulls are pandas',
also where the reference gives other ones (ROADMAP.md queue 3): its
float32 mean, var, std and median are float64, and its integer sums and
prods int64 whatever their input's width.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import torch_jax_cache  # noqa: F401  (the run's shared JAX compile cache)
import cudf_tpu_torch as ct
from cudf_tpu_torch.core.table import Table
from cudf_tpu_torch.ops import groupby as gb
from cudf_tpu_torch.utils.config import option_context
from torch_sort_groupby_helpers import CPU, N, _check_series, _frame, _port_column

torch.set_num_threads(1)


def _port_frame(pdf):
    return ct.DataFrame({c: _port_column(pdf[c]) for c in pdf.columns})


def _check_frame(got, exp, rtol=1e-12):
    """got (the port's to_pandas) against pandas: index and columns, every
    column's dtype (nullable pandas ints compared as their numpy width),
    values exact or to rtol, nulls in the same places."""
    assert list(got.columns) == list(exp.columns)
    np.testing.assert_array_equal(np.asarray(got.index.to_frame().astype(float)),
                                  np.asarray(exp.index.to_frame().astype(float)))
    for col in exp.columns:
        _check_series(got[col], exp[col], rtol, col)


@pytest.mark.parametrize("case", ["two_keys", "float_key", "bool_key", "three_keys"])
@pytest.mark.parametrize("dropna", [True, False])
def test_frame_keys_match_pandas(case, dropna):
    """Multi-key, float and bool keys, with null and NaN keys, dropna both
    ways, sorted group order: held to pandas."""
    pdf = _frame(2)
    by = {"two_keys": ["a", "b"], "float_key": "b", "bool_key": "t",
          "three_keys": ["t", "a", "b"]}[case]
    spec = {"i": ["sum", "mean", "count", "min", "median"],
            "f": ["sum", "std", "var", "first", "last", "nunique"],
            "u": ["sum", "max", "prod"], "s": ["prod"], "g": ["mean", "median"]}
    got = _port_frame(pdf).groupby(by, dropna=dropna).agg(spec).to_pandas()
    _check_frame(got, pdf.groupby(by, dropna=dropna).agg(spec))


@pytest.mark.parametrize("as_index", [True, False])
@pytest.mark.parametrize("sort", [True, False])
def test_sort_false_and_as_index_false_match_pandas(sort, as_index):
    """Groups in order of first appearance under sort=False (the reference
    sorts them), and pandas' column names under as_index=False (the
    reference names the aggs (v, median) beside flat key names)."""
    pdf = _frame(3)
    spec = {"f": ["median", "std"], "i": "sum"}
    got = _port_frame(pdf).groupby(["a", "b"], sort=sort, as_index=as_index,
                                   dropna=False).agg(spec).to_pandas()
    exp = pdf.groupby(["a", "b"], sort=sort, as_index=as_index, dropna=False).agg(spec)
    assert list(got.columns) == list(exp.columns)
    _check_frame(got, exp)


@pytest.mark.parametrize("sort", [True, False])
def test_kernel_tier_sort_false_matches_pandas(sort):
    """One int key: the kernel tiers serve, in first-appearance order
    under sort=False."""
    rng = np.random.default_rng(4)
    pdf = pd.DataFrame({"k": rng.integers(0, 300, N), "v": rng.uniform(0, 1, N)})
    got = _port_frame(pdf).groupby("k", sort=sort).agg({"v": ["sum", "count"]})
    _check_frame(got.to_pandas(), pdf.groupby("k", sort=sort).agg({"v": ["sum", "count"]}))


def test_float32_mean_std_stay_float32():
    """pandas keeps float32 for mean, var, std and median (the reference
    gives float64)."""
    pdf = _frame(5)[["a", "g"]]
    spec = {"g": ["mean", "std", "var", "median", "sum"]}
    got = _port_frame(pdf).groupby("a").agg(spec).to_pandas()
    assert all(got[c].dtype == np.float32 for c in got.columns)
    with option_context("groupby.onehot_fast_path", False):
        _check_frame(_port_frame(pdf).groupby("a").agg(spec).to_pandas(),
                     pdf.groupby("a").agg(spec))


def test_head_with_null_keys_matches_pandas():
    """head(n) counts positions over the kept rows and maps them back to
    frame rows: rows with a null key are dropped (the reference applies a
    mask of the kept rows to the whole frame and returns a null-key row)."""
    pdf = pd.DataFrame({"k": pd.array([1, None, 2, 1, None, 2, 1], dtype="Int64"),
                        "v": np.arange(7.0)})
    df = _port_frame(pdf)
    for dropna in (True, False):
        for n in (1, 2, -1):
            got = df.groupby("k", dropna=dropna).head(n).to_pandas()
            exp = pdf.groupby("k", dropna=dropna).head(n)
            assert got.index.tolist() == exp.index.tolist(), (dropna, n)
            np.testing.assert_array_equal(got.v.to_numpy(), exp.v.to_numpy())
    assert df.groupby("k").head(1).to_pandas().index.tolist() == [0, 2]


def test_transforms_match_pandas():
    """nth, cumcount, cumsum and shift keep the frame's rows; a row whose
    key was dropped gives null."""
    pdf = _frame(6)[["a", "i", "f", "u"]]
    df = _port_frame(pdf)
    g, e = df.groupby("a"), pdf.groupby("a")
    for n in (0, 2, -1):
        got, exp = g.nth(n).to_pandas(), e.nth(n)
        assert got.index.tolist() == exp.index.tolist()
    _check_series(g.cumcount().to_pandas(), e.cumcount(), 0, "cumcount")
    _check_frame(g.cumsum().to_pandas(), e.cumsum())
    _check_frame(g.shift(2).to_pandas(), e.shift(2))
    _check_frame(g.shift(-1).to_pandas(), e.shift(-1))
    assert g.ngroups == e.ngroups


def test_size_series_with_multiindex_and_small_frames():
    """size() is a Series over a MultiIndex; a 5-row frame below
    groupby.fast_path_min_rows takes the sort tier."""
    pdf = _frame(7, n=5)
    df = _port_frame(pdf)
    got = df.groupby(["t", "b"], dropna=False).size().to_pandas()
    exp = pdf.groupby(["t", "b"], dropna=False).size()
    np.testing.assert_array_equal(got.to_numpy(), exp.to_numpy())
    assert got.index.names == exp.index.names
    pdf = pd.DataFrame({"k": [3, 1, 3, 2, 1], "v": [1.0, 2.0, 4.0, 8.0, 16.0],
                        "w": np.array([2, 3, 4, 5, 6], dtype=np.uint64)})
    with option_context("groupby.fast_path_min_rows", 100):
        spec = {"v": ["sum", "mean", "median"], "w": ["sum", "min", "count"]}
        _check_frame(_port_frame(pdf).groupby("k").agg(spec).to_pandas(),
                     pdf.groupby("k").agg(spec))
        got = _port_frame(pdf).groupby("k", as_index=False).size().to_pandas()
        exp = pdf.groupby("k", as_index=False).size()
        assert list(got.columns) == list(exp.columns)
        np.testing.assert_array_equal(got.to_numpy(), exp.to_numpy())


@pytest.mark.parametrize("spec", [{"v": ["sum", "mean", "count", "min", "max", "size"],
                                   "w": ["sum", "mean", "min", "max"]},
                                  {"v": "mean", "w": "sum", "b": "max"}])
@pytest.mark.parametrize("K", [50, 5000])
def test_kernel_tiers_and_sort_tier_agree(spec, K):
    """Where a request fits both, switching the kernel tiers off gives the
    same frame: integers exact, floats rtol 1e-12, the same dtypes."""
    rng = np.random.default_rng(8)
    pdf = pd.DataFrame({"k": rng.integers(0, K, 4 * N),
                        "v": rng.uniform(0, 100, 4 * N),
                        "w": rng.integers(-1000, 1000, 4 * N).astype(np.int32),
                        "b": rng.random(4 * N) > 0.3})
    pdf.loc[pdf.index[::7], "v"] = np.nan
    df = ct.from_pandas(pdf, device=CPU)
    fast = df.groupby("k").agg(spec).to_pandas()
    with option_context("groupby.onehot_fast_path", False):
        slow = df.groupby("k").agg(spec).to_pandas()
    assert list(fast.columns) == list(slow.columns)
    assert list(fast.dtypes) == list(slow.dtypes)
    _check_frame(fast, slow)
    _check_frame(fast, pdf.groupby("k").agg(spec))


@pytest.mark.parametrize("values", ["int32_fits", "int32_overflows", "uint8", "nan_values"])
def test_kernel_tier_results_follow_pandas(values):
    """Port faults repaired here: the kernel tiers gave int64 for every
    integer sum, where pandas keeps the column's dtype when the sums fit
    it (int64, uint64 for unsigned, when not); and they counted a NaN
    value of a frame built from tensors in sum, mean and count, where
    pandas skips it (such requests now take the sort tier)."""
    rng = np.random.default_rng(9)
    k = rng.integers(0, 20, N)
    if values == "nan_values":
        v = rng.uniform(0, 1, N)
        v[::5] = np.nan
    elif values == "uint8":
        v = rng.integers(0, 3, N).astype(np.uint8)
    else:
        hi = 2**31 - 1 if values == "int32_overflows" else 100
        v = rng.integers(0, hi, N).astype(np.int32)
    df = ct.DataFrame({"k": torch.from_numpy(k), "v": torch.from_numpy(v)})
    spec = {"v": ["sum", "mean", "count"]}
    got = df.groupby("k").agg(spec).to_pandas()
    _check_frame(got, pd.DataFrame({"k": k, "v": v}).groupby("k").agg(spec))


def test_sort_values_and_frame_selection_match_pandas():
    """sort_values (stable, NaN as null at na_position either way, several
    keys and directions, ignore_index), sort_index, take, head and
    drop_duplicates against pandas."""
    pdf = _frame(10)[["a", "b", "f", "t"]]
    df = _port_frame(pdf)
    for by, asc, na in [("f", True, "last"), ("f", False, "last"), ("f", False, "first"),
                        (["t", "b", "f"], [True, False, True], "last"),
                        (["a", "b"], False, "first")]:
        got = df.sort_values(by, ascending=asc, na_position=na, kind="stable").to_pandas()
        exp = pdf.sort_values(by, ascending=asc, na_position=na, kind="stable")
        assert got.index.tolist() == exp.index.tolist(), (by, asc, na)
    got = df.sort_values("f", ignore_index=True).head(7).to_pandas()
    exp = pdf.sort_values("f", ignore_index=True, kind="stable").head(7)
    _check_frame(got, exp)
    shuffled = df.take(torch.from_numpy(np.random.default_rng(1).permutation(N)))
    assert shuffled.sort_index().to_pandas().index.tolist() == list(range(N))
    for keep in ("first", "last", False):
        got = df.drop_duplicates(["a", "t"], keep=keep).to_pandas()
        assert got.index.tolist() == pdf.drop_duplicates(["a", "t"], keep=keep).index.tolist()
    s = df["f"].sort_values(ascending=False).to_pandas()
    assert s.index.tolist() == pdf["f"].sort_values(ascending=False, kind="stable").index.tolist()


def _g1(n, seed):
    """A small G1 frame (db-benchmark groupby-datagen.R's columns)."""
    rng = np.random.default_rng(seed)
    return pd.DataFrame({"id4": rng.integers(1, 101, n).astype(np.int32),
                         "id5": rng.integers(1, 101, n).astype(np.int32),
                         "id6": rng.integers(1, n // 100 + 1, n).astype(np.int32),
                         "v3": rng.uniform(0, 100, n)})


def test_g1_q6_and_q8_call_forms_match_pandas():
    """q6 (median and std of v3 by id4, id5) and q8 (the two largest v3 of
    each id6) in db-benchmark's pandas forms, at 1e4 rows."""
    pdf = _g1(10_000, 11)
    df = ct.from_pandas(pdf, device=CPU)
    q6 = dict(as_index=False, sort=False, observed=True, dropna=False)
    got = df.groupby(["id4", "id5"], **q6).agg({"v3": ["median", "std"]}).to_pandas()
    exp = pdf.groupby(["id4", "id5"], **q6).agg({"v3": ["median", "std"]})
    assert list(got.columns) == list(exp.columns)
    for col in exp.columns:
        _check_series(got[col], exp[col], 1e-12, col)
    np.testing.assert_array_equal(got[("v3", "median")], exp[("v3", "median")])
    got = df[["id6", "v3"]].sort_values("v3", ascending=False).groupby(
        "id6", sort=False, dropna=False).head(2).to_pandas()
    exp = pdf[["id6", "v3"]].sort_values("v3", ascending=False).groupby(
        "id6", sort=False, dropna=False).head(2)
    assert got.index.tolist() == exp.index.tolist()
    _check_frame(got, exp, rtol=0)


def test_unported_aggs_raise_naming_the_roadmap():
    df = ct.from_pandas(_g1(200, 12), device=CPU)
    for agg in ("ohlc", "corr", "ewm"):          # "collect" and "tdigest" are ported
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            df.groupby(["id4", "id5"]).agg({"v3": agg})
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            gb.groupby_agg(Table({"k": df._table["id4"]}), [("x", df._table["v3"], agg)])
