"""The rest of the port's groupby family (``cudf_tpu_torch/ops/groupby.py``):
sum_of_squares, m2, the bitwise aggregations, cov, corr and ewma on the
sort tier, and the kernel-tier transform, against cudf_tpu's on the JAX
CPU backend and against pandas / numpy, on the same seeded numpy inputs.

Tolerances: group ids, keys, counts, integer and bitwise results exact;
float sums rtol 1e-12; m2, cov, corr and ewm rtol 1e-9.  Where the
reference is wrong (ROADMAP.md queue 3) the case is held to pandas: its
group cov and corr take one-pass sums (``sxy - sx*sy/n``), which cancel
over values near 1e8, so those cases would fail if the port copied it.
The reference's bitwise aggregations and ewma run reset scans that take
seconds a dtype to compile on a CPU, so they are held to it on two
dtypes (one ewma form) and to numpy and pandas on the rest.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from cudf_tpu.core.column import Column as RefColumn
from cudf_tpu.ops import groupby as ref_gb
import cudf_tpu_torch as ct
from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.ops import copying
from cudf_tpu_torch.ops import groupby as gb
from cudf_tpu_torch.utils.config import option_context

torch.set_num_threads(1)

CPU = torch.device("cpu")
N = 400
DTYPES = [np.int8, np.int16, np.int32, np.int64, np.uint8, np.uint16, np.uint32,
          np.float32, np.float64, np.bool_]
BIT_DTYPES = [np.int8, np.int16, np.int32, np.int64, np.uint8, np.uint16, np.uint32,
              np.uint64, np.bool_]


def _key(rng, n=N, groups=7, nulls=True):
    """int32 keys 0..groups-1 (the last group all-null in the values), a
    null key's data 0 (the reference orders nulls by their data)."""
    k = rng.integers(0, groups, n).astype(np.int32)
    valid = rng.random(n) > 0.1 if nulls else None
    if valid is not None:
        k = np.where(valid, k, 0)
    return k, valid


def _values(rng, dtype, k, groups=7):
    """Values of dtype with nulls (NaN too for floats), every row of the
    last group null."""
    dtype = np.dtype(dtype)
    if dtype == np.bool_:
        x = rng.random(k.shape[0]) > 0.5
    elif dtype.kind == "f":
        x = rng.normal(0, 50, k.shape[0]).astype(dtype)
        x[rng.random(k.shape[0]) < 0.05] = np.nan
    else:
        lo = 0 if dtype.kind == "u" else -100
        x = rng.integers(lo, 100, k.shape[0]).astype(dtype)
    valid = (rng.random(k.shape[0]) > 0.1) & (k != groups - 1)
    return x, valid


def _port(x, valid):
    return ct.from_buffers(x.dtype, x.shape[0], x, valid, device=CPU)


def _ref(x, valid):
    return RefColumn.from_numpy(x, mask=valid)


def _groupers(k, kv, dropna):
    return (gb.make_grouper([_port(k, kv)], dropna=dropna),
            ref_gb.make_grouper([_ref(k, kv)], dropna=dropna))


def _port_values(col):
    """(values, valid) of a port column on the host, NaN and null as
    missing."""
    v = col.data.numpy()
    ok = np.ones(col.length, bool) if col.validity is None else col.validity.numpy()
    if v.dtype.kind == "f":
        ok = ok & ~np.isnan(v)
    return v, ok


def _ref_values(col):
    v = np.asarray(col.data)
    ok = np.ones(col.length, bool) if col.validity is None else np.asarray(col.validity)
    if v.dtype.kind == "f":
        ok = ok & ~np.isnan(v)
    return v, ok


def _assert_same(port_col, exp, exp_ok, rtol, what):
    got, ok = _port_values(port_col)
    np.testing.assert_array_equal(ok, exp_ok, err_msg=f"{what} nulls")
    if got.dtype.kind == "f":
        np.testing.assert_allclose(got[ok], np.asarray(exp)[ok], rtol=rtol, atol=0,
                                   err_msg=what)
    else:
        np.testing.assert_array_equal(got[ok], np.asarray(exp)[ok], err_msg=what)


def _pandas_keys(k, kv):
    """The keys as pandas sees them: NaN for a null key (a group of its own
    under dropna=False, sorted last as the port's)."""
    return pd.Series(np.where(kv if kv is not None else True, k, np.nan))


@pytest.mark.parametrize("dropna", [True, False])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_sum_of_squares_and_m2_match_reference(dtype, dropna):
    """Both in float64 over the valid values (NaN skipped), null for a
    group without any (the all-null group), under dropna both ways; m2
    also against pandas' var(ddof=0) * count."""
    rng = np.random.default_rng(1)
    k, kv = _key(rng)
    x, xv = _values(rng, dtype, k)
    port_g, ref_g = _groupers(k, kv, dropna)
    for agg, ref_fn in (("sum_of_squares", ref_gb.group_sum_of_squares),
                        ("m2", ref_gb.group_m2)):
        got = gb.aggregate(_port(x, xv), port_g, agg)
        assert got.dtype == dt.FLOAT64
        exp, exp_ok = _ref_values(ref_fn(_ref(x, xv), ref_g))
        _assert_same(got, exp, exp_ok, 1e-12 if agg == "sum_of_squares" else 1e-9,
                     f"{agg} {np.dtype(dtype).name}")
    pdf = pd.DataFrame({"k": _pandas_keys(k, kv),
                        "x": pd.Series(np.where(xv, x.astype(np.float64), np.nan))})
    grouped = pdf.groupby("k", dropna=dropna)["x"]
    m2 = (grouped.var(ddof=0) * grouped.count()).to_numpy()
    _assert_same(gb.aggregate(_port(x, xv), port_g, "m2"), m2, grouped.count().to_numpy() > 0,
                 1e-9, "m2 vs pandas")


@pytest.mark.parametrize("op", ["and", "or", "xor"])
@pytest.mark.parametrize("dtype", BIT_DTYPES, ids=lambda d: np.dtype(d).name)
def test_bitwise_aggregations_match_numpy(dtype, op):
    """Each group's bitwise reduction of its valid values in the column's
    dtype (bool stays bool, uint64 keeps its high bit), null for the
    all-null group; held to numpy's reduce over each group."""
    rng = np.random.default_rng(2)
    k, kv = _key(rng, nulls=False)
    if np.dtype(dtype) == np.uint64:
        x = rng.integers(0, 1 << 62, k.shape[0]).astype(np.uint64) | np.uint64(1 << 63)
        xv = (rng.random(k.shape[0]) > 0.1) & (k != 6)
    else:
        x, xv = _values(rng, dtype, k)
    g = gb.make_grouper([_port(k, None)])
    got = gb.aggregate(_port(x, xv), g, f"bitwise_{op}")
    assert got.data.dtype == torch.from_numpy(x[:1]).dtype
    fn = {"and": np.bitwise_and, "or": np.bitwise_or, "xor": np.bitwise_xor}[op]
    exp, ok = [], []
    for key in range(7):
        vals = x[(k == key) & xv]
        ok.append(vals.size > 0)
        exp.append(fn.reduce(vals) if vals.size else x[0])
    _assert_same(got, np.array(exp, dtype=x.dtype), np.array(ok), 0, f"bitwise_{op}")


@pytest.mark.parametrize("dtype", [np.int8, np.int32], ids=lambda d: np.dtype(d).name)
def test_bitwise_aggregations_match_reference(dtype):
    """The reference gives int64; the port the column's dtype, whose values
    must be the reference's."""
    rng = np.random.default_rng(3)
    k, kv = _key(rng)
    x, xv = _values(rng, dtype, k)
    port_g, ref_g = _groupers(k, kv, True)
    for op in ("and", "or", "xor"):
        got = gb.aggregate(_port(x, xv), port_g, f"bitwise_{op}")
        ref = getattr(ref_gb, f"group_bitwise_{op}")(_ref(x, xv), ref_g)
        exp, ok = _ref_values(ref)
        np.testing.assert_array_equal(_port_values(got)[1], ok)
        np.testing.assert_array_equal(got.data.numpy()[ok].astype(np.int64), exp[ok])


def test_bitwise_of_floats_raises():
    g = gb.make_grouper([_port(np.zeros(3, np.int32), None)])
    with pytest.raises(TypeError):
        gb.aggregate(_port(np.ones(3), None), g, "bitwise_or")


def _pair_frame(x, y, k, xv, yv):
    return pd.DataFrame({"k": k, "x": np.where(xv, x, np.nan), "y": np.where(yv, y, np.nan)})


@pytest.mark.parametrize("ddof", [0, 1])
def test_cov_corr_match_reference_on_small_integers(ddof):
    """Small integer values, where the reference's one-pass sums are exact:
    the port equals it and pandas over the pairwise-complete rows (a
    group with one such row gives NaN)."""
    rng = np.random.default_rng(4)
    k = rng.integers(0, 6, N).astype(np.int32)
    k[:1] = 6                                          # a group of one row
    x = rng.integers(0, 20, N).astype(np.float64)
    y = rng.integers(-5, 5, N).astype(np.float64)
    xv, yv = rng.random(N) > 0.1, rng.random(N) > 0.1
    xv[:1] = yv[:1] = True
    port_g, ref_g = _groupers(k, None, True)
    px, py = _port(x, xv), _port(y, yv)
    rx, ry = _ref(x, xv), _ref(y, yv)
    # the pairwise-complete rows of two columns are the complete rows; on
    # rows with NaN pandas' cov divides by count - 1 whatever its ddof
    pdf = _pair_frame(x, y, k, xv, yv).dropna()
    pcov = pdf.groupby("k")[["x", "y"]].cov(ddof=ddof).xs("x", level=1)["y"].to_numpy()
    pcorr = pdf.groupby("k")[["x", "y"]].corr().xs("x", level=1)["y"].to_numpy()
    got_cov = gb.group_cov(px, py, port_g, ddof)
    got_corr = gb.group_corr(px, py, port_g)
    for got, ref, pand, what in ((got_cov, ref_gb.group_cov(rx, ry, ref_g, ddof=ddof), pcov,
                                  "cov"),
                                 (got_corr, ref_gb.group_corr(rx, ry, ref_g), pcorr, "corr")):
        exp, ok = _ref_values(ref)
        _assert_same(got, exp, ok, 1e-9, f"{what} vs reference")
        _assert_same(got, pand, ~np.isnan(pand), 1e-9, f"{what} vs pandas")


def test_cov_corr_and_m2_near_1e8_match_pandas():
    """The reference's fault: over w = 1e8 + [1, 2, 3] its one-pass group
    variance is 0.0 (pandas 1.0) and corr NaN (pandas -0.866 and 1.0);
    the port's two passes give pandas' values."""
    k = np.array([0, 0, 0, 1, 1, 1], np.int32)
    w = 1e8 + np.array([1.0, 2.0, 3.0, 1.0, 2.0, 3.0])
    z = np.array([3.0, 1.0, 1.0, 10.0, 20.0, 30.0])
    g = gb.make_grouper([_port(k, None)])
    pdf = pd.DataFrame({"k": k, "w": w, "z": z})
    corr = gb.group_corr(_port(w, None), _port(z, None), g).data.numpy()
    exp = pdf.groupby("k")[["w", "z"]].corr().xs("w", level=1)["z"].to_numpy()
    np.testing.assert_allclose(corr, exp, rtol=1e-9)
    np.testing.assert_allclose(corr, [-np.sqrt(3) / 2, 1.0], rtol=1e-9)
    cov = gb.group_cov(_port(w, None), _port(w, None), g).data.numpy()
    np.testing.assert_allclose(cov, pdf.groupby("k")["w"].var().to_numpy(), rtol=1e-9)
    np.testing.assert_allclose(cov, [1.0, 1.0], rtol=1e-9)
    m2 = gb.aggregate(_port(w, None), g, "m2").data.numpy()
    np.testing.assert_allclose(m2, [2.0, 2.0], rtol=1e-9)
    ref_g = ref_gb.make_grouper([_ref(k, None)])
    ref_corr = np.asarray(ref_gb.group_corr(_ref(w, None), _ref(z, None), ref_g).data)
    assert not np.allclose(ref_corr, exp, rtol=1e-9, equal_nan=True)   # what the port avoids


@pytest.mark.parametrize("adjust", [True, False])
@pytest.mark.parametrize("ignore_na", [True, False])
def test_ewma_matches_pandas(adjust, ignore_na):
    """Each row's weighted mean within its group in row order, NaN rows
    carrying the running mean, rows before a group's first value null."""
    rng = np.random.default_rng(5)
    k, _ = _key(rng, nulls=False)
    x = rng.normal(0, 10, N)
    xv = rng.random(N) > 0.15
    x[:3] = np.nan
    xv[:3] = False
    g = gb.make_grouper([_port(k, None)])
    got = gb.group_ewma(_port(x, xv), g, 0.3, adjust, ignore_na)
    exp = pd.Series(np.where(xv, x, np.nan)).groupby(k).ewm(
        alpha=0.3, adjust=adjust, ignore_na=ignore_na).mean().droplevel(0).sort_index()
    _assert_same(got, exp.to_numpy(), ~np.isnan(exp.to_numpy()), 1e-9, "ewma")


def test_ewma_matches_reference():
    rng = np.random.default_rng(6)
    k, kv = _key(rng, nulls=False)
    x = rng.normal(0, 10, N)
    port_g, ref_g = _groupers(k, None, True)
    got = gb.group_ewma(_port(x, None), port_g, 0.25)
    exp, ok = _ref_values(ref_gb.group_ewma(_ref(x, None), ref_g, 0.25))
    _assert_same(got, exp, ok, 1e-9, "ewma vs reference")


@pytest.mark.parametrize("K", [10, 5000])
@pytest.mark.parametrize("agg", ["sum", "count", "mean", "min", "max", "size"])
def test_kernel_tier_transform_matches_sort_tier_and_pandas(agg, K):
    """transform_kernel_tier (the one-hot tier at K = 10, the radix tier at
    K = 5000, through their plain versions on the CPU) equals the sort
    tier's broadcast and pandas' transform, null keys giving null rows."""
    rng = np.random.default_rng(7)
    n = 3000
    k = rng.integers(0, K, n).astype(np.int32)
    kv = rng.random(n) > 0.05
    x = rng.integers(-50, 50, n).astype(np.int32)
    xv = rng.random(n) > 0.1
    key, vals = _port(k, kv), _port(x, xv)
    with option_context("groupby.fast_path_min_rows", 0):
        got = gb.transform_kernel_tier(key, [("x", vals, agg)])["x"]
    g = gb.make_grouper([key])
    spread = copying.gather(gb.aggregate(vals, g, agg), g.group_ids, bounds_check=False)
    rows = g.kept_rows.numpy()
    exp, exp_ok = np.zeros(n, spread.data.numpy().dtype), np.zeros(n, bool)
    exp[rows] = spread.data.numpy()
    exp_ok[rows] = True if spread.validity is None else spread.validity.numpy()
    assert got.dtype == spread.dtype
    _assert_same(got, exp, exp_ok, 1e-12, f"{agg} vs the sort tier")
    pdf = pd.DataFrame({"k": pd.array(np.where(kv, k, 0), dtype="Int32"),
                        "x": pd.array(x, dtype="Int32")})
    pdf.loc[~kv, "k"] = pd.NA
    pdf.loc[~xv, "x"] = pd.NA
    pexp = pdf.groupby("k")["x"].transform(agg)
    _assert_same(got, pexp.to_numpy(dtype=np.float64, na_value=np.nan),
                 ~pexp.isna().to_numpy(), 1e-12, f"{agg} vs pandas")


def test_kernel_tier_transform_declines_what_the_sort_tier_serves():
    """Two keys, a float key, a null-key group (dropna=False), NaN in a float
    mean and an aggregation outside sum/count/mean/min/max/size: None."""
    rng = np.random.default_rng(8)
    k = _port(rng.integers(0, 5, 100).astype(np.int32), rng.random(100) > 0.1)
    f = _port(rng.normal(size=100), None)
    nan = _port(np.where(rng.random(100) > 0.5, np.nan, 1.0), None)
    with option_context("groupby.fast_path_min_rows", 0):
        assert gb.transform_kernel_tier(f, [("x", f, "sum")]) is None
        assert gb.transform_kernel_tier(k, [("x", f, "sum")], dropna=False) is None
        assert gb.transform_kernel_tier(k, [("x", nan, "mean")]) is None
        assert gb.transform_kernel_tier(k, [("x", f, "median")]) is None
        assert gb.transform_kernel_tier(k, [("x", f, "sum")]) is not None


def test_frame_transform_takes_the_kernel_tier_without_a_grouper():
    """A frame's transform of an aggregation by one integer key is served
    by the kernel tiers and builds no grouper sort; the sort tier's answer
    (the tiers switched off) is the same, and pandas'."""
    rng = np.random.default_rng(9)
    pdf = pd.DataFrame({"k": rng.integers(0, 20, 500).astype(np.int32),
                        "v": rng.normal(size=500), "i": rng.integers(0, 9, 500)})
    df = ct.DataFrame.from_pandas(pdf, device=CPU)
    with option_context("groupby.fast_path_min_rows", 0):
        grouped = df.groupby("k")
        fast = grouped.transform("mean").to_pandas()
        assert grouped._grouper is None
    with option_context("groupby.onehot_fast_path", False):
        slow = df.groupby("k").transform("mean").to_pandas()
    exp = pdf.groupby("k").transform("mean")
    pd.testing.assert_frame_equal(fast, slow, rtol=1e-12)
    pd.testing.assert_frame_equal(fast, exp, rtol=1e-12)


@pytest.mark.parametrize("agg", ["collect", "list", "unique", "collect_set", "topk",
                                 "histogram", "tdigest"])
def test_list_aggregations_raise_naming_item_6(agg):
    """The LIST aggregations are ported (ROADMAP.md queue 1, item 6a): one
    list a group, through ``agg`` and ``aggregate`` alike; "topk" needs its
    k (``group_topk``); "tdigest" gives a STRUCT of each group's centroids,
    min and max (ported with item 6c)."""
    df = ct.DataFrame({"k": torch.tensor([1, 1, 2]), "v": torch.tensor([1.0, 2.0, 3.0])})
    g = gb.make_grouper([df._table["k"]])
    if agg == "topk":
        with pytest.raises(NotImplementedError, match="group_topk"):
            df.groupby("k").agg({"v": agg})
        with pytest.raises(NotImplementedError, match="group_topk"):
            gb.aggregate(df._table["v"], g, agg)
        return
    exp = [[1.0, 2.0], [3.0]] if agg not in ("histogram", "tdigest") else \
        [[{"value": 1.0, "count": 1}, {"value": 2.0, "count": 1}], [{"value": 3.0, "count": 1}]]
    if agg == "tdigest":
        exp = [{"centroids": [{"mean": 1.0, "weight": 1.0}, {"mean": 2.0, "weight": 1.0}],
                "min": 1.0, "max": 2.0},
               {"centroids": [{"mean": 3.0, "weight": 1.0}], "min": 3.0, "max": 3.0}]
    assert gb.aggregate(df._table["v"], g, agg).to_pylist() == exp
    assert df.groupby("k").agg({"v": agg})._table["v"].to_pylist() == exp


def test_rolling_raises_naming_item_8():
    """Grouped rolling windows are ported (``frame/window.py``, item 8):
    windows of rows within each group, as pandas gives them; a time offset
    (which the reference lacks) raises naming "beyond the reference"."""
    df = ct.DataFrame({"k": torch.tensor([1, 1, 2]), "v": torch.tensor([1.0, 2.0, 3.0])})
    assert df.groupby("k").rolling(2).sum()._table["v"].to_pylist()[1] == 3.0
    assert df.groupby("k")["v"].rolling(2, min_periods=1).sum().tolist() == [1.0, 3.0, 3.0]
    with pytest.raises(NotImplementedError, match="beyond the reference"):
        df.groupby("k")["v"].rolling("2D")
