"""The rest of the port's groupby family (``cudf_tpu_torch/ops/groupby.py``):
sum_of_squares, m2, cov, corr and ewma on the sort tier, against
cudf_tpu's on the JAX CPU backend and against pandas / numpy, on the same
seeded numpy inputs (the bitwise aggregations are in
``tests/test_torch_groupby_bitwise.py``, the kernel-tier transform in
``tests/test_torch_groupby_transform.py``).

Tolerances: group ids, keys, counts, integer and bitwise results exact;
float sums rtol 1e-12; m2, cov, corr and ewm rtol 1e-9.  Where the
reference is wrong (ROADMAP.md queue 3) the case is held to pandas: its
group cov and corr take one-pass sums (``sxy - sx*sy/n``), which cancel
over values near 1e8, so those cases would fail if the port copied it.
The reference's ewma runs reset scans that take seconds a dtype to
compile on a CPU, so it is held to it in one form and to pandas in the
rest.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import torch_jax_cache  # noqa: F401  (the run's shared JAX compile cache)
from cudf_tpu.ops import groupby as ref_gb
from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.ops import groupby as gb
from torch_groupby_family_helpers import (N, _assert_same, _groupers, _key, _port, _ref, _ref_values, _values)

torch.set_num_threads(1)

DTYPES = [np.int8, np.int16, np.int32, np.int64, np.uint8, np.uint16, np.uint32,
          np.float32, np.float64, np.bool_]


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
