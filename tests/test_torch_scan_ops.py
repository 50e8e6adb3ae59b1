"""``ops/scan.py`` against the reference's (the JAX CPU backend) and
pandas, on the seeded inputs of ``test_torch_column_ops.py``: the four
scans over every dtype family, ``cumcount``, ``ewm_mean`` in its four
modes.  A float column whose NaN is not null is held to pandas (the
reference lets the NaN run through every later row; pandas skips it).
Tolerances: exact but for float scans (rtol 1e-12; float32 1e-6).
"""

import numpy as np
import pandas as pd
import pytest
import torch

import torch_jax_cache  # noqa: F401  (the run's shared JAX compile cache)
from cudf_tpu.core import dtypes as ref_dt
from cudf_tpu.core.column import Column as RefColumn
from cudf_tpu.ops import scan as ref_scan
import cudf_tpu_torch as ct
from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.ops import copying, scan

torch.set_num_threads(1)

CPU = torch.device("cpu")
N = 300
KEYS = ["MAIL", "SHIP", "AIR", "TRUCK", "RAIL"]     # not in byte order


def port_of(ref: RefColumn) -> Column:
    """The port's column over a reference column's buffers."""
    d = dt.DType(dt.TypeId[ref.dtype.id.name])
    if ref.dtype.is_dictionary:
        keys = port_of(ref.children[0])
        d = dt.dictionary_dtype(keys.dtype if keys.dtype.is_numeric else dt.STRING)
    validity = None if ref.validity is None else torch.from_numpy(np.asarray(ref.validity).copy())
    offsets = None if ref.offsets is None else torch.from_numpy(np.asarray(ref.offsets).copy())
    data = torch.from_numpy(np.asarray(ref.data).copy())
    return Column(d, ref.length, data, validity, offsets,
                  tuple(port_of(c) for c in ref.children))


def _inputs(seed):
    """int32, float64 (no NaN) and bool with nulls, int64, uint8, float32,
    ns timestamps with nulls, a dictionary with null codes and a STRING
    column with nulls."""
    rng = np.random.default_rng(seed)
    mask = rng.random(N) > 0.15
    days = rng.integers(8000, 10500, N).astype("datetime64[D]")
    codes = rng.integers(0, len(KEYS), N).astype(np.int32)
    strings = rng.choice(["", "a", "ab", "abcdefghij", "b", "zz"], N).astype(object)
    strings[rng.random(N) < 0.1] = None
    return {
        "i32": RefColumn.from_numpy(rng.integers(-50, 50, N).astype(np.int32), mask=mask),
        "i64": RefColumn.from_numpy(rng.integers(-(1 << 20), 1 << 20, N)),
        "u8": RefColumn.from_numpy(rng.integers(0, 4, N).astype(np.uint8)),
        "f32": RefColumn.from_numpy(rng.normal(1, 0.1, N).astype(np.float32)),
        "f64": RefColumn.from_numpy(rng.normal(1, 0.05, N), mask=rng.random(N) > 0.1),
        "bool": RefColumn.from_numpy(rng.random(N) > 0.5, mask=rng.random(N) > 0.1),
        "ts": RefColumn.from_numpy(days.astype("datetime64[ns]"), mask=mask),
        "dict": RefColumn(ref_dt.dictionary_dtype(ref_dt.STRING), N, data=codes,
                          validity=np.asarray(mask), children=(RefColumn.from_strings(KEYS),)),
        "str": RefColumn.from_strings(list(strings)),
    }


@pytest.fixture(scope="module")
def cols():
    ref = _inputs(0)
    return ref, {k: port_of(v) for k, v in ref.items()}


def _valid(c):
    return np.ones(c.length, bool) if c.validity is None else np.asarray(c.validity)


def assert_same(got: Column, exp: RefColumn, rtol=1e-12, dtype=True):
    """Same logical dtype, nulls in the same rows, equal values where valid."""
    assert got.length == exp.length
    if dtype:
        assert got.dtype.id.name == exp.dtype.id.name, (got.dtype, exp.dtype)
    gv, ev = _valid(got), _valid(exp)
    np.testing.assert_array_equal(gv, ev)
    if exp.dtype.is_string or exp.dtype.is_dictionary:
        assert list(got.to_numpy()[ev]) == list(exp.to_numpy()[ev])
        return
    g = got.data.numpy()[ev]
    e = np.asarray(exp.data)[ev]
    if exp.dtype.is_float:
        np.testing.assert_allclose(g, e, rtol=rtol, equal_nan=True)
    else:
        np.testing.assert_array_equal(g, e)


# ----------------------------------------------------------------------
# scans
# ----------------------------------------------------------------------

@pytest.mark.parametrize("op,name", [("cumsum", n) for n in ("i32", "i64", "u8", "f32", "f64",
                                                              "bool")]
                         + [(op, n) for op in ("cummin", "cummax") for n in ("i32", "f64", "bool")]
                         + [("cumprod", n) for n in ("f32", "f64", "bool")])
def test_scans_match_reference(cols, name, op):
    ref, port = cols
    assert_same(getattr(scan, op)(port[name]), getattr(ref_scan, op)(ref[name]), rtol=1e-6
                if name == "f32" else 1e-12)


@pytest.mark.parametrize("name", ["i64", "u8", "f32"])
def test_running_extremes_of_other_widths_match_numpy(cols, name):
    """cummin / cummax of the widths the reference test leaves out, and a
    column longer than one 4096-row block, against numpy's accumulate."""
    _, port = cols
    for col in (port[name], copying.tile(port[name], 50)):
        x = col.data.numpy()
        np.testing.assert_array_equal(scan.cummin(col).data.numpy(), np.minimum.accumulate(x))
        np.testing.assert_array_equal(scan.cummax(col).data.numpy(), np.maximum.accumulate(x))


def test_cumcount_and_timestamp_extremes_match_reference(cols):
    ref, port = cols
    assert_same(scan.cumcount(port["i32"]), ref_scan.cumcount(ref["i32"]))
    for op in ("cummin", "cummax"):
        assert_same(getattr(scan, op)(port["ts"]), getattr(ref_scan, op)(ref["ts"]))


@pytest.mark.parametrize("op", ["cumsum", "cumprod", "cummin", "cummax"])
def test_scans_skip_a_nan_that_is_not_null_as_pandas(op):
    """A tensor-built float column's NaN is a value, not a null: pandas
    skips it and keeps it at its row; the reference lets it run on."""
    x = np.array([1.0, np.nan, 3.0, 2.0, np.nan, 0.5])
    got = getattr(ct.Series(torch.from_numpy(x)), op)().to_numpy()
    exp = getattr(pd.Series(x), op)().to_numpy()
    np.testing.assert_array_equal(got, exp)
    ref = getattr(ref_scan, op)(RefColumn.from_numpy(x, mask=np.ones(6, bool)))
    assert np.isnan(np.asarray(ref.data)[2])          # the reference's fault


@pytest.mark.parametrize("adjust", [True, False])
@pytest.mark.parametrize("ignore_na", [True, False])
def test_ewm_mean_matches_reference(cols, adjust, ignore_na):
    ref, port = cols
    got = scan.ewm_mean(port["f64"], 0.3, adjust=adjust, ignore_na=ignore_na)
    assert_same(got, ref_scan.ewm_mean(ref["f64"], 0.3, adjust=adjust, ignore_na=ignore_na))
    exp = pd.Series(port["f64"].to_numpy()).ewm(alpha=0.3, adjust=adjust,
                                               ignore_na=ignore_na).mean()
    np.testing.assert_allclose(got.to_numpy(), exp.to_numpy(), rtol=1e-12)


def test_ewm_mean_stays_finite_over_long_columns():
    """The doubling scan never forms (1 - alpha) ** -t: a million rows
    at alpha 0.5 stay finite and equal pandas."""
    x = np.random.default_rng(3).normal(size=1 << 20)
    got = scan.ewm_mean(Column.from_numpy(x, device=CPU), 0.5).to_numpy()
    exp = pd.Series(x).ewm(alpha=0.5).mean().to_numpy()
    np.testing.assert_allclose(got, exp, rtol=1e-9, atol=1e-12)
