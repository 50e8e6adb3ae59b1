"""The column primitives of the pandas API slice against the reference's
functions on the JAX CPU backend, on the same seeded numpy inputs (the
port's columns are built over the reference columns' buffers):
the rest of ``ops/copying.py`` and ``ops/replace.py``, and the integer
``pow`` repair (``test_torch_scan_ops.py`` holds ``ops/scan.py``,
``test_torch_dictionary_ops.py`` the dictionaries, ``Over`` and
pandas' nullable dtypes, on the same inputs).

Where the reference is wrong the case is held to pandas instead: an
integer power with a negative exponent (the reference wraps; pandas
raises ValueError) and a null row in ``replace_values`` (the reference
replaces it when its hidden value equals an old value).
Tolerances: integer, bool, temporal and string results exact; float
results rtol 1e-12.  Nulls must sit in the same rows.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from cudf_tpu.core import dtypes as ref_dt
from cudf_tpu.core.column import Column as RefColumn
from cudf_tpu.ops import copying as ref_copying
from cudf_tpu.ops import replace as ref_replace
import cudf_tpu_torch as ct
from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.ops import binaryop, copying, replace

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
# the repair: an integer power with a negative integer exponent
# ----------------------------------------------------------------------

@pytest.mark.parametrize("form", ["scalar", "column"])
def test_integer_pow_with_negative_exponent_raises_as_pandas(form):
    """pandas (numpy) raises ValueError; the parent gave 0 for a column
    exponent and torch's RuntimeError for a scalar one."""
    base = np.array([5, 2, 3], np.int64)
    exp = -1 if form == "scalar" else np.array([-1, 1, 2], np.int64)
    with pytest.raises(ValueError, match="negative integer powers"):
        pd.Series(base) ** (exp if form == "scalar" else pd.Series(exp))
    col = Column.from_numpy(base, device=CPU)
    other = exp if form == "scalar" else Column.from_numpy(exp, device=CPU)
    with pytest.raises(ValueError, match="negative integer powers"):
        binaryop.binary_operation(col, other, "pow")
    s = ct.Series(base, device=CPU)
    with pytest.raises(ValueError, match="negative integer powers"):
        s ** (exp if form == "scalar" else ct.Series(exp, device=CPU))
    ok = np.array([0, 1, 2], np.int64)
    got = (s ** ct.Series(ok, device=CPU)).to_numpy()
    np.testing.assert_array_equal(got, (pd.Series(base) ** pd.Series(ok)).to_numpy())


# ----------------------------------------------------------------------
# copying
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", ["i32", "f64", "bool", "ts", "dict", "str"])
@pytest.mark.parametrize("periods,fill", [(3, None), (-2, None), (2, 7)])
def test_shift_matches_reference(cols, name, periods, fill):
    ref, port = cols
    if fill is not None and name in ("dict", "str", "ts", "bool"):
        fill = {"dict": "AIR", "str": "q", "ts": np.datetime64("1999-01-01", "ns"),
                "bool": True}[name]
        if name in ("dict", "str", "ts"):
            got = pd.Series(copying.shift(port[name], periods, fill).to_numpy())
            exp = pd.Series(port[name].to_numpy()).shift(periods, fill_value=fill)
            pd.testing.assert_series_equal(got, exp, check_dtype=False)
            return
    assert_same(copying.shift(port[name], periods, fill),
                ref_copying.shift(ref[name], periods, fill))


@pytest.mark.parametrize("name", ["i32", "f64", "dict", "str"])
def test_repeat_tile_interleave_get_element_match_reference(cols, name):
    ref, port = cols
    counts = np.random.default_rng(1).integers(0, 3, N)
    assert_same(copying.repeat(port[name], 2), ref_copying.repeat(ref[name], 2))
    assert_same(copying.repeat(port[name], torch.from_numpy(counts)),
                ref_copying.repeat(ref[name], counts))
    assert_same(copying.tile(port[name], 3), ref_copying.tile(ref[name], 3))
    if name != "dict":
        assert_same(copying.interleave_columns([port[name], port[name]]),
                    ref_copying.interleave_columns([ref[name], ref[name]]))
    for i in (0, 7, -1):
        got, exp = copying.get_element(port[name], i), ref_copying.get_element(ref[name], i)
        assert got == exp or (got is None and exp is None), (got, exp)


@pytest.mark.parametrize("name,value", [("i32", 9), ("f64", 2.5), ("bool", False),
                                        ("i32", None)])
def test_scatter_scalar_matches_reference(cols, name, value):
    ref, port = cols
    rows = np.array([0, 5, 17, N - 1])
    assert_same(copying.scatter_scalar(value, torch.from_numpy(rows), port[name]),
                ref_copying.scatter_scalar(value, rows, ref[name]))


def test_sample_draws_distinct_member_rows():
    """sample draws from a torch.Generator, so its rows are not the
    reference's jax.random rows: held to its properties."""
    col = Column.from_numpy(np.arange(1000, dtype=np.int64) * 3, device=CPU)
    got = copying.sample(col, 100, seed=5).to_numpy()
    assert len(got) == 100 and len(set(got)) == 100 and set(got) <= set(range(0, 3000, 3))
    assert np.array_equal(got, copying.sample(col, 100, seed=5).to_numpy())
    rep = copying.sample(col, 3000, seed=5, replace=True).to_numpy()
    assert len(rep) == 3000 and len(set(rep)) < 1000 and set(rep) <= set(range(0, 3000, 3))
    with pytest.raises(ValueError):
        copying.sample(col, 1001)


# ----------------------------------------------------------------------
# replace
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", ["i32", "f64", "bool", "ts", "dict", "str"])
@pytest.mark.parametrize("limit", [None, 1])
def test_ffill_bfill_match_reference(cols, name, limit):
    ref, port = cols
    assert_same(replace.ffill(port[name], limit), ref_replace.ffill(ref[name], limit))
    assert_same(replace.bfill(port[name], limit), ref_replace.bfill(ref[name], limit))


@pytest.mark.parametrize("name,olds,news", [
    ("i32", [1, 2, -3], [100, 200, 300]),
    ("i64", [5, 6], [0, 0]),
    ("f64", [1.0], [7.5]),
    ("str", ["a", "zz"], ["A", "Z"]),
])
def test_replace_values_matches_reference(cols, name, olds, news):
    """Equal to the reference on the valid rows; a null row stays null, as
    in pandas (the reference replaces a null row whose hidden value equals
    an old value)."""
    from cudf_tpu.core.column import as_column

    ref, port = cols
    got = replace.replace_values(port[name], Column.from_pylist(olds, device=CPU),
                                 Column.from_pylist(news, device=CPU))
    exp = ref_replace.replace_values(ref[name], as_column(olds), as_column(news))
    valid = _valid(ref[name])
    np.testing.assert_array_equal(_valid(got), valid)
    assert got.to_numpy()[valid].tolist() == np.asarray(exp.to_numpy())[valid].tolist()
    pand = pd.Series(port[name].to_numpy()).replace(olds, news)
    assert got.to_numpy()[valid].tolist() == pand[valid].tolist()


@pytest.mark.parametrize("name,value", [("i32", 4), ("f64", -1.0), ("i32", None),
                                        ("f64", None)])
def test_replace_where_and_clamp_match_reference(cols, name, value):
    ref, port = cols
    mask = np.random.default_rng(2).random(N) < 0.3
    assert_same(replace.replace_where(port[name], torch.from_numpy(mask), value),
                ref_replace.replace_where(ref[name], mask, value))
    lo, hi = (-10, 10) if name == "i32" else (0.95, 1.05)
    assert_same(replace.clamp(port[name], lo, hi), ref_replace.clamp(ref[name], lo, hi))
    assert_same(replace.clamp(port[name], None, hi), ref_replace.clamp(ref[name], None, hi))
