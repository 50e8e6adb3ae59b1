"""The port's column layouts (temporal, STRING, DICTIONARY32) and its
``ops/binaryop.py``, ``ops/unary.py``, ``ops/reductions.py``,
``ops/search.py`` and copying of the new layouts, against the
reference's functions on the JAX CPU backend, on the same seeded numpy
inputs (the port's columns are built over the reference columns'
buffers).

Tolerances: integer, bool, temporal, string and index results exact;
float results rtol 1e-12 (elementwise ops give the same bits; sums and
moments may add in another order).  Nulls must sit in the same rows.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import torch_jax_cache  # noqa: F401  (the run's shared JAX compile cache)
from cudf_tpu.core import dtypes as ref_dt
from cudf_tpu.core.column import Column as RefColumn
from cudf_tpu.ops import binaryop as ref_bin
from cudf_tpu.ops import reductions as ref_red
from cudf_tpu.ops import search as ref_search
from cudf_tpu.ops import unary as ref_unary
import cudf_tpu_torch as ct
from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.ops import binaryop, copying, reductions, search, unary

torch.set_num_threads(1)

CPU = torch.device("cpu")
N = 200
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
    """Reference columns: int32 and float64 with nulls (and NaN), int64,
    bool with nulls, ns timestamps with nulls, s timestamps, a dictionary
    with null codes over keys out of byte order, and a STRING column."""
    rng = np.random.default_rng(seed)
    mask = rng.random(N) > 0.15
    f = rng.normal(0, 10, N)
    f[rng.random(N) < 0.05] = np.nan
    days = rng.integers(8000, 10500, N).astype("datetime64[D]")
    codes = rng.integers(0, len(KEYS), N).astype(np.int32)
    strings = rng.choice(["", "a", "ab", "abcdefghij", "b", "zz"], N)
    return {
        "i32": RefColumn.from_numpy(rng.integers(-50, 50, N).astype(np.int32), mask=mask),
        "i64": RefColumn.from_numpy(rng.integers(-(1 << 40), 1 << 40, N)),
        "f64": RefColumn.from_numpy(f, mask=rng.random(N) > 0.1),
        "bool": RefColumn.from_numpy(rng.random(N) > 0.5, mask=rng.random(N) > 0.1),
        "ts": RefColumn.from_numpy(days.astype("datetime64[ns]"), mask=mask),
        "ts_s": RefColumn.from_numpy(rng.integers(8000, 10500, N).astype("datetime64[D]")
                                     .astype("datetime64[s]")),
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


def assert_same(got: Column, exp: RefColumn, rtol=1e-12):
    """Same logical dtype, nulls in the same rows, equal values where valid."""
    assert got.length == exp.length
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


def assert_scalar(got, exp, rtol=1e-12):
    if exp is None or (isinstance(exp, float) and np.isnan(exp)):
        assert got is None or (isinstance(got, float) and np.isnan(got)), got
    elif isinstance(exp, float):
        np.testing.assert_allclose(got, exp, rtol=rtol)
    else:
        assert got == exp, (got, exp)


# ----------------------------------------------------------------------
# layouts and copying
# ----------------------------------------------------------------------

def test_layouts_round_trip_through_pandas():
    """datetime64 with NaT, strings with None and a Categorical with a
    null come back as the reference gives them, in pandas' dtypes."""
    pdf = pd.DataFrame({
        "t": pd.to_datetime(["1994-01-01", None, "1998-12-01"]),
        "s": pd.Series(["x", None, "yy"], dtype=object),
        "c": pd.Categorical(["SHIP", None, "AIR"]),
        "f": [1.5, np.nan, 3.0],
    })
    got = ct.from_pandas(pdf, device=CPU)
    assert got._table["c"].dtype.is_dictionary and got._table["s"].dtype.is_string
    assert got._table["t"].dtype == dt.dtype(pdf["t"].dtype)      # the unit kept
    out = got.to_pandas()
    assert out["t"].dtype == pdf["t"].dtype and out["t"].isna().tolist() == [False, True, False]
    assert isinstance(out["c"].dtype, pd.CategoricalDtype)
    assert out["c"].astype(object).tolist()[0::2] == ["SHIP", "AIR"] and out["c"].isna()[1]
    assert out["s"].tolist()[0::2] == ["x", "yy"] and out["s"].isna()[1]
    pd.testing.assert_series_equal(out["t"], pdf["t"])
    pd.testing.assert_series_equal(out["f"], pdf["f"])


def test_gather_and_decode_match_reference(cols):
    from cudf_tpu.ops import copying as ref_copying

    ref, port = cols
    rng = np.random.default_rng(1)
    idx = rng.integers(-3, N + 3, 77)
    for name in ("str", "dict", "ts", "i32"):
        for bounds in (True, False):
            i = idx if bounds else np.clip(idx, 0, N - 1)
            got = copying.gather(port[name], torch.from_numpy(i), bounds_check=bounds)
            exp = ref_copying.gather(ref[name], i, bounds_check=bounds)
            assert_same(got, exp)
    assert_same(port["dict"].decode_dictionary(), ref["dict"].decode_dictionary())
    assert copying.gather(port["dict"], torch.tensor([0, 1])).keys is port["dict"].keys


def test_copy_if_else_and_concatenate(cols):
    from cudf_tpu.ops import copying as ref_copying

    ref, port = cols
    mask = np.random.default_rng(2).random(N) > 0.5
    for a, b in (("i32", "f64"), ("str", "str"), ("ts", "ts")):
        got = copying.copy_if_else(torch.from_numpy(mask), port[a], port[b])
        assert_same(got, ref_copying.copy_if_else(mask, ref[a], ref[b]))
    got = copying.copy_if_else(torch.from_numpy(mask), port["f64"], 0.0)
    exp = ref_copying.copy_if_else(mask, ref["f64"], RefColumn.full(N, 0.0))
    assert_same(got, exp)
    for name in ("str", "i32", "dict"):
        got = copying.concatenate([port[name], copying.slice(port[name], 5, 60)])
        exp = ref_copying.concatenate([ref[name], ref_copying.slice(ref[name], 5, 60)])
        assert_same(got, exp)


# ----------------------------------------------------------------------
# binaryop
# ----------------------------------------------------------------------

ARITH = ["add", "sub", "mul", "truediv", "floordiv", "mod", "min", "max"]
CMP = ["eq", "ne", "lt", "gt", "le", "ge"]


PAIRS = [("i32", "i64"), ("f64", "i32"), ("i64", 7), (2.5, "f64"), ("bool", "bool"),
         ("i32", 0)]


@pytest.mark.parametrize("op,pair", [
    (op, pair) for pair in PAIRS for op in ARITH + CMP
    # bool division and subtraction raise in pandas and the reference (tested apart)
    if not (pair == ("bool", "bool") and op in ("truediv", "floordiv", "sub"))])
def test_numeric_ops_match_reference(cols, op, pair):
    """Against the reference; a float floor division by zero against
    numpy (pandas'): +-inf, where the reference gives NaN (ROADMAP.md
    queue 3)."""
    ref, port = cols

    def side(x, table):
        return table[x] if isinstance(x, str) else x

    got = binaryop.binary_operation(side(pair[0], port), side(pair[1], port), op)
    exp = ref_bin.binary_operation(side(pair[0], ref), side(pair[1], ref), op)
    if op == "floordiv" and exp.dtype.is_float:
        a, b = (np.asarray(side(x, ref).data) if isinstance(x, str) else x for x in pair)
        with np.errstate(divide="ignore", invalid="ignore"):
            exp = RefColumn(exp.dtype, exp.length, data=np.floor_divide(
                np.asarray(a, np.float64), np.asarray(b, np.float64)), validity=exp.validity)
    assert_same(got, exp)


@pytest.mark.parametrize("op", ["and", "or"])
def test_logical_ops_match_reference(cols, op):
    ref, port = cols
    cmp_p = binaryop.binary_operation(port["i32"], 0, "gt")
    cmp_r = ref_bin.binary_operation(ref["i32"], 0, "gt")
    assert_same(binaryop.binary_operation(cmp_p, port["bool"], op),
                ref_bin.binary_operation(cmp_r, ref["bool"], op))
    assert_same(binaryop.binary_operation(port["bool"], True, op),
                ref_bin.binary_operation(ref["bool"], True, op))


def test_bool_division_and_subtraction_raise(cols):
    ref, port = cols
    for op, err in (("truediv", NotImplementedError), ("floordiv", NotImplementedError),
                    ("sub", TypeError)):
        with pytest.raises(err):
            binaryop.binary_operation(port["bool"], port["bool"], op)
        with pytest.raises(err):
            ref_bin.binary_operation(ref["bool"], ref["bool"], op)


@pytest.mark.parametrize("op", CMP)
@pytest.mark.parametrize("literal", [np.datetime64("1994-01-01"),
                                     np.datetime64("1995-06-30T12:00:00", "s"),
                                     np.datetime64("1996-03-01T00:00:00.5", "ms")])
def test_temporal_literal_comparisons_rescale(cols, op, literal):
    """A datetime64[D] literal (turned into seconds) against a [ns]
    column, and finer literals: both sides in the common unit."""
    ref, port = cols
    got = binaryop.binary_operation(port["ts"], literal, op)
    assert_same(got, ref_bin.binary_operation(ref["ts"], literal, op))
    assert_same(binaryop.binary_operation(literal, port["ts_s"], op),
                ref_bin.binary_operation(literal, ref["ts_s"], op))
    # the days literal in ns, the way a wrong unit would go unnoticed
    ticks = int(np.datetime64(literal, "ns").astype(np.int64))
    expect = {"eq": np.equal, "ne": np.not_equal, "lt": np.less, "gt": np.greater,
              "le": np.less_equal, "ge": np.greater_equal}[op](np.asarray(ref["ts"].data), ticks)
    np.testing.assert_array_equal(got.data.numpy(), expect)


@pytest.mark.parametrize("op,pair", [
    ("lt", ("ts", "ts_s")), ("eq", ("ts_s", "ts")), ("sub", ("ts", "ts_s")),
    ("sub", ("ts", np.datetime64("1994-01-01"))), ("add", ("ts", np.timedelta64(3, "D"))),
    ("sub", ("ts_s", np.timedelta64(5400, "s"))), ("max", ("ts", "ts_s")),
])
def test_temporal_ops_match_reference(cols, op, pair):
    ref, port = cols

    def side(x, table):
        return table[x] if isinstance(x, str) else x

    got = binaryop.binary_operation(side(pair[0], port), side(pair[1], port), op)
    assert_same(got, ref_bin.binary_operation(side(pair[0], ref), side(pair[1], ref), op))


@pytest.mark.parametrize("op", CMP)
@pytest.mark.parametrize("value", ["SHIP", "AIR", "BOAT", ""])
def test_dictionary_against_string_scalar(cols, op, value):
    """Once a dictionary entry, gathered by code: the reference's answer,
    in both operand orders, for a key present, absent and empty."""
    ref, port = cols
    assert_same(binaryop.binary_operation(port["dict"], value, op),
                ref_bin.binary_operation(ref["dict"], value, op))
    assert_same(binaryop.binary_operation(value, port["dict"], op),
                ref_bin.binary_operation(value, ref["dict"], op))


@pytest.mark.parametrize("op", CMP)
def test_string_comparisons_match_reference(cols, op):
    ref, port = cols
    assert_same(binaryop.binary_operation(port["str"], "ab", op),
                ref_bin.binary_operation(ref["str"], "ab", op))
    rev = copying.reverse(port["str"])
    from cudf_tpu.ops import copying as ref_copying

    assert_same(binaryop.binary_operation(port["str"], rev, op),
                ref_bin.binary_operation(ref["str"], ref_copying.reverse(ref["str"]), op))


@pytest.mark.parametrize("op", ["null_equals", "null_max", "null_min"])
@pytest.mark.parametrize("pair", [("i32", "f64"), ("i32", "i32"), ("f64", 3.0)])
def test_null_aware_ops_match_reference(cols, op, pair):
    """A null beside a value gives the value (null_max / null_min), nulls
    equal nulls (null_equals)."""
    ref, port = cols

    def side(x, table):
        return table[x] if isinstance(x, str) else x

    got = binaryop.binary_operation(side(pair[0], port), side(pair[1], port), op)
    assert_same(got, ref_bin.binary_operation(side(pair[0], ref), side(pair[1], ref), op))


def test_null_scalars_and_division_by_zero(cols):
    ref, port = cols
    for op in ("add", "lt"):
        assert_same(binaryop.binary_operation(port["i32"], None, op),
                    ref_bin.binary_operation(ref["i32"], None, op))
    assert_same(binaryop.binary_operation(port["f64"], float("nan"), "lt"),
                ref_bin.binary_operation(ref["f64"], float("nan"), "lt"))
    zeros = RefColumn.from_numpy(np.zeros(N, np.int32))
    for op in ("floordiv", "mod"):
        assert_same(binaryop.binary_operation(port["i64"], port_of(zeros), op),
                    ref_bin.binary_operation(ref["i64"], zeros, op))


# ----------------------------------------------------------------------
# unary
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name,target", [
    ("i32", "float64"), ("f64", "float32"), ("i64", "int16"), ("bool", "int64"),
    ("ts", "datetime64[s]"), ("ts_s", "datetime64[ms]"), ("ts", "int64"), ("i64", "datetime64[ns]"),
    ("dict", "str"), ("dict", "float64"),
])
def test_cast_matches_reference(cols, name, target):
    """A dictionary casts through its decoded values (a string dictionary
    to str is its decode); other casts of strings are ops/strings.py's: a
    key that is no number raises ValueError, as in the reference."""
    ref, port = cols
    if target == "float64" and name == "dict":
        with pytest.raises(ValueError):
            unary.cast(port[name], dt.dtype(target))
        with pytest.raises(ValueError):
            ref_unary.cast(ref[name], ref_dt.dtype(target))
        return
    assert_same(unary.cast(port[name], dt.dtype(target)),
                ref_unary.cast(ref[name], ref_dt.dtype(target)))


@pytest.mark.parametrize("op", ["abs", "negate", "sqrt", "floor", "ceil", "exp", "not"])
@pytest.mark.parametrize("name", ["i32", "f64"])
def test_unary_operations_match_reference(cols, op, name):
    ref, port = cols
    with np.errstate(invalid="ignore"):
        assert_same(unary.unary_operation(port[name], op),
                    ref_unary.unary_operation(ref[name], op))


@pytest.mark.parametrize("fn", ["is_null", "is_valid", "is_nan"])
@pytest.mark.parametrize("name", ["i32", "f64", "dict", "ts"])
def test_null_predicates_match_reference(cols, fn, name):
    ref, port = cols
    assert_same(getattr(unary, fn)(port[name]), getattr(ref_unary, fn)(ref[name]))


@pytest.mark.parametrize("decimals,name", [(0, "f64"), (2, "f64"), (-1, "i32"), (-2, "i64")])
def test_round_matches_reference(cols, decimals, name):
    """Floats against the reference; integers to negative decimals
    against pandas (half to even), since the reference adds half a step
    away from zero before flooring (ROADMAP.md, port fault 2)."""
    ref, port = cols
    got = unary.round(port[name], decimals)
    if decimals >= 0:
        assert_same(got, ref_unary.round(ref[name], decimals))
        return
    valid = _valid(ref[name])
    exp = pd.Series(np.asarray(ref[name].data)[valid]).round(decimals).to_numpy()
    assert got.dtype == port[name].dtype
    np.testing.assert_array_equal(_valid(got), valid)
    np.testing.assert_array_equal(got.data.numpy()[valid], exp)


# ----------------------------------------------------------------------
# reductions
# ----------------------------------------------------------------------

REDUCTIONS = ["sum", "count", "mean", "min", "max", "var", "std", "median", "any", "all",
              "argmin", "argmax", "nunique", "product", "skew", "kurtosis", "sum_of_squares"]


@pytest.mark.parametrize("fn,name", [
    (fn, name) for name in ("i32", "f64", "bool") for fn in REDUCTIONS
    # an int32 product of 200 values overflows int64 in both
    if not (fn == "product" and name == "i32")])
def test_reductions_match_reference(cols, fn, name):
    """Against the reference; argmin and argmax against pandas' idxmin and
    idxmax, since the reference's overflow on an int32 column with nulls
    (ROADMAP.md queue 3)."""
    ref, port = cols
    if fn in ("argmin", "argmax"):
        s = pd.Series(port[name].to_numpy()).astype("float64")
        assert getattr(reductions, fn)(port[name]) == getattr(s, "idx" + fn[3:])()
        return
    assert_scalar(getattr(reductions, fn)(port[name]), getattr(ref_red, fn)(ref[name]),
                  rtol=1e-9 if fn in ("skew", "kurtosis") else 1e-12)


@pytest.mark.parametrize("name", ["ts", "ts_s", "dict", "str"])
def test_min_max_of_temporal_and_keyed_columns(cols, name):
    ref, port = cols
    for fn in ("min", "max", "count"):
        assert_scalar(getattr(reductions, fn)(port[name]), getattr(ref_red, fn)(ref[name]))


def test_quantiles_match_reference(cols):
    ref, port = cols
    for interp in ("linear", "lower", "higher", "nearest", "midpoint"):
        np.testing.assert_allclose(
            reductions.quantile(port["f64"], [0.1, 0.5, 0.93], interp),
            ref_red.quantile(ref["f64"], [0.1, 0.5, 0.93], interp), rtol=1e-12)


# ----------------------------------------------------------------------
# search
# ----------------------------------------------------------------------

def _sorted(ref_col):
    from cudf_tpu.ops import copying as ref_copying
    from cudf_tpu.ops.sort import sorted_order

    return ref_copying.gather(ref_col, sorted_order([ref_col]), bounds_check=False)


@pytest.mark.parametrize("name", ["i64", "f64", "ts", "str", "i32"])
def test_lower_and_upper_bound_match_reference(cols, name):
    """Valid needles against the reference.  Null rows are equal to each
    other in the port (pandas' rule), so a null needle's bounds are the
    haystack's null run; the reference orders null rows by their
    leftover data (ROADMAP.md queue 3) and places them inside it."""
    ref, port = cols
    hay = _sorted(ref[name])
    valid = _valid(ref[name])
    n_valid = int(_valid(hay).sum())
    for fn, null_at in (("lower_bound", n_valid), ("upper_bound", N)):
        got = getattr(search, fn)(port_of(hay), port[name]).numpy()
        exp = np.asarray(getattr(ref_search, fn)(hay, ref[name]))
        np.testing.assert_array_equal(got[valid], exp[valid])
        assert (got[~valid] == null_at).all()


@pytest.mark.parametrize("name", ["i32", "f64", "str", "dict", "ts"])
def test_contains_matches_reference(cols, name):
    """isin: null needles match null haystack rows, NaN matches NaN."""
    from cudf_tpu.ops import copying as ref_copying

    ref, port = cols
    hay = ref_copying.slice(ref[name], 0, 40)
    got = search.contains(port_of(hay), port[name])
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_search.contains(hay, ref[name])))
