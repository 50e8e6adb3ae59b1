"""``ops/dictionary.py``, ``approx_distinct_count``, ``Over`` through the
engine and pandas' nullable dtypes against the reference (the JAX CPU
backend) and pandas, on the seeded inputs of ``test_torch_column_ops.py``.

Two dictionaries over different keys meet over the union of their keys
here, where the reference re-encodes the decoded rows: codes are held
to the reference where both keep every key, else the values they stand
for are.  ``approx_distinct_count`` hashes as the reference does, so
its estimate is equal, not close.  Tolerances: exact but for float
aggregates (rtol 1e-12).
"""

import numpy as np
import pandas as pd
import pytest
import torch

import torch_jax_cache  # noqa: F401  (the run's shared JAX compile cache)
from cudf_tpu import engine as ref_engine
from cudf_tpu.core import dtypes as ref_dt
from cudf_tpu.core.column import Column as RefColumn
from cudf_tpu.frame.dataframe import DataFrame as RefDataFrame
from cudf_tpu.ops import dictionary as ref_dictionary
from cudf_tpu.ops import stream_compaction as ref_sc
import cudf_tpu_torch as ct
from cudf_tpu_torch import engine as pe
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.ops import copying, dictionary, unary
from cudf_tpu_torch.ops import stream_compaction as sc
from cudf_tpu_torch.core import dtypes as dt

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


@pytest.fixture(scope="module")
def cols():
    ref = _inputs(0)
    return ref, {k: port_of(v) for k, v in ref.items()}


# ----------------------------------------------------------------------
# dictionaries
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", ["i32", "f64", "str", "ts"])
@pytest.mark.parametrize("sort", [True, False])
def test_factorize_and_encode_match_reference(cols, name, sort):
    """A temporal column factorizes; only numeric and string values
    become a dictionary's keys (the Column layout's contract)."""
    ref, port = cols
    codes, keys = dictionary.factorize(port[name], sort=sort)
    r_codes, r_keys = ref_dictionary.factorize(ref[name], sort=sort)
    valid = _valid(ref[name])
    np.testing.assert_array_equal(codes.numpy()[valid], np.asarray(r_codes)[valid])
    assert_same(keys, r_keys)
    if name == "ts":
        return
    enc = dictionary.encode(port[name])
    assert enc.dtype.is_dictionary
    assert enc.to_numpy()[valid].tolist() == port[name].to_numpy()[valid].tolist()
    np.testing.assert_array_equal(_valid(enc), valid)
    assert unary.cast(port[name], "category").to_numpy()[valid].tolist() == \
        enc.to_numpy()[valid].tolist()


def test_match_dictionaries_and_set_keys_match_reference(cols):
    ref, port = cols
    other_keys = ["ZIP", "AIR", "BOAT"]
    codes = np.random.default_rng(4).integers(0, 3, 50).astype(np.int32)
    r_b = RefColumn(ref_dt.dictionary_dtype(ref_dt.STRING), 50, data=codes,
                    children=(RefColumn.from_strings(other_keys),))
    b = port_of(r_b)
    ea, eb = dictionary.match_dictionaries(port["dict"], b)
    ra, rb = ref_dictionary.match_dictionaries(ref["dict"], r_b)
    assert ea.keys is eb.keys
    assert_same(ea, ra)
    assert_same(eb, rb)
    new_keys = ["AIR", "RAIL", "ZZZ"]
    got = dictionary.set_keys(port["dict"], Column.from_strings(new_keys, device=CPU))
    exp = ref_dictionary.set_keys(ref["dict"], RefColumn.from_strings(new_keys))
    assert_same(got, exp)


def test_dictionaries_over_different_keys_concatenate_scatter_and_select(cols):
    """concatenate, scatter and copy_if_else over two dictionaries with
    different keys (the parent raised) give pandas' values."""
    _, port = cols
    a = port["dict"]
    b = dictionary.encode(Column.from_strings(["ZIP", None, "AIR", "BOAT"] * 5, device=CPU))
    va, vb = pd.Series(a.to_numpy(), dtype=object), pd.Series(b.to_numpy(), dtype=object)
    cat = copying.concatenate([a, b])
    assert cat.dtype.is_dictionary
    assert cat.to_numpy().tolist() == pd.concat([va, vb]).tolist()
    rows = np.arange(0, 40, 2)
    got = copying.scatter(b, torch.from_numpy(rows), a).to_numpy()
    exp = va.copy()
    exp.iloc[rows] = vb.to_numpy()
    assert got.tolist() == exp.tolist()
    mask = np.random.default_rng(5).random(20) < 0.5
    sel = copying.copy_if_else(torch.from_numpy(mask), copying.slice(a, 0, 20), b)
    assert sel.dtype.is_dictionary
    assert sel.to_numpy().tolist() == np.where(mask, va[:20], vb).tolist()


def test_outer_join_coalesces_keys_of_two_dictionaries():
    left = ct.DataFrame({"k": pd.Categorical(["a", "b", "c"]), "x": [1, 2, 3]}, device=CPU)
    right = ct.DataFrame({"k": pd.Categorical(["d", "b", "a"]), "y": [4.0, 5.0, 6.0]},
                         device=CPU)
    got = left.merge(right, on="k", how="outer", sort=True).to_pandas()
    exp = pd.DataFrame({"k": ["a", "b", "c", "d"]}).merge(
        pd.DataFrame({"k": ["a", "b", "c"], "x": [1, 2, 3]}), how="left").merge(
        pd.DataFrame({"k": ["d", "b", "a"], "y": [4.0, 5.0, 6.0]}), how="left")
    assert got["k"].astype(str).tolist() == exp["k"].tolist()
    np.testing.assert_array_equal(got["x"].to_numpy(), exp["x"].to_numpy())
    np.testing.assert_array_equal(got["y"].to_numpy(), exp["y"].to_numpy())


@pytest.mark.parametrize("name", ["i64", "f64", "str", "dict"])
def test_approx_distinct_count_equals_reference(cols, name):
    ref, port = cols
    assert sc.approx_distinct_count(port[name]) == ref_sc.approx_distinct_count(ref[name])
    big = np.random.default_rng(6).integers(0, 40_000, 100_000)
    got = sc.approx_distinct_count(Column.from_numpy(big, device=CPU))
    assert got == ref_sc.approx_distinct_count(RefColumn.from_numpy(big))
    assert abs(got - len(np.unique(big))) < 0.05 * len(np.unique(big))


# ----------------------------------------------------------------------
# Over, and pandas' nullable dtypes
# ----------------------------------------------------------------------

@pytest.mark.parametrize("agg", ["sum", "mean", "count"])
def test_over_matches_reference_engine(agg):
    rng = np.random.default_rng(7)
    pdf = pd.DataFrame({"k": rng.integers(0, 6, 80), "j": rng.integers(0, 2, 80),
                        "v": rng.normal(size=80)})
    pdf.loc[rng.random(80) < 0.1, "v"] = np.nan
    port = ct.from_pandas(pdf, device=CPU)
    ref = RefDataFrame.from_pandas(pdf)

    def plan(ns, lf):
        return lf.with_columns(getattr(ns.col("v"), agg)().over("k", "j").alias("w"))

    got = plan(pe, pe.from_dataframe(port)).collect().to_pandas()
    exp = plan(ref_engine, ref_engine.from_dataframe(ref)).collect().to_pandas()
    np.testing.assert_allclose(got["w"].to_numpy(dtype=float), exp["w"].to_numpy(dtype=float),
                               rtol=1e-12)
    pand = pdf.groupby(["k", "j"])["v"].transform(agg).to_numpy(dtype=float)
    np.testing.assert_allclose(got["w"].to_numpy(dtype=float), pand, rtol=1e-12)


@pytest.mark.parametrize("dtype", ["Int8", "Int16", "Int32", "Int64", "UInt8", "UInt16",
                                   "UInt32", "UInt64", "boolean", "Float32", "Float64"])
def test_nullable_pandas_dtypes_round_trip(dtype):
    values = [True, None, False, True] if dtype == "boolean" else [1, None, 3, 4]
    s = pd.Series(values, dtype=dtype)
    col = Column.from_pandas(s, device=CPU)
    assert col.validity is not None and col.validity.tolist() == [True, False, True, True]
    back = pd.Series(col.to_pandas_array())
    assert back.dtype == s.dtype and back.equals(s)
    pdf = pd.DataFrame({"a": s, "b": np.arange(4)})
    pd.testing.assert_frame_equal(ct.DataFrame.from_pandas(pdf, device=CPU).to_pandas(), pdf)
