"""Six faults of the port's scalar ops, engine and groupby (ROADMAP.md
§3, port faults 1-6), each held where it belongs: the unsigned ops to
the reference's functions on the JAX CPU backend, and the faults the
port copied from the reference (integer ``round`` with negative
decimals, projection pushdown through a join, temporal group
aggregations) to pandas or to the unoptimised plan.

1. uint16/32/64 columns through every binary op, the unary ops that
   raised, and the reductions, against the reference (values at and above
   2^31 and 2^63 included);
2. integer ``round`` to negative decimals: half to even, as pandas;
3. a right-side column read under its suffixed name after a join;
4. group mean / median / std of timestamps and durations as pandas gives
   them, and a timestamp sum (or any var) raising TypeError;
5. ``sign`` of NaN is NaN;
6. ``abs`` and ``cbrt`` of a bool column return the column.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from cudf_tpu.core.column import Column as RefColumn
from cudf_tpu.ops import binaryop as ref_bin
from cudf_tpu.ops import reductions as ref_red
from cudf_tpu.ops import unary as ref_unary
import cudf_tpu_torch as ct
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.engine import col, from_dataframe
from cudf_tpu_torch.ops import binaryop, reductions, unary

torch.set_num_threads(1)

CPU = torch.device("cpu")
UNSIGNED = ["uint16", "uint32", "uint64"]
N = 64


def _unsigned(dtype, seed, small=False):
    """numpy values of an unsigned dtype over its whole range (the top
    half included), with a mask; small: values below 64 (shift amounts,
    exponents, divisors kept away from zero)."""
    rng = np.random.default_rng(seed)
    info = np.iinfo(dtype)
    if small:
        vals = rng.integers(1, 6, N).astype(dtype)
    else:
        vals = rng.integers(0, int(info.max), N, dtype=np.uint64, endpoint=True).astype(dtype)
        vals[:4] = [0, 1, info.max, info.max // 2 + 1]
    return vals, rng.random(N) > 0.1


def _pair(dtype, seed, small=False):
    vals, mask = _unsigned(dtype, seed, small)
    return RefColumn.from_numpy(vals, mask=mask), Column.from_numpy(vals, device=CPU).with_validity(
        torch.from_numpy(mask))


def _same(got: Column, exp: RefColumn):
    assert got.dtype.id.name == exp.dtype.id.name, (got.dtype, exp.dtype)
    ev = np.ones(exp.length, bool) if exp.validity is None else np.asarray(exp.validity)
    gv = np.ones(got.length, bool) if got.validity is None else got.validity.numpy()
    np.testing.assert_array_equal(gv, ev)
    g, e = got.data.numpy()[ev], np.asarray(exp.data)[ev]
    if e.dtype.kind == "f":
        np.testing.assert_allclose(g, e, rtol=1e-12)
    else:
        np.testing.assert_array_equal(g, e)


BINARY = ["add", "sub", "mul", "floordiv", "mod", "pow", "bitand", "bitor", "bitxor",
          "shiftleft", "shiftright", "eq", "ne", "lt", "gt", "le", "ge", "min", "max",
          "null_min", "null_max"]
SMALL_RHS = {"floordiv", "mod", "pow", "shiftleft", "shiftright"}


@pytest.mark.parametrize("op", BINARY)
@pytest.mark.parametrize("dtype", UNSIGNED)
def test_unsigned_binary_ops_match_reference(dtype, op):
    ref_a, a = _pair(dtype, 1)
    ref_b, b = _pair(dtype, 2, small=op in SMALL_RHS)
    _same(binaryop.binary_operation(a, b, op), ref_bin.binary_operation(ref_a, ref_b, op))


@pytest.mark.parametrize("dtype", UNSIGNED)
def test_unsigned_ops_with_zero_divisors_and_scalars_match_reference(dtype):
    """Division by zero (pandas' float64 inf and NaN) and a uint scalar."""
    ref_a, a = _pair(dtype, 3)
    vals = np.array([0, 3] * (N // 2), dtype=dtype)
    ref_b, b = RefColumn.from_numpy(vals), Column.from_numpy(vals, device=CPU)
    for op in ("floordiv", "mod"):
        _same(binaryop.binary_operation(a, b, op), ref_bin.binary_operation(ref_a, ref_b, op))
    s = np.dtype(dtype).type(np.iinfo(dtype).max // 3)
    for op in ("lt", "max", "sub"):
        _same(binaryop.binary_operation(a, s, op), ref_bin.binary_operation(ref_a, s, op))


@pytest.mark.parametrize("op", ["abs", "negate", "sign", "bit_invert"])
@pytest.mark.parametrize("dtype", UNSIGNED)
def test_unsigned_unary_ops_match_reference(dtype, op):
    ref_a, a = _pair(dtype, 4)
    _same(unary.unary_operation(a, op), ref_unary.unary_operation(ref_a, op))


@pytest.mark.parametrize("fn", ["min", "max", "sum", "mean", "var", "skew", "argmin",
                                "argmax", "product"])
@pytest.mark.parametrize("dtype", UNSIGNED)
def test_unsigned_reductions_match_reference(dtype, fn):
    """Against the reference, except where it is wrong (ROADMAP.md §3):
    argmin / argmax with nulls raise OverflowError there, and a uint64 sum
    and mean wrap to int64; those are held to numpy (a uint64 sum modulo
    2^64, pandas' float mean)."""
    ref_a, a = _pair(dtype, 5)
    vals, mask = _unsigned(dtype, 5)
    got = getattr(reductions, fn)(a)
    if fn in ("argmin", "argmax"):
        exp = np.flatnonzero(mask)[getattr(np, fn)(vals[mask])]
    elif dtype == "uint64" and fn == "sum":
        exp = int(vals[mask].sum())
    elif dtype == "uint64" and fn == "mean":
        exp = float(vals[mask].astype(np.float64).mean())
    else:
        exp = getattr(ref_red, fn)(ref_a)
    if isinstance(exp, float):
        np.testing.assert_allclose(got, exp, rtol=1e-9)
    else:
        assert int(got) == int(exp), (got, exp)


def test_unsigned_filter_through_the_engine():
    """``filter(col("u") > col("w"))`` over two uint32 columns (it raised)."""
    rng = np.random.default_rng(6)
    u = rng.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    w = rng.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    df = ct.DataFrame({"u": u, "w": w}, device=CPU)
    got = from_dataframe(df).filter(col("u") > col("w")).collect().to_pandas()
    exp = pd.DataFrame({"u": u, "w": w})
    exp = exp[exp.u > exp.w].reset_index(drop=True)
    pd.testing.assert_frame_equal(got, exp)


@pytest.mark.parametrize("dtype", ["int32", "int64", "uint16", "uint32", "uint64"])
@pytest.mark.parametrize("decimals", [-1, -2])
def test_integer_round_to_negative_decimals_is_half_even(dtype, decimals):
    """pandas: [-14, -1, 25, 15, -5] at -1 is [-10, 0, 20, 20, 0]."""
    rng = np.random.default_rng(7)
    base = [-14, -1, 25, 15, -5, 150, 250, 349, 350, 450, 0]
    vals = np.array(base + list(rng.integers(-2000, 2000, 20)), dtype=np.int64)
    if dtype.startswith("uint"):
        vals = np.abs(vals)
    vals = vals.astype(dtype)
    got = unary.round(Column.from_numpy(vals, device=CPU), decimals)
    exp = pd.Series(vals).round(decimals).to_numpy()
    assert got.data.numpy().dtype == exp.dtype
    np.testing.assert_array_equal(got.data.numpy(), exp)
    if dtype == "int32" and decimals == -1:
        assert got.data.numpy()[:5].tolist() == [-10, 0, 20, 20, 0]


@pytest.mark.parametrize("how", ["inner", "left"])
def test_join_projection_keeps_a_suffixed_right_column(how):
    left = ct.DataFrame({"k": torch.tensor([1, 2, 3, 4]), "v": torch.tensor([1.0, 2, 3, 4])})
    right = ct.DataFrame({"k": torch.tensor([2, 4, 5]), "v": torch.tensor([20.0, 40, 50])})
    plan = from_dataframe(left).join(from_dataframe(right), on="k", how=how).select(
        col("v_right"))
    got = plan.collect().to_pandas()
    pd.testing.assert_frame_equal(got, plan.collect(no_optimization=True).to_pandas())
    np.testing.assert_array_equal(got["v_right"].to_numpy(), [20.0, 40.0] if how == "inner"
                                  else [np.nan, 20.0, np.nan, 40.0])


def _temporal_frame(kind):
    ticks = np.array([1, 2, 86_400 * 10**9 * 3 + 7, 5, 10**18, 10**18 + 2 * 10**9,
                      10**18 + 4 * 10**9, 4], dtype=np.int64)
    values = ticks.view("datetime64[ns]" if kind == "M" else "timedelta64[ns]")
    keys = np.array([1, 1, 2, 2, 3, 3, 3, 4])
    mask = np.array([True, True, True, False, True, True, True, True])
    pdf = pd.DataFrame({"k": keys, "t": pd.Series(values).where(mask)})
    return pdf, ct.DataFrame.from_pandas(pdf, device=CPU)


@pytest.mark.parametrize("kind", ["M", "m"])
@pytest.mark.parametrize("agg", ["mean", "median", "std", "min", "max"])
def test_temporal_group_aggregations_follow_pandas(kind, agg):
    pdf, df = _temporal_frame(kind)
    exp = pdf.groupby("k")["t"].agg(agg)
    got = df.groupby("k").agg({"t": agg}).to_pandas()["t"]
    assert got.dtype == exp.dtype, (got.dtype, exp.dtype)
    assert got.tolist() == exp.tolist() or (
        got.isna().tolist() == exp.isna().tolist()
        and got[got.notna()].tolist() == exp[exp.notna()].tolist())


@pytest.mark.parametrize("kind,agg", [("M", "sum"), ("M", "var"), ("m", "var")])
def test_temporal_group_sum_and_var_raise_as_pandas(kind, agg):
    pdf, df = _temporal_frame(kind)
    with pytest.raises(TypeError):
        pdf.groupby("k")["t"].agg(agg)
    with pytest.raises(TypeError):
        df.groupby("k").agg({"t": agg})


def test_duration_group_sum_is_a_duration():
    pdf, df = _temporal_frame("m")
    exp = pdf.groupby("k")["t"].sum()
    got = df.groupby("k").agg({"t": "sum"}).to_pandas()["t"]
    assert got.dtype == exp.dtype and got.tolist() == exp.tolist()


def test_sign_of_nan_is_nan():
    vals = np.array([np.nan, -2.5, 0.0, -0.0, 3.0, np.inf])
    got = unary.unary_operation(Column.from_numpy(vals, device=CPU), "sign").data.numpy()
    np.testing.assert_array_equal(got, np.sign(vals))


@pytest.mark.parametrize("op", ["abs", "cbrt"])
def test_abs_and_cbrt_of_bool_return_the_column(op):
    vals, mask = np.array([True, False, True, False]), np.array([True, True, False, True])
    ref = ref_unary.unary_operation(RefColumn.from_numpy(vals, mask=mask), op)
    got = unary.unary_operation(Column.from_numpy(vals, device=CPU).with_validity(
        torch.from_numpy(mask)), op)
    _same(got, ref)
