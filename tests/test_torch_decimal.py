"""Fixed-point decimals of the port (``ops/decimal.py``, ``ops/decimal128.py``,
their routes through ``ops/binaryop.py`` and ``ops/unary.py``, the decimal
branches of ``core/column.py``) against the reference's (``cudf_tpu``, JAX
on the CPU), after the reference's own ``tests/test_decimal.py``: casts,
libcudf's scale rules, null for a zero divisor, half-even rounding, the
Arrow round trip and the two-limb int128 arithmetic (held to Python ints
as well).  Seeded inputs of a few hundred rows; everything is exact.
"""

import decimal as D

import numpy as np
import pyarrow as pa
import pytest
import torch

import torch_jax_cache  # noqa: F401  (the run's shared JAX compile cache)
from cudf_tpu.core import dtypes as ref_dt
from cudf_tpu.core.column import Column as RefColumn
from cudf_tpu.ops import binaryop as ref_bin
from cudf_tpu.ops import decimal as ref_dec
from cudf_tpu.ops import decimal128 as ref_d128
from cudf_tpu.ops import unary as ref_unary
import cudf_tpu_torch as ct
from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.ops import binaryop, copying, unary
from cudf_tpu_torch.ops import decimal as dec
from cudf_tpu_torch.ops import decimal128 as d128
from cudf_tpu_torch.ops.row_ops import lex_sort_indices

torch.set_num_threads(1)

CPU = "cpu"
N = 256
CTX = D.Context(prec=60)


def _values(seed, scale, null=0.1, big=10 ** 9):
    """Seeded Decimals at ``scale`` (None about ``null`` of the time)."""
    rng = np.random.default_rng(seed)
    reps = rng.integers(-big, big, N)
    reps[:4] = [0, 1, -1, 5 * 10 ** (-scale - 1) if scale < 0 else 5]
    out = [D.Decimal(int(r)).scaleb(scale) for r in reps]
    return [None if rng.random() < null else v for v in out]


def _pair(vals, scale=None, bits=64):
    return (ref_dec.from_decimals(vals, scale=scale, bits=bits),
            dec.from_decimals(vals, scale=scale, bits=bits, device=CPU))


def _same(got: Column, exp: RefColumn):
    assert got.dtype.scale == exp.dtype.scale and got.dtype.id.name == exp.dtype.id.name
    assert got.to_pylist() == exp.to_pylist()


def test_from_to_decimals_and_inference():
    vals = _values(0, -2)
    r, p = _pair(vals)
    _same(p, r)
    assert p.to_pylist() == vals
    inferred = Column.from_pylist([D.Decimal("1.25"), D.Decimal("-0.500"), None], device=CPU)
    assert inferred.dtype == dt.decimal_dtype(-3)
    assert inferred.to_pylist() == RefColumn.from_sequence(
        [D.Decimal("1.25"), D.Decimal("-0.500"), None]).to_pylist()


@pytest.mark.parametrize("new_scale", [-4, -3, -1, 0, 2])
def test_rescale_truncates_toward_zero(new_scale):
    r, p = _pair(_values(1, -2))
    _same(dec.rescale(p, new_scale), ref_dec.rescale(r, new_scale))


OPS = ["add", "sub", "mul", "truediv", "floordiv", "mod", "min", "max",
       "eq", "ne", "lt", "le", "gt", "ge"]


@pytest.mark.parametrize("op", OPS)
def test_binary_scale_rules(op):
    """mul adds the scales, div subtracts them and truncates, a zero
    divisor is null; the rest meet at the finer scale."""
    a_r, a_p = _pair(_values(2, -2))
    b_r, b_p = _pair(_values(3, -3, big=10 ** 5))
    got, exp = binaryop.binary_operation(a_p, b_p, op), ref_bin.binary_operation(a_r, b_r, op)
    if got.dtype.is_decimal:
        _same(got, exp)
    else:
        assert got.to_pylist() == exp.to_pylist()


@pytest.mark.parametrize("scalar", [D.Decimal("0.75"), 2, -3, D.Decimal("-1.125")])
@pytest.mark.parametrize("op", ["add", "sub", "mul", "truediv", "lt", "eq"])
def test_scalar_operands(scalar, op):
    r, p = _pair(_values(4, -2))
    got, exp = binaryop.binary_operation(p, scalar, op), ref_bin.binary_operation(r, scalar, op)
    assert got.to_pylist() == exp.to_pylist()
    got, exp = binaryop.binary_operation(scalar, p, op), ref_bin.binary_operation(scalar, r, op)
    assert got.to_pylist() == exp.to_pylist()


def test_integer_column_operand_and_zero_divisor():
    r, p = _pair(_values(5, -1))
    ints = np.random.default_rng(5).integers(-3, 4, N)
    ri, pi = RefColumn.from_numpy(ints), Column.from_numpy(ints, device=CPU)
    for op in ("add", "mul", "truediv", "mod"):
        _same(binaryop.binary_operation(p, pi, op), ref_bin.binary_operation(r, ri, op))
    q = binaryop.binary_operation(p, pi, "truediv")
    assert all(v is None for v, i in zip(q.to_pylist(), ints) if i == 0)


def test_mul_overflow_wraps_as_in_the_reference():
    """The reference and libcudf do not check a product for int64
    overflow: it wraps, here as there."""
    big = [D.Decimal(4 * 10 ** 9), D.Decimal(-5 * 10 ** 9)]
    r, p = _pair(big, scale=0)
    got = binaryop.binary_operation(p, p, "mul")
    _same(got, ref_bin.binary_operation(r, r, "mul"))
    assert got.to_pylist()[0] != big[0] * big[0]


@pytest.mark.parametrize("target", ["float64", "float32", "int64", "int32", "str",
                                    "decimal32", "decimal128"])
def test_casts_from_decimal(target):
    r, p = _pair(_values(6, -3))
    if target.startswith("decimal"):
        bits = int(target[7:])
        got = unary.cast(p, dt.decimal_dtype(-1, bits))
        exp = ref_unary.cast(r, ref_dt.decimal_dtype(-1, bits))
        _same(got, exp)
        return
    got, exp = unary.cast(p, dt.dtype(target)), ref_unary.cast(r, ref_dt.dtype(target))
    g, e = got.to_pylist(), exp.to_pylist()
    if target.startswith("float"):
        g = [None if v != v else v for v in g]
    assert g == e


@pytest.mark.parametrize("source", ["float64", "int32", "bool", "str"])
def test_casts_to_decimal(source):
    rng = np.random.default_rng(7)
    if source == "float64":
        host = np.round(rng.normal(0, 100, N), 3)
        host[:4] = [0.125, 0.135, -2.5, 2.675]          # half-even on the scaled value
    elif source == "int32":
        host = rng.integers(-1000, 1000, N).astype(np.int32)
    elif source == "bool":
        host = rng.random(N) < 0.5
    else:
        host = np.array(["%.3f" % v for v in rng.normal(0, 50, N)], dtype=object)
    target = (dt.decimal_dtype(-2), ref_dt.decimal_dtype(-2))
    if source == "str":
        got = unary.cast(Column.from_strings(list(host), device=CPU), target[0])
        exp = ref_unary.cast(RefColumn.from_strings(list(host)), target[1])
    else:
        got = unary.cast(Column.from_numpy(host, device=CPU), target[0])
        exp = ref_unary.cast(RefColumn.from_numpy(host), target[1])
    _same(got, exp)


@pytest.mark.parametrize("decimals", [0, 1, 2, 4])
def test_round_half_even(decimals):
    vals = _values(8, -3) + [D.Decimal("1.250"), D.Decimal("1.350"), D.Decimal("-1.250"),
                             D.Decimal("0.005"), D.Decimal("-0.015")]
    r, p = ref_dec.from_decimals(vals), dec.from_decimals(vals, device=CPU)
    _same(dec.round_decimal(p, decimals), ref_dec.round_decimal(r, decimals))
    _same(ct.Series._from(p, ct.frame.index.default_index(p.length)).round(decimals)._column,
          ref_dec.round_decimal(r, decimals))


def test_arrow_round_trip():
    vals = _values(9, -2)
    arr = pa.array(vals, pa.decimal128(15, 2))
    got = Column.from_arrow(arr, device=CPU)
    exp = RefColumn.from_arrow(arr)
    _same(got, exp)
    assert got.to_arrow().to_pylist() == arr.to_pylist()
    wide = pa.array([D.Decimal("123456789012345678901234.56"), None, D.Decimal("-0.01")],
                    pa.decimal128(38, 2))
    col = Column.from_arrow(wide, device=CPU)
    assert col.children and col.to_pylist() == wide.to_pylist()
    assert col.to_arrow().to_pylist() == wide.to_pylist()
    s = ct.Series(vals, device=CPU)
    assert s.to_arrow().to_pylist() == vals
    assert s.to_pandas().tolist() == vals


def test_series_level_ops_and_astype():
    vals = _values(10, -2)
    s = ct.Series(vals, device=CPU)
    assert s.dtype == dt.decimal_dtype(-2)
    assert (s + s).to_pandas().tolist() == [None if v is None else v + v for v in vals]
    assert s.astype("decimal64(scale=-4)").dtype == dt.decimal_dtype(-4)
    assert s.astype("float64").to_pandas().tolist()[:3] == [float(v) for v in vals[:3]]


def test_copying_and_order_of_decimals():
    r, p = _pair(_values(11, -2))
    idx = np.random.default_rng(11).integers(-2, N + 2, 100)
    from cudf_tpu.ops import copying as ref_copying

    _same(copying.gather(p, torch.from_numpy(idx)), ref_copying.gather(r, idx))
    _same(copying.slice(p, 3, 90), ref_copying.slice(r, 3, 90))
    order = lex_sort_indices([p]).tolist()
    keys = [(v is None, v) for v in p.to_pylist()]
    assert [keys[i] for i in order] == sorted(keys, key=lambda k: (k[0], k[1] or 0))


# ----------------------------------------------------------------------
# two-limb DECIMAL128
# ----------------------------------------------------------------------

WIDE = ["12345678901234567890123456.78", "-9999999999999999999999.99", "0.01", "-0.01", None,
        "170141183460469231731687303715.88", "-170141183460469231731687303715.88", "0"]
OTHER = ["1.5", "2.25", "-3.125", "100", None, "0.12", "-7.001", "18446744073709551616.5"]


def _wide(vals, scale):
    return (ref_d128.from_decimals128(vals, scale=scale),
            d128.from_decimals128(vals, scale=scale, device=CPU))


@pytest.mark.parametrize("op", ["add", "sub", "mul", "eq", "ne", "lt", "le", "gt", "ge"])
def test_binary128_matches_reference_and_python(op):
    a_r, a_p = _wide(WIDE, -2)
    b_r, b_p = _wide(OTHER, -3)
    got, exp = d128.binary128(a_p, b_p, op), ref_d128.binary128(a_r, b_r, op)
    if op in ("add", "sub", "mul"):
        assert d128.to_decimals128(got) == ref_d128.to_decimals128(exp)
        fn = {"add": CTX.add, "sub": CTX.subtract, "mul": CTX.multiply}[op]
        for g, x, y in zip(d128.to_decimals128(got), WIDE, OTHER):
            if x is None or y is None:
                assert g is None
            elif op != "mul" or abs(fn(D.Decimal(x), D.Decimal(y)).scaleb(5)) < 2 ** 127:
                assert g == fn(D.Decimal(x), D.Decimal(y))
    else:
        valid = np.asarray(exp.validity).tolist()
        g, e = got.data.tolist(), np.asarray(exp.data).tolist()
        assert [a for a, ok in zip(g, valid) if ok] == [b for b, ok in zip(e, valid) if ok]


@pytest.mark.parametrize("new_scale", [-6, -2, 0, 3, 12])
def test_rescale128(new_scale):
    r, p = _wide(WIDE, -2)
    assert d128.to_decimals128(d128.rescale128(p, new_scale)) == \
        ref_d128.to_decimals128(ref_d128.rescale128(r, new_scale))


def test_limb_primitives_against_python_ints():
    rng = np.random.default_rng(12)
    a = [int(v) for v in rng.integers(-2 ** 62, 2 ** 62, N)]
    b = [int(v) for v in rng.integers(-2 ** 62, 2 ** 62, N)]
    a[:3], b[:3] = [2 ** 63 - 1, -2 ** 63, 2 ** 40], [2 ** 63 - 1, -2 ** 63, -1]
    pa_, pb = (d128.from_ints128(x, 0, device=CPU) for x in (a, b))
    prod = d128.binary128(pa_, pb, "mul")
    assert d128.to_ints128(prod) == [x * y for x, y in zip(a, b)]
    s = d128.binary128(prod, pa_, "sub")
    assert d128.to_ints128(s) == [x * y - x for x, y in zip(a, b)]
    h, l = d128.limbs(prod)
    qh, ql = d128.i128_div_small(h, l, 1_000_003)
    got = d128.to_ints128(d128.make_decimal128(qh, ql, 0))
    assert got == [(abs(x * y) // 1_000_003) * (1 if x * y >= 0 else -1) for x, y in zip(a, b)]
    assert d128.i128_cmp(h, l, *d128.limbs(pa_)).tolist() == \
        [(x * y > x) - (x * y < x) for x, y in zip(a, b)]
    mh, ml = d128.i128_mul_small(h, l, 7)
    wrap = [(7 * x * y + 2 ** 127) % 2 ** 128 - 2 ** 127 for x, y in zip(a, b)]   # 128 bits
    assert d128.to_ints128(d128.make_decimal128(mh, ml, 0)) == wrap


def test_two_limb_through_binaryop_copying_and_order():
    _, p = _wide(WIDE, -2)
    q = binaryop.binary_operation(p, p, "add")
    assert q.to_pylist() == [None if v is None else CTX.add(D.Decimal(v), D.Decimal(v))
                             for v in WIDE]
    g = copying.gather(p, torch.tensor([5, 0, 4, 9]))
    assert g.to_pylist() == [D.Decimal(WIDE[5]), D.Decimal(WIDE[0]), None, None]
    both = copying.concatenate([p, dec.from_decimals([D.Decimal("1.5")], bits=128, device=CPU)])
    assert both.to_pylist() == [
        None if v is None else D.Decimal(v).quantize(D.Decimal("0.01"), context=CTX)
        for v in WIDE] + [D.Decimal("1.50")]
    order = lex_sort_indices([p]).tolist()
    vals = p.to_pylist()
    kept = [vals[i] for i in order if vals[i] is not None]
    assert kept == sorted(kept)
