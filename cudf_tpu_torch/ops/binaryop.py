"""Binary operations with null propagation and type promotion (port of
``cudf_tpu/ops/binaryop.py``: arithmetic, comparisons and logical ops).

Result dtypes and null rules are the reference's (``_result_dtype``):
a row is null when either operand's row is null (except the ``null_*``
ops), a null scalar gives an all-null column, integer division by zero
gives float64 inf/NaN as pandas does.  A host scalar takes its numpy
dtype (a Python int is int64, a float float64), and the column side is
cast to the common dtype, then the scalar is broadcast by PyTorch
without a full column.

Temporal operands compare and combine in ticks of their common (finer)
unit: a ``np.datetime64('1994-01-01')`` literal has unit days, which the
reference turns into seconds, and both sides are rescaled before the
comparison.  A dictionary column compared with a string scalar is
compared once per dictionary entry on the host, then the booleans are
gathered by code: no row is decoded.
"""

from __future__ import annotations

import operator
from typing import Optional, Tuple

import numpy as np
import torch

from cudf_tpu_torch.core import bitmask as bm
from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import Column, is_null_scalar, to_ticks
from cudf_tpu_torch.ops import datetime as dto
from cudf_tpu_torch.utils import tracing

_COMPARISONS = {"eq", "ne", "lt", "gt", "le", "ge"}
_LOGICAL = {"and", "or"}


def _f64(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float64)


def _pair(fn):
    """A torch function of two tensors, taking a host scalar on either side."""
    def call(a, b):
        if not isinstance(a, torch.Tensor):
            a = tracing.synced("host_values", b.device, torch.as_tensor, a, dtype=b.dtype,
                               device=b.device)
        elif not isinstance(b, torch.Tensor):
            b = tracing.synced("host_values", a.device, torch.as_tensor, b, dtype=a.dtype,
                               device=a.device)
        return fn(a, b)
    return call


_ARITH_FNS = {
    "add": operator.add,
    "sub": operator.sub,
    "mul": operator.mul,
    "truediv": operator.truediv,
    "floordiv": _pair(torch.floor_divide),
    "mod": operator.mod,               # python/numpy sign-of-divisor (PYMOD)
    "cmod": _pair(torch.fmod),         # C-style sign-of-dividend (MOD)
    "pow": operator.pow,
    "atan2": _pair(torch.atan2),
    "logbase": lambda a, b: torch.log(_f64(a)) / torch.log(_f64(b)),
    "bitand": operator.and_,
    "bitor": operator.or_,
    "bitxor": operator.xor,
    "shiftleft": operator.lshift,
    "shiftright": operator.rshift,
    "min": _pair(torch.minimum),
    "max": _pair(torch.maximum),
}
_CMP_FNS = {
    "eq": operator.eq,
    "ne": operator.ne,
    "lt": operator.lt,
    "gt": operator.gt,
    "le": operator.le,
    "ge": operator.ge,
}
_FLIPPED = {"eq": "eq", "ne": "ne", "lt": "gt", "gt": "lt", "le": "ge", "ge": "le"}

# ----------------------------------------------------------------------
# uint16/32/64: PyTorch has no CPU (nor CUDA) kernel for most arithmetic
# and comparisons on them.  uint16 and uint32 values fit int64, where
# they are computed, then wrapped back by the cast to the result dtype.
# uint64 travels as its int64 bits: add, sub, mul, pow, the bitwise ops
# and the left shift give the same bits; the ops that depend on order or
# divide are done unsigned (``_U64_FNS``).
# ----------------------------------------------------------------------

_WIDE_UNSIGNED = (torch.uint16, torch.uint32, torch.uint64)
_I64_MIN = -(1 << 63)
_I64_MAX = (1 << 63) - 1


def _i64(x):
    """An unsigned operand (tensor or Python int) as int64: uint64 as its
    bits, the others widened."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int64) if x.dtype == torch.uint64 else x.long()
    x = int(x)
    return x - (1 << 64) if x >= 1 << 63 else x


def _ult(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a < b for uint64 values held as int64 bits."""
    return (a ^ _I64_MIN) < (b ^ _I64_MIN)


def _ushr(a: torch.Tensor, s) -> torch.Tensor:
    """Logical right shift of uint64 values held as int64 bits."""
    if not isinstance(s, torch.Tensor):
        return a if s == 0 else ((a >> 1) & _I64_MAX) >> (s - 1)
    return torch.where(s == 0, a, ((a >> 1) & _I64_MAX) >> (s - 1).clamp(min=0))


def _udivmod(a: torch.Tensor, b: torch.Tensor):
    """(a // b, a % b) of uint64 values held as int64 bits, b != 0: for a
    divisor below 2^63, half of a divided signed, doubled and corrected
    once; a larger divisor goes at most once."""
    big = b < 0
    bs = torch.where(big, 1, b)
    q = torch.div(_ushr(a, 1), bs, rounding_mode="floor") << 1
    r = a - q * bs
    fix = ~_ult(r, bs)
    q, r = q + fix.long(), r - torch.where(fix, bs, 0)
    qb = (~_ult(a, b)).long()
    return torch.where(big, qb, q), torch.where(big, a - qb * b, r)


_U64_FNS = {
    "floordiv": _pair(lambda a, b: _udivmod(a, b)[0]),
    "mod": _pair(lambda a, b: _udivmod(a, b)[1]),
    "cmod": _pair(lambda a, b: _udivmod(a, b)[1]),
    "shiftright": lambda a, b: _ushr(a, b) if isinstance(a, torch.Tensor) else _ushr(
        tracing.synced("host_values", b.device, torch.as_tensor, a, dtype=torch.int64,
                       device=b.device), b),
    "min": _pair(lambda a, b: torch.where(_ult(b, a), b, a)),
    "max": _pair(lambda a, b: torch.where(_ult(a, b), b, a)),
}


def _arith_fn(op: str, storage: torch.dtype):
    return _U64_FNS.get(op, _ARITH_FNS[op]) if storage == torch.uint64 else _ARITH_FNS[op]


def _ordered(x, storage: torch.dtype):
    """A comparison operand of an unsigned dtype as int64 of the same
    order (uint64 bits with the top bit flipped)."""
    x = _i64(x)
    return x ^ _I64_MIN if storage == torch.uint64 else x


def _as_f64(x, storage: torch.dtype):
    """An int64-held operand's value as float64 (uint64 bits unsigned)."""
    return x.view(torch.uint64).double() if storage == torch.uint64 else x.double()


def scalar_operand(x) -> Tuple[object, dt.DType]:
    """(value, dtype) of a host scalar: the value as a Python scalar (int
    ticks for a temporal one, None for a null), the dtype numpy's (a
    ``datetime64[D]`` becomes seconds, as in the reference)."""
    x = _numpy_temporal(x)
    if isinstance(x, (np.datetime64, np.timedelta64)):
        kind = "M" if isinstance(x, np.datetime64) else "m"
        unit = np.datetime_data(x.dtype)[0]
        d = dt.unit_dtype(kind, unit if unit in ("s", "ms", "us", "ns") else "s")
        return (None if np.isnat(x) else to_ticks(x, d)), d
    if isinstance(x, str):
        return x, dt.STRING
    if x is None or type(x).__name__ in ("NAType", "_NAType", "NaTType"):
        return None, dt.FLOAT64
    npv = np.asarray(x)
    return npv.item(), dt.dtype(npv.dtype)


def _numpy_temporal(x):
    """pandas' Timestamp / Timedelta (in their own unit) and the standard
    library's datetime / timedelta (microseconds) as numpy scalars; a
    tz-aware instant as its UTC wall clock; anything else as it is."""
    import datetime as _datetime

    if type(x).__name__ in ("NaTType",):
        return x
    if hasattr(x, "to_datetime64"):                # pandas' Timestamp
        if getattr(x, "tzinfo", None) is not None:
            x = x.tz_convert("UTC").tz_localize(None)
        return x.to_datetime64().astype(f"datetime64[{x.unit}]")
    if hasattr(x, "to_timedelta64"):               # pandas' Timedelta
        return x.to_timedelta64().astype(f"timedelta64[{x.unit}]")
    if isinstance(x, _datetime.datetime):
        if x.tzinfo is not None:
            x = x.astimezone(_datetime.timezone.utc).replace(tzinfo=None)
        return np.datetime64(x, "us")
    if isinstance(x, _datetime.timedelta):
        return np.timedelta64(x, "us")
    return x


def _operand(x):
    """(data, validity, dtype): a column's buffers, or a host scalar."""
    if isinstance(x, Column):
        return x.data, x.validity, x.dtype
    value, d = scalar_operand(x)
    return value, None, d


def binary_operation(lhs, rhs, op: str) -> Column:
    """Evaluate ``lhs <op> rhs`` elementwise (cudf::binary_operation); at
    least one side is a Column, the other may be a host scalar."""
    lhs_col, rhs_col = isinstance(lhs, Column), isinstance(rhs, Column)
    if not lhs_col and not rhs_col:
        raise TypeError("at least one operand must be a Column")
    col = lhs if lhs_col else rhs
    n, dev = col.length, col.device

    if op in ("truediv", "floordiv", "pow"):
        def _is_bool(x):
            return (x.dtype.is_bool if isinstance(x, Column)
                    else isinstance(x, (bool, np.bool_)))

        if _is_bool(lhs) and _is_bool(rhs):
            # pandas raises for bool // bool etc.
            raise NotImplementedError(f"operator '{op}' not implemented for bool dtypes")

    # a null scalar gives an all-null column, except a NaN scalar compared
    # with a float column, which is a real float comparison
    scalar = rhs if lhs_col else lhs
    if not (lhs_col and rhs_col) and is_null_scalar(scalar) and not (
            isinstance(scalar, float) and col.dtype.is_float and op in _COMPARISONS):
        out = dt.BOOL8 if op in _COMPARISONS or op in _LOGICAL else col.dtype
        if out.is_dictionary:
            out = dt.STRING
        return Column.full(n, None, out, device=dev)

    if any(isinstance(x, Column) and dto.is_day_unit(x.dtype) for x in (lhs, rhs)):
        # day-unit operands as seconds, as pandas holds them
        lhs, rhs = (dto.days_as_seconds(x) if isinstance(x, Column) else x for x in (lhs, rhs))

    if any(isinstance(x, Column) and x.dtype.is_decimal for x in (lhs, rhs)):
        from cudf_tpu_torch.ops.decimal import decimal_binary_operation

        return decimal_binary_operation(lhs, rhs, op)

    if isinstance(scalar, str) and col.dtype.is_timestamp and op in _COMPARISONS:
        # an ISO 8601 text against timestamps is a timestamp, as in pandas
        parsed = np.datetime64(scalar)
        lhs, rhs = (lhs, parsed) if lhs_col else (parsed, rhs)

    keyed = [isinstance(x, str) or (isinstance(x, Column)
                                    and (x.dtype.is_string or x.dtype.is_dictionary))
             for x in (lhs, rhs)]
    if any(isinstance(x, Column) and x.dtype.is_dictionary for x in (lhs, rhs)) \
            and not all(keyed):
        # a dictionary against a non-string operand: decode, then operate
        return binary_operation(lhs.decode_dictionary() if lhs_col else lhs,
                                rhs.decode_dictionary() if rhs_col else rhs, op)
    if any(keyed):
        return _string_binary(lhs, rhs, op, n)

    l_data, l_valid, l_dtype = _operand(lhs)
    r_data, r_valid, r_dtype = _operand(rhs)
    out_dtype = _result_dtype(l_dtype, r_dtype, op)

    if op in _COMPARISONS:
        if l_dtype.is_temporal or r_dtype.is_temporal:
            common = dt.common_dtype(l_dtype, r_dtype)
            l_data = _rescale_ticks(l_data, l_dtype, common)
            r_data = _rescale_ticks(r_data, r_dtype, common)
        else:
            common = dt.common_dtype(l_dtype, r_dtype)
            l_data, r_data = _to(l_data, common), _to(r_data, common)
            if common.torch_storage in _WIDE_UNSIGNED:
                st = common.torch_storage
                l_data, r_data = _ordered(l_data, st), _ordered(r_data, st)
        data = _compare(l_data, r_data, op)
        return Column(dt.BOOL8, n, data, bm.and_masks(l_valid, r_valid))

    if op in _LOGICAL:
        lb, rb = _to_bool(l_data), _to_bool(r_data)
        data = (lb & rb) if op == "and" else (lb | rb)
        if not isinstance(data, torch.Tensor):
            data = torch.full((n,), bool(data), dtype=torch.bool, device=dev)
        return Column(dt.BOOL8, n, data, bm.and_masks(l_valid, r_valid))

    if op == "null_equals":
        lv = _full_valid(l_valid, n, dev)
        rv = _full_valid(r_valid, n, dev)
        common = dt.common_dtype(l_dtype, r_dtype)
        eq = _compare(_to(l_data, common), _to(r_data, common), "eq")
        return Column(dt.BOOL8, n, torch.where(lv & rv, eq, lv == rv))

    if op in ("null_max", "null_min"):
        st = out_dtype.torch_storage
        fn = _arith_fn("max" if op == "null_max" else "min", st)
        lv = _full_valid(l_valid, n, dev)
        rv = _full_valid(r_valid, n, dev)
        lval = _dense(_to(l_data, out_dtype), n, dev, st)
        rval = _dense(_to(r_data, out_dtype), n, dev, st)
        if st in _WIDE_UNSIGNED:
            lval, rval = _i64(lval), _i64(rval)
        data = torch.where(lv & rv, fn(lval, rval), torch.where(lv, lval, rval))
        validity = lv | rv
        return Column(out_dtype, n, data.to(out_dtype.torch_storage),
                      None if tracing.to_bool(validity.all(), "null_check") else validity)

    if op == "pow" and out_dtype.is_integer:
        _refuse_negative_exponent(r_data, r_valid, r_dtype)
    if l_dtype.is_temporal or r_dtype.is_temporal:
        data, out_dtype = _temporal_arith(l_data, l_dtype, r_data, r_dtype, op, out_dtype)
    else:
        data, out_dtype = _arith(l_data, r_data, op, out_dtype, n, dev)
    data = _dense(data, n, dev, out_dtype.torch_storage).to(out_dtype.torch_storage)
    return Column(out_dtype, n, data, bm.and_masks(l_valid, r_valid))


def _refuse_negative_exponent(r_data, r_valid, r_dtype: dt.DType) -> None:
    """numpy and pandas raise for an integer power with a negative integer
    exponent (a column exponent costs one host sync)."""
    if not r_dtype.is_signed_integer:
        return
    if isinstance(r_data, torch.Tensor):
        neg = r_data < 0
        if r_valid is not None:
            neg &= r_valid
        negative = tracing.to_bool(neg.any(), "sign_check")
    else:
        negative = r_data < 0
    if negative:
        raise ValueError("Integers to negative integer powers are not allowed.")


def _to(x, d: dt.DType):
    """A column's data in dtype d's storage (a scalar as its Python value)."""
    if isinstance(x, torch.Tensor):
        return x.to(d.torch_storage)
    return float(x) if d.is_float else (bool(x) if d.is_bool else int(x))


def _to_bool(x):
    return x.to(torch.bool) if isinstance(x, torch.Tensor) else bool(x)


def _compare(a, b, op: str) -> torch.Tensor:
    if not isinstance(a, torch.Tensor):
        return _CMP_FNS[_FLIPPED[op]](b, a)
    return _CMP_FNS[op](a, b)


def _dense(x, n: int, device, dtype=None) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.full((n,), x, dtype=dtype,
                                                            device=device)


def _full_valid(v: Optional[torch.Tensor], n: int, device) -> torch.Tensor:
    return v if v is not None else torch.ones(n, dtype=torch.bool, device=device)


_BOOL_CLOSED = frozenset({"add", "mul", "min", "max", "bitand", "bitor", "bitxor"})


def _arith(l_data, r_data, op: str, out_dtype: dt.DType, n: int, device):
    if out_dtype.is_bool and op not in _BOOL_CLOSED:
        if op == "sub":
            raise TypeError("sub of two bool operands (numpy and the reference raise)")
        # e.g. bool % bool: in int64, a zero divisor giving 0, then bool
        l, r = (_dense(_to(x, dt.INT64), n, device, torch.int64) for x in (l_data, r_data))
        rz = r == 0
        data = _ARITH_FNS[op](l, torch.where(rz, torch.ones_like(r), r))
        return torch.where(rz, torch.zeros_like(data), data).to(torch.bool), out_dtype
    l, r = _to(l_data, out_dtype), _to(r_data, out_dtype)
    st = out_dtype.torch_storage
    fn = _arith_fn(op, st)
    if st in _WIDE_UNSIGNED:
        l, r = _i64(l), _i64(r)
        st = torch.int64
    if op in ("floordiv", "mod", "cmod") and out_dtype.is_integer and (
            isinstance(r, torch.Tensor) or r == 0):
        l, r = _dense(l, n, device, st), _dense(r, n, device, st)
        rz = r == 0
        if op != "cmod" and tracing.to_bool(rz.any(), "zero_divisor"):
            # pandas: int // 0 gives float +-inf (NaN for 0 // 0), x % 0 NaN,
            # and the result dtype becomes float64
            u = out_dtype.torch_storage
            lf, rf = _as_f64(l, u), torch.where(rz, 1.0, _as_f64(r, u))
            if op == "floordiv":
                inf = torch.where(lf > 0, float("inf"),
                                  torch.where(lf < 0, float("-inf"), float("nan")))
                return torch.where(rz, inf, torch.floor_divide(lf, rf)), dt.FLOAT64
            return torch.where(rz, float("nan"), torch.remainder(lf, rf)), dt.FLOAT64
        data = fn(l, torch.where(rz, torch.ones_like(r), r))
        return torch.where(rz, torch.zeros_like(data), data), out_dtype
    return fn(l, r), out_dtype


def _result_dtype(a: dt.DType, b: dt.DType, op: str) -> dt.DType:
    if op in _COMPARISONS or op in _LOGICAL or op == "null_equals":
        return dt.BOOL8
    if op == "truediv" and not (a.is_temporal or b.is_temporal):
        return dt.FLOAT64 if not (a.is_float or b.is_float) else dt.common_dtype(a, b)
    if op in ("atan2", "logbase"):
        return dt.FLOAT64
    if a.is_temporal or b.is_temporal:
        return _temporal_result_dtype(a, b, op)
    if a.is_bool and b.is_bool and op in ("add", "mul", "min", "max"):
        return dt.BOOL8
    return dt.common_dtype(a, b)


def _temporal_result_dtype(a: dt.DType, b: dt.DType, op: str) -> dt.DType:
    if op == "sub":
        if a.is_timestamp and b.is_timestamp:
            return dt.unit_dtype("m", dt.common_dtype(a, b).time_unit or "s")
        if a.is_timestamp:
            return dt.common_dtype(a, dt.unit_dtype("M", b.time_unit or "s"))
        if a.is_duration and b.is_duration:
            return dt.common_dtype(a, b)
    if op == "add":
        if a.is_timestamp and b.is_duration:
            return dt.common_dtype(a, dt.unit_dtype("M", b.time_unit or "s"))
        if a.is_duration and b.is_timestamp:
            return dt.common_dtype(dt.unit_dtype("M", a.time_unit or "s"), b)
        if a.is_duration and b.is_duration:
            return dt.common_dtype(a, b)
    if op in ("mul", "truediv", "floordiv", "mod"):
        if a.is_duration and b.is_numeric:
            return a
        if a.is_numeric and b.is_duration:
            return b
        if a.is_duration and b.is_duration:
            return dt.FLOAT64 if op == "truediv" else a
    if op in ("min", "max", "null_max", "null_min"):
        return dt.common_dtype(a, b)
    raise TypeError(f"unsupported temporal op {op} between {a} and {b}")


_TICKS = {"s": 1, "ms": 1_000, "us": 1_000_000, "ns": 1_000_000_000}


def _rescale_ticks(data, from_dtype: dt.DType, to_dtype: dt.DType):
    """Ticks of from_dtype's unit in to_dtype's (downscales floor, as
    pandas truncates toward negative infinity)."""
    if not from_dtype.is_temporal:
        return data
    fa, fb = _TICKS[from_dtype.time_unit or "s"], _TICKS[to_dtype.time_unit or "s"]
    if not isinstance(data, torch.Tensor):
        return data * (fb // fa) if fb >= fa else data // (fa // fb)
    data = data.to(torch.int64)
    if fa == fb:
        return data
    if fb > fa:
        return data * (fb // fa)
    return torch.div(data, fa // fb, rounding_mode="floor")


def _temporal_arith(l_data, l_dtype, r_data, r_dtype, op, out_dtype):
    if op == "truediv" and l_dtype.is_duration and r_dtype.is_duration:
        common = dt.common_dtype(l_dtype, r_dtype)
        lv = _to(_rescale_ticks(l_data, l_dtype, common), dt.FLOAT64)
        rv = _to(_rescale_ticks(r_data, r_dtype, common), dt.FLOAT64)
        return lv / rv, dt.FLOAT64
    if l_dtype.is_temporal and r_dtype.is_temporal:
        tgt = dt.unit_dtype("m", out_dtype.time_unit or "s")
        lv = _rescale_ticks(l_data, l_dtype, tgt)
        rv = _rescale_ticks(r_data, r_dtype, tgt)
        return _ARITH_FNS[op](lv, rv), out_dtype
    # duration * / numeric
    dur, num = (l_data, r_data) if l_dtype.is_temporal else (r_data, l_data)
    dur, num = _to(dur, dt.INT64), _to(num, dt.INT64)
    if op == "mul":
        return dur * num, out_dtype
    if op in ("truediv", "floordiv") and l_dtype.is_temporal:
        return _ARITH_FNS["floordiv"](dur, num), out_dtype
    raise TypeError(f"unsupported temporal op {op}")


# ----------------------------------------------------------------------
# strings and dictionaries
# ----------------------------------------------------------------------

def _string_binary(lhs, rhs, op: str, n: int) -> Column:
    if op == "add":                                 # concatenation (ops/strings.py)
        from cudf_tpu_torch.ops.strings import concat

        parts = [x.decode_dictionary() if isinstance(x, Column) else x for x in (lhs, rhs)]
        if not all(isinstance(x, str) or x.dtype.is_string for x in parts):
            raise TypeError("can only concatenate strings with strings")
        return concat(parts)
    if op not in _COMPARISONS and op != "null_equals":
        raise TypeError(f"string op {op!r}: strings take + and the comparisons only")
    for a, b, flip in ((lhs, rhs, False), (rhs, lhs, True)):
        if isinstance(a, Column) and a.dtype.is_dictionary and isinstance(b, str) \
                and op != "null_equals":
            return _dictionary_vs_scalar(a, b, _FLIPPED[op] if flip else op)
    from cudf_tpu_torch.ops.row_ops import string_compare

    dev = (lhs if isinstance(lhs, Column) else rhs).device
    l, r = (x.decode_dictionary() if isinstance(x, Column)
            else Column.from_strings([str(x)], device=dev) for x in (lhs, rhs))
    if not (l.dtype.is_string and r.dtype.is_string):
        raise TypeError(f"cannot compare {l.dtype!r} with {r.dtype!r}")
    cmp = string_compare(l, r)                      # int8 in {-1, 0, 1}
    data = _CMP_FNS["eq" if op == "null_equals" else op](cmp, 0)
    if op == "null_equals":
        lv = _full_valid(l.validity, n, dev)
        rv = _full_valid(r.validity, n, dev) if r.length == n else torch.ones_like(lv)
        return Column(dt.BOOL8, n, torch.where(lv & rv, data, lv == rv))
    validity = bm.and_masks(l.validity, r.validity if r.length == n else None)
    return Column(dt.BOOL8, n, data, validity)


def _dictionary_vs_scalar(col: Column, value: str, op: str) -> Column:
    """``codes <op> value``: the comparison once per dictionary entry on
    the host, then the booleans gathered by code."""
    keys = col.keys
    if not keys.dtype.is_string:
        raise TypeError(f"cannot compare a {keys.dtype!r} dictionary with a string")
    per_key = [_CMP_FNS[op](k.encode("utf-8"), value.encode("utf-8"))
               for k in keys.host_strings()]
    if not per_key:
        data = torch.zeros(col.length, dtype=torch.bool, device=col.device)
    else:
        table = torch.tensor(per_key, dtype=torch.bool)
        table = tracing.synced("host_values", col.device, table.to, col.device)
        codes = col.data
        safe = codes if col.validity is None else torch.where(col.validity, codes, 0)
        data = table[safe.long()]
    return Column(dt.BOOL8, col.length, data, col.validity)

