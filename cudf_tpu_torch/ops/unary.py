"""Unary ops: cast, null predicates, math, rounding (port of
``cudf_tpu/ops/unary.py``).  Each is one elementwise PyTorch pass."""

from __future__ import annotations

import torch

from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.ops._utils import materialize_validity
from cudf_tpu_torch.ops.binaryop import _rescale_ticks


def cast(col: Column, target) -> Column:
    """cudf::cast: numeric, bool and temporal columns into each other (a
    temporal unit change rescales the ticks, a downscale floors), a
    dictionary column through its decoded values, any column into a
    dictionary (``ops/dictionary.py`` ``encode``), and strings to and from
    numbers and timestamps (``ops/strings.py``: a string that is no number
    raises ValueError, as pandas' ``astype``)."""
    target = dt.dtype(target)
    if col.dtype == target:
        return col
    if target.is_dictionary:
        from cudf_tpu_torch.ops.dictionary import encode, set_keys

        if col.dtype.is_dictionary:
            vt = target.value_type
            if vt is None or vt == col.keys.dtype or (vt.is_string and col.keys.dtype.is_string):
                return col
            return set_keys(col, cast(col.keys, vt))
        if target.value_type is not None and not target.value_type.is_string:
            col = cast(col, target.value_type)
        return encode(col)
    if col.dtype.is_dictionary:
        return cast(col.decode_dictionary(), target)
    if target.is_decimal:
        from cudf_tpu_torch.ops.decimal import cast_to_decimal

        return cast_to_decimal(col, target)
    if col.dtype.is_decimal:
        from cudf_tpu_torch.ops.decimal import cast_from_decimal

        return cast_from_decimal(col, target)
    if col.dtype.is_nested or target.is_nested:
        raise TypeError(f"cannot cast {col.dtype!r} to {target!r}")
    if col.dtype.is_string or target.is_string:
        from cudf_tpu_torch.ops import strings

        if target.is_string:
            out = col if col.dtype.is_string else strings.from_column(col)
            return out if out.dtype == target else out._as(target)
        if target.is_numeric:
            return strings.to_numbers(col, target)
        if target.is_timestamp:
            return strings.to_timestamps(col, target=target)
        raise TypeError(f"cannot cast strings to {target!r}")
    if col.dtype.is_temporal and target.is_temporal:
        from cudf_tpu_torch.ops import datetime as dto

        if dto.is_day_unit(target):
            return dto.to_days(col, target)
        col = dto.days_as_seconds(col)
        if col.dtype == target:
            return col
        data = _rescale_ticks(col.data, col.dtype, target)
        return Column(target, col.length, data, col.validity)
    data = col.data.to(target.torch_storage)
    validity = col.validity
    if target.is_temporal and col.dtype.is_integer:
        # iNaT (INT64_MIN) ticks are NaT (pandas' M8 sentinel): one host sync
        nat = data == torch.iinfo(torch.int64).min
        if bool(nat.any()):
            validity = ~nat if validity is None else validity & ~nat
    return Column(target, col.length, data, validity)


def is_null(col: Column) -> Column:
    return Column(dt.BOOL8, col.length, ~materialize_validity(col))


def is_valid(col: Column) -> Column:
    return Column(dt.BOOL8, col.length, materialize_validity(col).clone())


def is_nan(col: Column) -> Column:
    if not col.dtype.is_float:
        return Column(dt.BOOL8, col.length,
                      torch.zeros(col.length, dtype=torch.bool, device=col.device))
    return Column(dt.BOOL8, col.length, torch.isnan(col.data), col.validity)


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


def _sign(x: torch.Tensor) -> torch.Tensor:
    """numpy's sign: NaN stays NaN (torch.sign gives 0)."""
    s = torch.sign(x)
    return torch.where(torch.isnan(x), x, s) if x.is_floating_point() else s


_UNSIGNED_WIDE = (torch.uint16, torch.uint32, torch.uint64)


def _as_i64(x: torch.Tensor) -> torch.Tensor:
    """uint16/uint32 values widened to int64, uint64 as its int64 bits."""
    return x.view(torch.int64) if x.dtype == torch.uint64 else x.long()


# uint16/32/64 have no PyTorch kernels for these: abs is the identity,
# sign 0 or 1, and negate and bit_invert go through int64 (the same low
# bits), then are wrapped back by the cast to the column's dtype
_UNSIGNED_FNS = {
    "abs": lambda x: x,
    "sign": lambda x: (x != 0).to(x.dtype),
    "negate": lambda x: -_as_i64(x),
    "bit_invert": lambda x: ~_as_i64(x),
}


_UNARY_FNS = {
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "arcsin": torch.asin, "arccos": torch.acos, "arctan": torch.atan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "arcsinh": torch.asinh, "arccosh": torch.acosh, "arctanh": torch.atanh,
    "exp": torch.exp, "log": torch.log, "log2": torch.log2, "log10": torch.log10,
    "log1p": torch.log1p, "expm1": torch.expm1,
    "sqrt": torch.sqrt, "cbrt": _cbrt,
    "ceil": torch.ceil, "floor": torch.floor, "rint": torch.round,
    "abs": torch.abs, "negate": torch.neg, "sign": _sign,
    "bit_invert": torch.bitwise_not, "not": torch.logical_not,
}
_FLOAT_ONLY = frozenset(_UNARY_FNS) - {"ceil", "floor", "rint", "abs", "negate", "sign",
                                       "bit_invert", "not"}


def unary_operation(col: Column, op: str) -> Column:
    """cudf::unary_operation: integer inputs of the float functions give
    float64, ``not`` gives bool, the rest keep the dtype."""
    fn = _UNARY_FNS[op]
    if col.dtype.is_bool and op in ("abs", "cbrt"):
        return col                       # as the reference (torch.abs has no bool kernel)
    if col.data.dtype in _UNSIGNED_WIDE and op in _UNSIGNED_FNS:
        fn = _UNSIGNED_FNS[op]
    if op in _FLOAT_ONLY and col.dtype.is_integer:
        data, out = fn(col.data.double()), dt.FLOAT64
    elif op == "not":
        data, out = fn(col.data.to(torch.bool)), dt.BOOL8
    elif op in ("ceil", "floor", "rint") and not col.dtype.is_float:
        data, out = col.data, col.dtype
    else:
        data, out = fn(col.data), col.dtype
    return Column(out, col.length, data.to(out.torch_storage), col.validity)


def round(col: Column, decimals: int = 0, how: str = "half_even") -> Column:  # noqa: A001
    """cudf::round: half_even (pandas') or half_up, to ``decimals``
    places (an integer column only to negative ones, in its dtype; the
    reference adds half a step away from zero before flooring, which
    takes negative values a step too far and halves away from zero)."""
    if col.dtype.is_decimal:
        from cudf_tpu_torch.ops.decimal import round_decimal

        return round_decimal(col, decimals)
    if col.dtype.is_integer and decimals >= 0:
        return col
    x = col.data
    if col.dtype.is_integer:
        return Column(col.dtype, col.length, _round_int(x, 10 ** (-decimals), how).to(x.dtype),
                      col.validity)
    scale = 10.0 ** decimals
    if how == "half_even":
        data = torch.round(x * scale) / scale
    else:
        data = torch.floor(torch.abs(x) * scale + 0.5) / scale * torch.sign(x)
    return Column(col.dtype, col.length, data.to(x.dtype), col.validity)


def _round_int(x: torch.Tensor, step: int, how: str) -> torch.Tensor:
    """Integers to a multiple of step, halves to the even multiple
    (half_even) or away from zero (half_up), in int64 (uint64 as its
    bits, divided unsigned)."""
    from cudf_tpu_torch.ops.binaryop import _udivmod

    v = _as_i64(x)
    if x.dtype == torch.uint64:
        q, r = _udivmod(v, torch.full_like(v, step))
    else:
        q = torch.div(v, step, rounding_mode="floor")
        r = v - q * step                 # 0 <= r < step
    twice = 2 * r
    if how == "half_even":
        up = (twice > step) | ((twice == step) & (q % 2 != 0))
    else:                                # half away from zero: q < 0 means v < 0
        up = (twice > step) | ((twice == step) & (q >= 0))
    return (q + up.long()) * step
