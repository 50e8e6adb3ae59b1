"""Fixed-point decimals on their unscaled integers (port of
``cudf_tpu/ops/decimal.py``; libcudf's fixed_point,
cpp/include/cudf/fixed_point/fixed_point.hpp:37, and the scale rules of
cpp/src/binaryop/compiled/fixed_point.cu).

A decimal column holds int32 (DECIMAL32) or int64 (DECIMAL64, and
DECIMAL128 of at most 18 digits) unscaled values ``rep``, the value being
``rep * 10 ** scale``; scale -2 holds cents.  A DECIMAL128 column of two
limbs goes through ``ops/decimal128.py``.  libcudf's scale rules, kept as
the reference keeps them (not Python ``Decimal``'s):

- add, sub, min, max, mod: the finer scale, ``min(ls, rs)``, both sides
  rescaled to it;
- mul: ``ls + rs`` (the product is not checked for int64 overflow, as in
  the reference and libcudf);
- div: ``ls - rs``, truncated toward zero; a zero divisor gives null;
- comparisons: at the finer scale.

Every op runs on the column's device.  Rescaling up truncates toward
zero (``torch.div(rounding_mode="trunc")``); the cast from float rounds
half to even (``torch.round``).  The casts from and to text, and
``from_decimals`` / ``to_decimals``, take Python ``Decimal``s on the
host, as the reference does, counted in ``HOST_ROUTES``.
"""

from __future__ import annotations

import decimal as _pydec
from typing import Optional, Tuple

import numpy as np
import torch

from cudf_tpu_torch.core import bitmask as bm
from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import Column, is_null_scalar
from cudf_tpu_torch.ops._utils import count_host_route

__all__ = [
    "rescale", "decimal_binary_operation", "from_decimals", "to_decimals",
    "cast_to_decimal", "cast_from_decimal", "round_decimal",
]

_BITS = {dt.TypeId.DECIMAL32: 32, dt.TypeId.DECIMAL64: 64, dt.TypeId.DECIMAL128: 128}
_COMPARE = {"eq": torch.eq, "ne": torch.ne, "lt": torch.lt, "gt": torch.gt, "le": torch.le,
            "ge": torch.ge}


def _pow10(k: int) -> int:
    return 10 ** int(k)


def bits_of(dtype: dt.DType) -> int:
    return _BITS.get(dtype.id, 64)


def two_limbs(col: Column) -> bool:
    """A DECIMAL128 column of two limbs (``ops/decimal128.py``)."""
    return col.dtype.is_decimal and bool(col.children)


def rescale(col: Column, new_scale: int) -> Column:
    """The same values at another scale: a finer scale multiplies the
    unscaled values, a coarser one divides them, truncating toward zero
    (fixed_point.hpp ``rescaled``)."""
    if not col.dtype.is_decimal:
        raise TypeError("rescale expects a decimal column")
    new_scale = int(new_scale)
    old = col.dtype.scale
    if new_scale == old:
        return col
    if two_limbs(col):
        from cudf_tpu_torch.ops.decimal128 import rescale128

        return rescale128(col, new_scale)
    rep = col.data.long()
    if new_scale < old:
        rep = rep * _pow10(old - new_scale)
    else:
        rep = torch.div(rep, _pow10(new_scale - old), rounding_mode="trunc")
    out = dt.decimal_dtype(new_scale, bits_of(col.dtype))
    return Column(out, col.length, rep.to(out.torch_storage), col.validity)


def scalar_to_fixed(x) -> Tuple[int, int]:
    """A host number as (unscaled int, scale)."""
    if isinstance(x, _pydec.Decimal):
        sign, digits, exp = x.as_tuple()
        rep = int("".join(map(str, digits)) or "0")
        return (-rep if sign else rep), int(exp)
    if isinstance(x, (bool, np.bool_)):
        return int(x), 0
    if isinstance(x, (int, np.integer)):
        return int(x), 0
    if isinstance(x, (float, np.floating)):
        return scalar_to_fixed(_pydec.Decimal(str(x)))
    raise TypeError(f"cannot interpret {type(x).__name__} as a decimal")


def _operand(x, n: int, device):
    """(int64 unscaled values or a Python int, scale, validity, dtype or None)."""
    if isinstance(x, Column):
        if x.dtype.is_decimal:
            return x.data.long(), x.dtype.scale, x.validity, x.dtype
        if x.dtype.is_integer or x.dtype.is_bool:
            return x.data.long(), 0, x.validity, x.dtype
        raise TypeError(f"cannot mix a decimal with {x.dtype!r}")
    if is_null_scalar(x):
        return 0, 0, torch.zeros(n, dtype=torch.bool, device=device), None
    rep, scale = scalar_to_fixed(x)
    return rep, scale, None, None


def _nonzero_validity(validity, zero: torch.Tensor):
    """``validity`` with the rows of a zero divisor null (one host sync)."""
    return bm.and_masks(validity, ~zero) if bool(zero.any()) else validity


def decimal_binary_operation(lhs, rhs, op: str) -> Column:
    """``lhs <op> rhs`` where at least one side is a decimal column, the
    other a decimal or integer column or a host number."""
    col = lhs if isinstance(lhs, Column) else rhs
    n, dev = col.length, col.device
    if any(isinstance(x, Column) and two_limbs(x) for x in (lhs, rhs)):
        from cudf_tpu_torch.ops.decimal128 import binary128

        return binary128(_as128(lhs, n, dev), _as128(rhs, n, dev), op)
    ld, ls, lv, ldt = _operand(lhs, n, dev)
    rd, rs, rv, rdt = _operand(rhs, n, dev)
    validity = bm.and_masks(lv, rv)
    bits = max(bits_of(ldt) if ldt is not None else 64, bits_of(rdt) if rdt is not None else 64)
    if op in _COMPARE:
        common = min(ls, rs)
        la, ra = ld * _pow10(ls - common), rd * _pow10(rs - common)
        if not isinstance(la, torch.Tensor):
            la = torch.full((n,), la, dtype=torch.int64, device=dev)
        return Column(dt.BOOL8, n, _COMPARE[op](la, ra), validity)
    if op in ("add", "sub", "min", "max", "mod"):
        out_scale = min(ls, rs)
        la = _dense(ld * _pow10(ls - out_scale), n, dev)
        ra = _dense(rd * _pow10(rs - out_scale), n, dev)
        if op == "mod":
            zero = ra == 0
            data = torch.where(zero, 0, torch.remainder(la, torch.where(zero, 1, ra)))
            validity = _nonzero_validity(validity, zero)
        else:
            data = {"add": torch.add, "sub": torch.sub, "min": torch.minimum,
                    "max": torch.maximum}[op](la, ra)
    elif op == "mul":
        out_scale = ls + rs
        data = _dense(ld, n, dev) * rd
    elif op in ("truediv", "div", "floordiv"):
        out_scale = ls - rs
        rd = _dense(rd, n, dev)
        zero = rd == 0
        data = torch.where(zero, 0, torch.div(_dense(ld, n, dev), torch.where(zero, 1, rd),
                                              rounding_mode="trunc"))
        validity = _nonzero_validity(validity, zero)
        if op == "floordiv" and out_scale < 0:
            # the quotient is integral in value: rescaled to 0
            data = torch.div(data, _pow10(-out_scale), rounding_mode="trunc")
            out_scale = 0
    else:
        raise TypeError(f"binary op {op!r} is not supported for decimals")
    out = dt.decimal_dtype(out_scale, bits)
    return Column(out, n, data.to(out.torch_storage), validity)


def _dense(x, n: int, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.full((n,), x, dtype=torch.int64, device=device)


def _as128(x, n: int, device) -> Column:
    """An operand of a two-limb operation as a DECIMAL128 column."""
    from cudf_tpu_torch.ops.decimal128 import from_ints128

    if isinstance(x, Column) and x.dtype.is_decimal:
        return x
    rep, scale, validity, _ = _operand(x, n, device)
    if isinstance(rep, torch.Tensor):
        return Column(dt.decimal_dtype(scale, 128), n, rep, validity)
    return from_ints128([rep] * n, scale, device=device)


def from_decimals(values, scale: Optional[int] = None, bits: int = 64, *, device) -> Column:
    """A decimal column of host Decimals, ints or floats (None: null), at
    ``scale`` (default: the finest of the values), rounded half to even
    where a value has more digits; built on the host."""
    count_host_route("from_decimals")
    values = list(values)
    valid = [not is_null_scalar(v) for v in values]
    fixed = [scalar_to_fixed(v) if ok else (0, 0) for v, ok in zip(values, valid)]
    if scale is None:
        scale = min((s for (_, s), ok in zip(fixed, valid) if ok), default=0)
    reps = [r * _pow10(s - scale) if s >= scale else
            int(_pydec.Decimal(r).scaleb(s - scale).to_integral_value(
                rounding=_pydec.ROUND_HALF_EVEN)) for r, s in fixed]
    if bits == 128 and any(abs(r) >= 1 << 63 for r in reps):
        from cudf_tpu_torch.ops.decimal128 import from_ints128

        return from_ints128([r if ok else None for r, ok in zip(reps, valid)], scale,
                            device=device)
    out = dt.decimal_dtype(scale, bits)
    return Column(out, len(reps), torch.tensor(np.asarray(reps, dtype=out.storage),
                                               device=device),
                  bm.from_numpy_mask(np.array(valid, bool), device))


def to_decimals(col: Column) -> list:
    """Host export: Python Decimals, None for nulls."""
    if two_limbs(col):
        from cudf_tpu_torch.ops.decimal128 import to_decimals128

        return to_decimals128(col)
    count_host_route("to_decimals")
    reps = col.data.cpu().tolist()
    valid = [True] * col.length if col.validity is None else col.validity.cpu().tolist()
    s = col.dtype.scale
    return [_pydec.Decimal(r).scaleb(s) if ok else None for r, ok in zip(reps, valid)]


def cast_to_decimal(col: Column, target: dt.DType) -> Column:
    """An integer, bool, float, decimal or text column as ``target``."""
    if col.dtype.is_decimal:
        out = rescale(col, target.scale)
        if two_limbs(out) and target.id == dt.TypeId.DECIMAL128:
            return Column(target, out.length, out.data, out.validity, children=out.children)
        return Column(target, out.length, out.data.to(target.torch_storage), out.validity)
    if col.dtype.is_integer or col.dtype.is_bool:
        return cast_to_decimal(Column(dt.decimal_dtype(0, 64), col.length, col.data.long(),
                                      col.validity), target)
    if col.dtype.is_float:
        rep = torch.round(col.data.double() * float(_pow10(-target.scale)))
        return Column(target, col.length, rep.to(target.torch_storage), col.validity)
    if col.dtype.is_string:
        count_host_route("decimal_text")
        vals = [None if s is None else _pydec.Decimal(s) for s in col.host_strings()]
        return rescale(from_decimals(vals, bits=bits_of(target), device=col.device),
                       target.scale)
    raise TypeError(f"cannot cast {col.dtype!r} to a decimal")


def cast_from_decimal(col: Column, target: dt.DType) -> Column:
    """A decimal column as float, integer, bool or text."""
    s = col.dtype.scale
    if target.is_float:
        if two_limbs(col):
            from cudf_tpu_torch.ops.decimal128 import limbs

            hi, lo = limbs(col)
            f = hi.double() * 2.0 ** 64 + _unsigned_double(lo)
        else:
            f = col.data.double()
        # a divide for negative scales: 1999 / 100.0 rounds right where
        # 1999 * 0.01 compounds the inexact 0.01; the divisor is a tensor,
        # as CUDA divides by a host scalar through its reciprocal
        p = torch.tensor(float(_pow10(abs(s))), dtype=torch.float64, device=f.device)
        data = f / p if s < 0 else f * p
        return Column(target, col.length, data.to(target.torch_storage), col.validity)
    if target.is_integer or target.is_bool:
        as_int = rescale(col, 0)
        return Column(target, col.length, as_int.data.to(target.torch_storage), col.validity)
    if target.is_string:
        count_host_route("decimal_text")
        return Column.from_strings([None if d is None else str(d) for d in to_decimals(col)],
                                   device=col.device)
    raise TypeError(f"cannot cast a decimal to {target!r}")


def _unsigned_double(lo: torch.Tensor) -> torch.Tensor:
    """int64 bits read as uint64, as float64 (PyTorch converts no uint64 on CUDA)."""
    return torch.where(lo < 0, lo.double() + 2.0 ** 64, lo.double())


def round_decimal(col: Column, decimals: int = 0) -> Column:
    """Half to even at ``decimals`` fractional digits (scale -decimals)."""
    target_scale = -int(decimals)
    old = col.dtype.scale
    if target_scale <= old:
        return rescale(col, target_scale)
    f = _pow10(target_scale - old)
    rep = col.data.long()
    mag = rep.abs()
    q, r = torch.div(mag, f, rounding_mode="floor"), torch.remainder(mag, f)
    half = f // 2
    up = (r > half) | ((r == half) & (q % 2 == 1))
    rep = torch.sign(rep) * torch.where(up, q + 1, q)
    out = dt.decimal_dtype(target_scale, bits_of(col.dtype))
    return Column(out, col.length, rep.to(out.torch_storage), col.validity)
