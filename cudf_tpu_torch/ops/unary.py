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
    dictionary column through its decoded values."""
    target = dt.dtype(target)
    if col.dtype == target:
        return col
    if col.dtype.is_dictionary:
        return cast(col.decode_dictionary(), target)
    if target.is_dictionary:
        raise NotImplementedError("cast to a dictionary: ops/dictionary.py encode is "
                                  "ROADMAP.md queue 1, item 2")
    if col.dtype.is_string or target.is_string:
        raise NotImplementedError(f"cast between {col.dtype!r} and {target!r}: "
                                  "ops/strings.py is ROADMAP.md queue 1, item 6")
    if col.dtype.is_temporal and target.is_temporal:
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


_UNARY_FNS = {
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "arcsin": torch.asin, "arccos": torch.acos, "arctan": torch.atan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "arcsinh": torch.asinh, "arccosh": torch.acosh, "arctanh": torch.atanh,
    "exp": torch.exp, "log": torch.log, "log2": torch.log2, "log10": torch.log10,
    "log1p": torch.log1p, "expm1": torch.expm1,
    "sqrt": torch.sqrt, "cbrt": _cbrt,
    "ceil": torch.ceil, "floor": torch.floor, "rint": torch.round,
    "abs": torch.abs, "negate": torch.neg, "sign": torch.sign,
    "bit_invert": torch.bitwise_not, "not": torch.logical_not,
}
_FLOAT_ONLY = frozenset(_UNARY_FNS) - {"ceil", "floor", "rint", "abs", "negate", "sign",
                                       "bit_invert", "not"}


def unary_operation(col: Column, op: str) -> Column:
    """cudf::unary_operation: integer inputs of the float functions give
    float64, ``not`` gives bool, the rest keep the dtype."""
    fn = _UNARY_FNS[op]
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
    places (an integer column only to negative ones)."""
    if col.dtype.is_integer and decimals >= 0:
        return col
    x = col.data
    if col.dtype.is_integer:
        iscale = 10 ** (-decimals)
        q = torch.div(x + torch.sign(x) * (iscale // 2), iscale, rounding_mode="floor") * iscale
        return Column(col.dtype, col.length, q.to(x.dtype), col.validity)
    scale = 10.0 ** decimals
    if how == "half_even":
        data = torch.round(x * scale) / scale
    else:
        data = torch.floor(torch.abs(x) * scale + 0.5) / scale * torch.sign(x)
    return Column(col.dtype, col.length, data.to(x.dtype), col.validity)
