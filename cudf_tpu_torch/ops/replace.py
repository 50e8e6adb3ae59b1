"""Null fills and NaN and signed-zero normalisation (port of
``cudf_tpu/ops/replace.py`` ``replace_nulls_scalar``,
``replace_nulls_column``, ``normalize_nans_and_zeros`` and
``nans_to_nulls``; the rest is ROADMAP.md queue 1, item 1)."""

from __future__ import annotations

import torch

from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import Column, to_ticks
from cudf_tpu_torch.ops._utils import materialize_validity


def replace_nulls_scalar(col: Column, value) -> Column:
    """cudf::replace_nulls with a scalar: an integer column filled with a
    non-integral float becomes float64, as in the reference."""
    if col.validity is None:
        return col
    if col.dtype.is_string or col.dtype.is_dictionary:
        from cudf_tpu_torch.ops.copying import copy_if_else

        return copy_if_else(col.validity, col.with_validity(None), str(value))
    if col.dtype.is_integer and isinstance(value, float) and not value.is_integer():
        from cudf_tpu_torch.ops.unary import cast

        col = cast(col, dt.FLOAT64)
    fill = to_ticks(value, col.dtype) if col.dtype.is_temporal else value
    data = torch.where(col.validity, col.data,
                       torch.tensor(fill, dtype=col.data.dtype, device=col.device))
    return Column(col.dtype, col.length, data)


def replace_nulls_column(col: Column, other: Column) -> Column:
    """cudf::replace_nulls with a column: each null row takes ``other``'s
    row (which may be null too), in the two columns' common dtype."""
    if col.validity is None:
        return col
    from cudf_tpu_torch.ops.copying import copy_if_else

    return copy_if_else(col.validity, col, other)


def normalize_nans_and_zeros(col: Column) -> Column:
    """-0.0 becomes +0.0 and every NaN the positive canonical NaN."""
    if not col.dtype.is_float:
        return col
    data = torch.where(col.data == 0, torch.zeros_like(col.data), col.data)
    data = torch.where(torch.isnan(data), torch.full_like(data, float("nan")), data)
    return Column(col.dtype, col.length, data, col.validity)


def nans_to_nulls(col: Column) -> Column:
    """NaN rows of a float column become nulls (one host sync: a column
    without NaN keeps its mask, or none)."""
    if not col.dtype.is_float:
        return col
    nan = torch.isnan(col.data)
    if not bool(nan.any()):
        return col
    return Column(col.dtype, col.length, col.data, materialize_validity(col) & ~nan)
