"""Null fills, forward and backward fills, value replacement, clamps, and
NaN and signed-zero normalisation (port of ``cudf_tpu/ops/replace.py``).

``ffill`` is a ``cummax`` over the positions of the valid rows, then one
gather; ``bfill`` the same over the reversed column.  ``replace_values``
sorts the old values once and searches every row among them.
"""

from __future__ import annotations

from typing import Optional

import torch

from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import (
    FEW_VALUES, Column, holds, is_null_scalar, plain_fixed, to_ticks)
from cudf_tpu_torch.ops._utils import materialize_validity
from cudf_tpu_torch.utils import tracing


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
                       tracing.synced("host_values", col.device, torch.tensor, fill,
                                      dtype=col.data.dtype, device=col.device))
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
    if not tracing.to_bool(nan.any(), "nan_check"):
        return col
    return Column(col.dtype, col.length, col.data, materialize_validity(col) & ~nan)


def ffill(col: Column, limit: Optional[int] = None) -> Column:
    """Forward fill (replace_nulls policy PRECEDING): a null row takes the
    last valid row before it, at most ``limit`` rows back."""
    if col.validity is None:
        return col
    from cudf_tpu_torch.ops.copying import gather
    from cudf_tpu_torch.ops.scan import running_extreme

    idx = torch.arange(col.length, dtype=torch.int64, device=col.device)
    last_valid = running_extreme(torch.where(col.validity, idx, -1), "cummax")
    if limit is not None:
        last_valid = torch.where(idx - last_valid <= limit, last_valid, -1)
    return gather(col, last_valid, bounds_check=True)


def bfill(col: Column, limit: Optional[int] = None) -> Column:
    """Backward fill (policy FOLLOWING)."""
    if col.validity is None:
        return col
    from cudf_tpu_torch.ops.copying import reverse

    return reverse(ffill(reverse(col), limit))


def replace_values(col: Column, old_values: Column, new_values: Column) -> Column:
    """cudf::find_and_replace_all: each row equal to old_values[j] takes
    new_values[j] (the first such j), in the columns' common dtype."""
    from cudf_tpu_torch.ops.copying import copy_if_else, gather
    from cudf_tpu_torch.ops.search import first_match

    if old_values.validity is None:        # no null to replace: one search operand
        pick = first_match(old_values, col.with_validity(None))
        if col.validity is not None:
            pick = torch.where(col.validity, pick, -1)
    else:
        pick = first_match(old_values, col)
    return copy_if_else(pick >= 0, gather(new_values, pick, bounds_check=True), col)


def replace_scalars(col: Column, olds, news) -> Optional[Column]:
    """replace_values for a few host values (at most 16, none null, each
    one the column holds): one equality pass a value, no search; None
    where that does not apply."""
    if len(olds) > FEW_VALUES or not plain_fixed(col.dtype) or any(
            is_null_scalar(v) or not holds(col.dtype, v) for v in olds) or any(
            is_null_scalar(v) for v in news):
        return None
    new_col = Column.from_pylist(list(news), device=col.device) if news else None
    target = col.dtype if new_col is None or all(holds(col.dtype, v) for v in news) \
        else dt.common_dtype(col.dtype, new_col.dtype)
    ticks = (lambda v: to_ticks(v, col.dtype)) if col.dtype.is_temporal else (lambda v: v)
    out = col.data.to(target.torch_storage)
    done = torch.zeros(col.length, dtype=torch.bool, device=col.device) \
        if col.validity is None else ~col.validity
    for o, v in zip(olds, news):
        m = (col.data == ticks(o)) & ~done
        out = torch.where(m, torch.tensor(ticks(v) if target.is_temporal else v,
                                          dtype=out.dtype, device=col.device), out)
        done = done | m
    return Column(target, col.length, out, col.validity)


def replace_where(col: Column, mask: torch.Tensor, value) -> Column:
    """col[i] = value where mask[i]: a null value nulls the rows; a value
    the column's dtype holds keeps it, any other promotes as pandas does."""
    from cudf_tpu_torch.ops.copying import copy_if_else

    if is_null_scalar(value):
        return col.with_validity(materialize_validity(col) & ~mask)
    if holds(col.dtype, value) and not (col.dtype.is_string or col.dtype.is_dictionary):
        value = to_ticks(value, col.dtype) if col.dtype.is_temporal else value
        data = torch.where(mask, torch.tensor(value, dtype=col.data.dtype,
                                              device=col.device), col.data)
        validity = None if col.validity is None else col.validity | mask
        return Column(col.dtype, col.length, data, validity)
    return copy_if_else(mask, value, col)


def clamp(col: Column, lo=None, hi=None) -> Column:
    """Values below lo become lo, above hi hi (NaN and nulls stay)."""
    data = col.data
    if lo is not None:
        data = torch.maximum(data, tracing.synced("host_values", data.device, torch.tensor, lo,
                                                            dtype=data.dtype, device=data.device))
    if hi is not None:
        data = torch.minimum(data, tracing.synced("host_values", data.device, torch.tensor, hi,
                                                            dtype=data.dtype, device=data.device))
    return Column(col.dtype, col.length, data, col.validity)
