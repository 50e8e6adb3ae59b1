"""NaN and signed-zero normalisation (port of ``cudf_tpu/ops/replace.py``
``normalize_nans_and_zeros`` and ``nans_to_nulls``)."""

from __future__ import annotations

import torch

from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.ops._utils import materialize_validity


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
