"""Copying (port of ``cudf_tpu/ops/copying.py`` for fixed-width columns:
``gather``, ``gather_table``, ``scatter``, ``slice``, ``split``,
``concatenate``, ``concatenate_tables``, ``sequence`` and ``reverse``)."""

from __future__ import annotations

from typing import List, Sequence

import torch

from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.core.table import Table
from cudf_tpu_torch.ops._utils import materialize_validity, signed_view


def gather(col: Column, gather_map: torch.Tensor, bounds_check: bool = True) -> Column:
    """out[i] = col[gather_map[i]].  With bounds_check, negative or
    out-of-range indices give nulls (libcudf out_of_bounds_policy::NULLIFY);
    without it the map must be in range."""
    m = gather_map.shape[0]
    if not bounds_check:
        validity = None if col.validity is None else col.validity[gather_map]
        return Column(col.dtype, m, _take(col.data, gather_map), validity)
    in_range = (gather_map >= 0) & (gather_map < col.length)
    if col.length == 0:
        # every row is out of range: all nulls
        return Column(col.dtype, m,
                      torch.zeros(m, dtype=col.data.dtype, device=col.device),
                      torch.zeros(m, dtype=torch.bool, device=col.device))
    safe = torch.where(in_range, gather_map, 0)
    validity = materialize_validity(col)[safe] & in_range
    return Column(col.dtype, m, _take(col.data, safe), validity)


def _take(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """data[idx]; uint16/32/64 through their signed view (CUDA indexes no
    such unsigned type)."""
    return signed_view(data)[idx].view(data.dtype)


def gather_table(table: Table, gather_map: torch.Tensor, bounds_check: bool = True) -> Table:
    return Table.from_pairs(table.names,
                            [gather(c, gather_map, bounds_check) for c in table.columns])


def scatter(source: Column, scatter_map: torch.Tensor, target: Column) -> Column:
    """target[scatter_map[i]] = source[i] (cudf::scatter), in target's
    dtype; the target is not modified."""
    smap = scatter_map.long()
    data = target.data.clone()
    signed_view(data)[smap] = signed_view(source.data.to(target.data.dtype))
    validity = None
    if target.validity is not None or source.validity is not None:
        validity = materialize_validity(target).clone()
        validity[smap] = materialize_validity(source)
    return Column(target.dtype, target.length, data, validity)


def slice(col: Column, start: int, stop: int) -> Column:  # noqa: A001
    start = max(0, min(start, col.length))
    stop = max(start, min(stop, col.length))
    validity = None if col.validity is None else col.validity[start:stop]
    return Column(col.dtype, stop - start, col.data[start:stop], validity)


def split(col: Column, splits: Sequence[int]) -> List[Column]:
    bounds = [0, *splits, col.length]
    return [slice(col, bounds[i], bounds[i + 1]) for i in range(len(bounds) - 1)]


def concatenate(cols: Sequence[Column]) -> Column:
    """Vertical concat; mixed dtypes are promoted as numpy promotes them."""
    cols = list(cols)
    if not cols:
        raise ValueError("need at least one column")
    if len(cols) == 1:
        return cols[0]
    target = cols[0].dtype
    for c in cols[1:]:
        target = dt.common_dtype(target, c.dtype)
    data = torch.cat([signed_view(c.data.to(target.torch_storage)) for c in cols])
    data = data.view(target.torch_storage)
    validity = None
    if any(c.validity is not None for c in cols):
        validity = torch.cat([materialize_validity(c) for c in cols])
    return Column(target, data.shape[0], data, validity)


def concatenate_tables(tables: Sequence[Table]) -> Table:
    names = tables[0].names
    return Table.from_pairs(names, [concatenate([t[n] for t in tables]) for n in names])


def sequence(length: int, start=0, step=1, dtype=dt.INT64, *, device) -> Column:
    """start, start + step, ... (length values of ``dtype`` on ``device``)."""
    dtype = dt.dtype(dtype)
    data = start + step * torch.arange(length, dtype=torch.int64, device=device)
    return Column(dtype, length, data.to(dtype.torch_storage))


def reverse(col: Column) -> Column:
    idx = torch.arange(col.length - 1, -1, -1, dtype=torch.int64, device=col.device)
    return gather(col, idx, bounds_check=False)

