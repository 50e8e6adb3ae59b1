"""Stream compaction (port of ``cudf_tpu/ops/stream_compaction.py``):
boolean-mask filters, null drops, the sort-based distinct family over
``row_ops`` (one lexicographic sort, then adjacent compares) and the
HyperLogLog ``approx_distinct_count`` over ``row_ops.hash_column``, whose
hashes are the reference's bit for bit (so is the estimate)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.core.table import Table
from cudf_tpu_torch.ops import copying
from cudf_tpu_torch.ops._utils import materialize_validity
from cudf_tpu_torch.ops.row_ops import equality_keys, lex_sort_indices


def filter_indices(mask: torch.Tensor) -> torch.Tensor:
    """bool[n] -> int64[k] indices of the True entries, ascending (one
    host sync for k, like the reference's two-phase compaction)."""
    return torch.nonzero(mask).squeeze(1)


def _mask_of(mask: Column) -> torch.Tensor:
    """A boolean mask column as bool[n]; null entries count as False."""
    m = mask.data.to(torch.bool)
    return m if mask.validity is None else m & mask.validity


def apply_boolean_mask(col: Column, mask: Column) -> Column:
    """cudf::apply_boolean_mask: the rows where mask is True."""
    return copying.gather(col, filter_indices(_mask_of(mask)), bounds_check=False)


def apply_boolean_mask_table(table: Table, mask: Column) -> Table:
    return copying.gather_table(table, filter_indices(_mask_of(mask)), bounds_check=False)


def drop_nulls(col: Column) -> Column:
    if col.validity is None:
        return col
    return copying.gather(col, filter_indices(col.validity), bounds_check=False)


def drop_nulls_table(table: Table, keys: Optional[Sequence] = None, how: str = "any") -> Table:
    """Rows with a null in any (how="any") or every (how="all") key."""
    names = keys if keys is not None else table.names
    m = None
    for n in names:
        v = materialize_validity(table[n])
        m = v if m is None else (m & v if how == "any" else m | v)
    return copying.gather_table(table, filter_indices(m), bounds_check=False)


def _adjacent_neq(cols: Sequence[Column], order: torch.Tensor) -> torch.Tensor:
    """bool[n] in the given order: True where a new distinct run starts."""
    n = order.shape[0]
    acc = torch.zeros(n, dtype=torch.bool, device=order.device)
    acc[:1] = True
    for col in cols:
        for k in equality_keys(col):
            s = k[order]
            acc[1:] |= s[1:] != s[:-1]
    return acc


def distinct_indices(keys: Sequence[Column], keep="first") -> torch.Tensor:
    """Row indices of distinct rows in input order (cudf::distinct, pandas
    drop_duplicates): keep "first", "last" or "none" (False)."""
    keys = list(keys)
    n = keys[0].length
    if n == 0:
        return torch.zeros(0, dtype=torch.int64, device=keys[0].device)
    order = lex_sort_indices(keys)
    neq = _adjacent_neq(keys, order)
    is_last = torch.cat([neq[1:], torch.ones(1, dtype=torch.bool, device=neq.device)])
    if keep == "first":
        pick = neq
    elif keep == "last":
        pick = is_last
    else:                                  # keep none: runs of one row
        pick = neq & is_last
    return torch.sort(order[filter_indices(pick)]).values


def duplicated_mask(keys: Sequence[Column], keep="first") -> torch.Tensor:
    """bool[n], True where the row is a duplicate (pandas duplicated)."""
    keys = list(keys)
    mask = torch.ones(keys[0].length, dtype=torch.bool, device=keys[0].device)
    mask[distinct_indices(keys, keep if keep else "none")] = False
    return mask


def distinct(table: Table, key_names: Optional[Sequence] = None, keep="first") -> Table:
    names = key_names if key_names is not None else table.names
    idx = distinct_indices([table[n] for n in names], keep)
    return copying.gather_table(table, idx, bounds_check=False)


def unique(col: Column) -> Column:
    """Adjacent dedup (cudf::unique: the input is sorted or grouped)."""
    if col.length == 0:
        return col
    order = torch.arange(col.length, dtype=torch.int64, device=col.device)
    return copying.gather(col, filter_indices(_adjacent_neq([col], order)),
                          bounds_check=False)


def distinct_count(col: Column, dropna: bool = True) -> int:
    """Number of distinct values; with dropna, null and NaN are not counted."""
    if col.length == 0:
        return 0
    neq = _adjacent_neq([col], lex_sort_indices([col]))
    valid = materialize_validity(col)
    flags = [neq.sum(), (~valid).any()]
    if col.dtype.is_float:
        flags.append((torch.isnan(col.data) & valid).any())
    total, *drops = (int(x) for x in torch.stack([f.long() for f in flags]).tolist())
    return total - sum(drops) if dropna else total


def approx_distinct_count(col: Column, precision: int = 12) -> int:
    """HyperLogLog estimate (the reference's): bucket = the hash's top
    ``precision`` bits, rank = 1 + the leading zeros of the rest (the
    reference's six-step count, kept as it is), one scatter-max into the
    registers, then the estimate on the host."""
    import numpy as np

    from cudf_tpu_torch.ops.row_ops import _shr, hash_column

    h = hash_column(col)                      # the uint64 hash as int64 bits
    m = 1 << precision
    bucket = _shr(h, 64 - precision)
    x = (h << precision) | ((1 << precision) - 1)
    lz = torch.zeros_like(h)
    for shift in (32, 16, 8, 4, 2, 1):
        zero_top = _shr(x, 64 - shift) == 0
        lz = lz + torch.where(zero_top, shift, 0)
        x = torch.where(zero_top, x << shift, x)
    regs = torch.zeros(m, dtype=torch.int64, device=h.device).scatter_reduce_(
        0, bucket, lz + 1, "amax")
    regs_np = regs.cpu().numpy().astype(np.float64)
    alpha = 0.7213 / (1 + 1.079 / m)
    est = alpha * m * m / np.sum(2.0 ** (-regs_np))
    if est <= 2.5 * m:
        zeros = int(np.sum(regs_np == 0))
        if zeros:
            est = m * np.log(m / zeros)
    return int(round(est))
