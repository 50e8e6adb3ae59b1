"""Groupby aggregation through the kernel tiers.

Port of the dispatch in ``cudf_tpu/ops/groupby.py:862-1061``
(``_try_onehot_fast_path`` and ``groupby_agg``).  One integer key column
is reduced to int32 codes ``key - key_min`` over K = max - min + 1 slots:

- K <= 4096: the one-hot tier, kernel A
  (``kernels/hash_aggregate.py``);
- K <= 2^27: the radix tier, kernels B, F, G and D
  (``kernels/radix_partition.py``); min/max there are a plain
  ``scatter_reduce_``, as the reference leaves them to XLA.

The output holds the observed groups only, in ascending key order.
Values keep their own width: integer and bool sums are exact int64,
float sums float64, min/max the column's dtype.  Unlike the reference,
a group whose values are all null gives a null mean, min and max (its
sum is 0 and its count 0, as in pandas), and min/max skip NaN as pandas
does (a group of only NaN gives NaN) on both tiers.  NaN is otherwise a
value: it is counted, and it makes its group's sum and mean NaN.

The sort tier is not ported yet, so a request the kernel tiers cannot
serve raises NotImplementedError.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from cudf_tpu_torch.core import bitmask as bm
from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.core.table import Table
from cudf_tpu_torch.kernels import _build
from cudf_tpu_torch.kernels.hash_aggregate import (MAX_GROUPS,
                                                  onehot_groupby_aggregate,
                                                  segment_minmax_plain)
from cudf_tpu_torch.kernels.radix_partition import (MAX_DOMAIN_BITS,
                                                    radix_groupby_sum_count)
from cudf_tpu_torch.ops import copying
from cudf_tpu_torch.ops.stream_compaction import filter_indices
from cudf_tpu_torch.utils.config import get_option

SORT_TIER_MISSING = (
    "this groupby needs the sort tier (make_grouper, ops/sort.py, "
    "ops/row_ops.py), which is not ported yet: ROADMAP.md queue 1, item 2. "
    "The kernel tiers serve one integer key column with at most 2^27 "
    "distinct slots, numeric (not uint64) or bool values, and "
    "sum/count/mean/min/max/size")

SUPPORTED_AGGS = frozenset({"sum", "count", "mean", "min", "max", "size"})

Request = Tuple[object, Column, str]


def _key_range(key: Column, valid: Optional[torch.Tensor]) -> Tuple[int, int]:
    """(min, max) over the rows that form groups; (0, -1) when none do."""
    data = key.data if key.dtype.is_signed_integer else key.data.long()
    if valid is not None:
        data = data[valid]
    if data.numel() == 0:
        return 0, -1
    lo, hi = torch.aminmax(data)
    return int(lo), int(hi)


def _try_onehot_fast_path(keys: Table, values: Sequence[Request],
                          dropna: bool) -> Optional[Tuple[Table, Table]]:
    """(group keys, aggregations) from the kernel tiers, or None when the
    request is outside them (see SORT_TIER_MISSING)."""
    if not get_option("groupby.onehot_fast_path"):
        return None
    key = keys.column(0) if keys.num_columns == 1 else None
    if key is None or key.length < int(get_option("groupby.fast_path_min_rows")):
        return None
    if not key.dtype.is_integer:
        return None
    if key.has_nulls and not dropna:
        return None          # the null-key group needs the sort tier
    for _, col, agg in values:
        if agg not in SUPPORTED_AGGS or not (col.dtype.is_numeric or col.dtype.is_bool):
            return None
        if col.dtype == dt.UINT64:
            return None      # the kernels take no uint64 values
    valid = key.validity if dropna else None
    lo, hi = _key_range(key, valid)
    K = max(hi - lo + 1, 1)
    if K > 1 << MAX_DOMAIN_BITS:
        return None
    src = key.data if key.dtype.is_signed_integer else key.data.long()
    codes = (src - lo).to(torch.int32)
    return _aggregate(keys.names[0], key, codes, K, lo, valid, list(values))


def _aggregate(key_name, key: Column, codes: torch.Tensor, K: int, key_lo: int,
               valid: Optional[torch.Tensor],
               values: List[Request]) -> Tuple[Table, Table]:
    radix_tier = K > MAX_GROUPS
    # the rows each request aggregates: the key's valid rows, and for
    # every agg but size the value's valid rows too
    masks: Dict[int, Optional[torch.Tensor]] = {}
    for _, col, agg in values:
        if id(col) not in masks:
            masks[id(col)] = bm.and_masks(valid, col.validity)
    # one kernel run per distinct (column, mask); size reads no values
    runs: Dict[Tuple, dict] = {}
    for _, col, agg in values:
        mask = valid if agg == "size" else masks[id(col)]
        run = runs.setdefault((id(col), id(mask)),
                              {"col": col, "mask": mask, "minmax": False})
        run["minmax"] |= agg in ("min", "max")
    # a group forms from any row with a valid key, values null or not:
    # when no request counts those rows, count them over the codes
    if not any(r["mask"] is valid for r in runs.values()):
        runs[("presence", id(valid))] = {"col": Column(dt.INT32, codes.shape[0], codes),
                                         "mask": valid, "minmax": False}
    if radix_tier:
        _run_radix(codes, K, runs)
    else:
        for run in runs.values():
            run["out"] = onehot_groupby_aggregate(codes, run["col"].data, K,
                                                  valid=run["mask"],
                                                  with_minmax=run["minmax"])
    occupied = next(r["out"][1] for r in runs.values() if r["mask"] is valid)

    results: Dict[object, Column] = {}
    for name, col, agg in values:
        mask = valid if agg == "size" else masks[id(col)]
        s, c, mn, mx = runs[(id(col), id(mask))]["out"]
        if agg == "sum":
            out_dt = dt.FLOAT64 if s.dtype == torch.float64 else dt.INT64
            results[name] = Column(out_dt, K, s)
        elif agg in ("count", "size"):
            results[name] = Column(dt.INT64, K, c)
        elif agg == "mean":
            results[name] = Column(dt.FLOAT64, K, s.double() / c.clamp(min=1),
                                   c > 0)
        else:
            results[name] = Column(col.dtype, K, mn if agg == "min" else mx, c > 0)
    present = filter_indices(occupied > 0)
    out_aggs = Table({n: copying.gather(c, present, bounds_check=False)
                      for n, c in results.items()})
    key_col = Column(key.dtype, present.shape[0],
                     (present + key_lo).to(key.dtype.torch_storage))
    return Table({key_name: key_col}), out_aggs


def _run_radix(codes: torch.Tensor, K: int, runs: Dict[Tuple, dict]) -> None:
    """Fill run["out"] = (sums, counts, mins, maxs) on the radix tier:
    runs that share a mask share one partition of the keys."""
    by_mask: Dict[int, List[dict]] = {}
    for run in runs.values():
        by_mask.setdefault(id(run["mask"]), []).append(run)
    for group in by_mask.values():
        mask = group[0]["mask"]
        k_in = codes if mask is None else torch.where(mask, codes, -1)
        sums, counts = radix_groupby_sum_count(
            k_in, [r["col"].data for r in group], K)
        for run, s in zip(group, sums):
            mn = mx = None
            if run["minmax"]:
                mn, mx = _segment_minmax(k_in, run["col"].data, K)
            run["out"] = (s, counts, mn, mx)


def _segment_minmax(k_in: torch.Tensor, vals: torch.Tensor, K: int):
    """Per-group min and max in vals' dtype, skipping NaN as kernel A
    does (plain scatter_reduce_; an empty group's entries are masked by
    its zero count)."""
    kv, _, _ = _build.kernel_values(vals)
    ok = k_in >= 0
    mins, maxs = segment_minmax_plain(k_in[ok].long(), kv[ok], K)
    return mins.to(vals.dtype), maxs.to(vals.dtype)


def groupby_agg(keys: Table, values: Sequence[Request],
                dropna: bool = True) -> Tuple[Table, Table]:
    """values: (output_name, column, agg) triples -> (group keys, aggs).

    Port of ``cudf_tpu/ops/groupby.py:1039``: the kernel tiers serve the
    request, or NotImplementedError names the missing sort tier."""
    fast = _try_onehot_fast_path(keys, list(values), dropna)
    if fast is None:
        raise NotImplementedError(SORT_TIER_MISSING)
    return fast
