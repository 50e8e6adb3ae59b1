"""Sorting: sorted_order, sort, sort_by_key, is_sorted, rank, top_k and the
segmented sort (port of ``cudf_tpu/ops/sort.py``).

Every order is the LSD chain of stable argsorts over the row-operator
operands (``ops/row_ops.py``); a segmented sort puts the segment id
first.  These are PyTorch library sorts: the reference's sort tier
reaches no Pallas kernel, and neither does this one.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.core.table import Table
from cudf_tpu_torch.ops import copying
from cudf_tpu_torch.ops._utils import inverse_permutation
from cudf_tpu_torch.ops.row_ops import (equality_keys, lex_sort_indices, lex_sort_permutation,
                                        order_keys, sort_operands)
from cudf_tpu_torch.utils import tracing


@tracing.annotate("sort.sorted_order", "ops")
def sorted_order(keys: Sequence[Column], ascending: Optional[Sequence[bool]] = None,
                 na_position: str = "last") -> torch.Tensor:
    """Stable argsort over key columns (cudf::stable_sorted_order), int64."""
    return lex_sort_indices(list(keys), ascending, na_position)


def sort(col: Column, ascending: bool = True, na_position: str = "last") -> Column:
    return copying.gather(col, sorted_order([col], [ascending], na_position),
                          bounds_check=False)


@tracing.annotate("sort.sort_by_key", "ops")
def sort_by_key(values: Table, keys: Sequence[Column],
                ascending: Optional[Sequence[bool]] = None,
                na_position: str = "last") -> Table:
    return copying.gather_table(values, sorted_order(keys, ascending, na_position),
                                bounds_check=False)


def is_sorted(keys: Sequence[Column], ascending: Optional[Sequence[bool]] = None,
              na_position: str = "last") -> bool:
    """True when every row is <= the next in the requested order."""
    keys = list(keys)
    if keys[0].length <= 1:
        return True
    if ascending is None:
        ascending = [True] * len(keys)
    m = keys[0].length - 1
    strict_lt = torch.zeros(m, dtype=torch.bool, device=keys[0].device)
    all_eq = torch.ones(m, dtype=torch.bool, device=keys[0].device)
    for col, asc in zip(keys, ascending):
        for op in order_keys(col, asc, na_position):
            a, b = op[:-1], op[1:]
            strict_lt |= all_eq & (a < b)
            all_eq &= a == b
    return tracing.to_bool((strict_lt | all_eq).all(), "is_sorted")


@tracing.annotate("sort.rank", "ops")
def rank(col: Column, method: str = "average", ascending: bool = True,
         na_option: str = "keep", pct: bool = False) -> Column:
    """cudf::rank with pandas' semantics: float64 ranks; with
    na_option="keep" null rows stay null, "top"/"bottom" rank them first
    or last.  Unlike the reference, a dense pct rank under "keep" divides
    by the number of distinct non-null values, as pandas does."""
    n = col.length
    dev = col.device
    order = sorted_order([col], [ascending], "first" if na_option == "top" else "last")
    sorted_pos = inverse_permutation(order)
    neq = torch.zeros(n, dtype=torch.bool, device=dev)
    neq[:1] = True
    for k in equality_keys(col):
        s = k[order]
        neq[1:] |= s[1:] != s[:-1]
    gid = torch.cumsum(neq, 0) - 1                  # dense group id a sorted row
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    group_first = torch.cummax(torch.where(neq, pos, -1), 0).values
    group_sizes = torch.zeros(n, dtype=torch.int64, device=dev).index_add_(
        0, gid, torch.ones_like(gid))
    if method == "first":
        ranks_sorted = (pos + 1).double()
    elif method == "min":
        ranks_sorted = (group_first + 1).double()
    elif method == "max":
        ranks_sorted = (group_first + group_sizes[gid]).double()
    elif method == "dense":
        ranks_sorted = (gid + 1).double()
    elif method == "average":
        lo = (group_first + 1).double()
        hi = (group_first + group_sizes[gid]).double()
        ranks_sorted = (lo + hi) / 2.0
    else:
        raise ValueError(f"rank method {method!r}")
    ranks = ranks_sorted[sorted_pos]
    keep = na_option == "keep" and col.validity is not None
    if pct:
        if method == "dense":
            last = gid[-1:] + 1
            if keep:     # the null run sorts last: leave it out when there is one
                last = last - (~col.validity).any().long()
            denom = last.double()
        elif keep:
            denom = col.validity.sum().double()
        else:
            denom = tracing.synced("host_values", dev, torch.tensor, float(n),
                                   dtype=torch.float64, device=dev)
        ranks = ranks / denom
    return Column(dt.FLOAT64, n, ranks, col.validity if keep else None)


def top_k_order(col: Column, k: int, largest: bool = True) -> torch.Tensor:
    """Row indices of the k largest (smallest) values, nulls last, ties in
    row order."""
    return sorted_order([col], [not largest], "last")[:k]


def top_k(col: Column, k: int, largest: bool = True) -> Column:
    """cudf::top_k: the k largest (smallest) values, in order.  A column
    without nulls takes one ``torch.topk`` of its order operand, as the
    reference takes ``lax.top_k``."""
    k = min(k, col.length)
    ops = order_keys(col, ascending=not largest, na_position="last")
    if len(ops) == 1:
        idx = torch.topk(ops[0], k, largest=False, sorted=True).indices
        return copying.gather(col, idx, bounds_check=False)
    return copying.gather(col, top_k_order(col, k, largest), bounds_check=False)


def segmented_sort_indices(segment_ids: torch.Tensor, keys: Sequence[Column],
                           ascending: Optional[Sequence[bool]] = None,
                           na_position: str = "last") -> torch.Tensor:
    """Stable argsort within segments: the segment id is the leading key."""
    ops = [segment_ids.long(), *sort_operands(list(keys), ascending, na_position)]
    return lex_sort_permutation(ops)
