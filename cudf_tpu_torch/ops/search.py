"""Search: lower_bound, upper_bound, contains (port of
``cudf_tpu/ops/search.py``).

One order operand a side searches with ``torch.searchsorted``; several
(a null flag, a string's chunks) search by a merge: the haystack's and
the needles' operands concatenated, stable-sorted with a tie operand
that puts needles before (lower bound) or after (upper bound) equal
haystack rows.  ``contains`` (isin) sorts the haystack's equality
operands once and searches both bounds.
"""

from __future__ import annotations

from typing import List

import torch

from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import (
    FEW_VALUES, Column, holds, is_null_scalar, plain_fixed, to_ticks)
from cudf_tpu_torch.ops.row_ops import equality_keys, lex_sort_permutation, order_keys

_EMPTY_CHUNK = -(1 << 63)


def _common(a: Column, b: Column):
    """Both columns in one dtype (dictionaries decoded unless both share
    one keys column, since ranks of different dictionaries do not
    compare), with a validity mask on both sides when either has one."""
    if (a.dtype.is_dictionary or b.dtype.is_dictionary) and not (
            a.dtype.is_dictionary and b.dtype.is_dictionary and a.keys is b.keys):
        a, b = a.decode_dictionary(), b.decode_dictionary()
    if a.dtype != b.dtype:
        from cudf_tpu_torch.ops.unary import cast

        target = dt.common_dtype(a.dtype, b.dtype)
        a, b = cast(a, target), cast(b, target)
    if (a.validity is None) != (b.validity is None):
        a, b = (c if c.validity is not None else
                c.with_validity(torch.ones(c.length, dtype=torch.bool, device=c.device))
                for c in (a, b))
    return a, b


def _pad(ops: List[torch.Tensor], width: int) -> List[torch.Tensor]:
    """String operands padded to ``width`` with empty chunks before the
    trailing length (keeps byte order exact)."""
    head, tail = ops[:-1], ops[-1]
    n = tail.shape[0]
    while len(head) + 1 < width:
        head.append(torch.full((n,), _EMPTY_CHUNK, dtype=torch.int64, device=tail.device))
    return [*head, tail]


def _aligned(h_ops, n_ops):
    width = max(len(h_ops), len(n_ops))
    return _pad(list(h_ops), width), _pad(list(n_ops), width)


def _same_width(h_ops, n_ops):
    out_h, out_n = [], []
    for h, n in zip(h_ops, n_ops):
        if h.dtype != n.dtype:
            h, n = h.long(), n.long()
        out_h.append(h)
        out_n.append(n)
    return out_h, out_n


def lower_bound(haystack: Column, needles: Column, side: str = "left") -> torch.Tensor:
    """int64 insertion points of the needles into the sorted haystack
    (cudf::lower_bound; ``side="right"`` is cudf::upper_bound)."""
    h, n = _common(haystack, needles)
    h_ops, n_ops = _aligned(order_keys(h), order_keys(n))
    return _search(*_same_width(h_ops, n_ops), side)


def upper_bound(haystack: Column, needles: Column) -> torch.Tensor:
    return lower_bound(haystack, needles, side="right")


def _search(h_ops: List[torch.Tensor], n_ops: List[torch.Tensor], side: str) -> torch.Tensor:
    if len(h_ops) == 1:
        return torch.searchsorted(h_ops[0].contiguous(), n_ops[0].contiguous(),
                                  right=side == "right")
    return _lex_search(h_ops, n_ops, side)


def _lex_search(h_ops: List[torch.Tensor], n_ops: List[torch.Tensor], side: str) -> torch.Tensor:
    """Lexicographic searchsorted by a merge: each needle's insertion
    point is its position in the stable sort of haystack and needles
    together, less the needles before it."""
    nh, nn = h_ops[0].shape[0], n_ops[0].shape[0]
    dev = h_ops[0].device
    operands = [torch.cat([h, n]) for h, n in zip(h_ops, n_ops)]
    needle_tie = 0 if side == "left" else 1
    tie = torch.cat([torch.full((nh,), 1 - needle_tie, dtype=torch.int8, device=dev),
                     torch.full((nn,), needle_tie, dtype=torch.int8, device=dev)])
    order = lex_sort_permutation([*operands, tie])
    is_needle = order >= nh
    before = torch.cumsum(is_needle, 0) - is_needle.long()
    insert = torch.arange(nh + nn, device=dev) - before
    out = torch.empty(nn, dtype=torch.int64, device=dev)
    out[order[is_needle] - nh] = insert[is_needle]
    return out


def contains(haystack: Column, needles: Column) -> torch.Tensor:
    """bool[len(needles)]: the needle's value is in the haystack
    (cudf::contains, under Series.isin).  Null needles match null
    haystack rows, as pandas' isin has None and NaN match."""
    if haystack.length == 0 or needles.length == 0:
        return torch.zeros(needles.length, dtype=torch.bool, device=needles.device)
    h, n = _common(haystack, needles)
    h_ops, n_ops = _aligned(equality_keys(h), equality_keys(n))
    h_ops, n_ops = _same_width(h_ops, n_ops)
    order = lex_sort_permutation(h_ops)
    sorted_ops = [k[order] for k in h_ops]
    return _search(sorted_ops, n_ops, "right") > _search(sorted_ops, n_ops, "left")


def first_match(haystack: Column, needles: Column) -> torch.Tensor:
    """int64[len(needles)]: the first haystack row equal to each needle
    (a null needle equals a null row), -1 where none is."""
    from cudf_tpu_torch.ops.join import _aligned_keys, _probe_ranges

    if haystack.length == 0 or needles.length == 0:
        return torch.full((needles.length,), -1, dtype=torch.int64, device=needles.device)
    h_ops, n_ops = _aligned_keys([haystack], [needles], nulls_equal=True)
    order, lo, hi = _probe_ranges(n_ops, h_ops)
    return torch.where(hi > lo, order[lo.clamp(max=order.shape[0] - 1)], -1)


def is_in_list(col: Column, values) -> torch.Tensor:
    """bool[n]: the row's value is one of the host values (a null row
    matches a null value).  Over a dictionary column it is decided once
    per dictionary entry on the host, then by code on the device (one
    equality a matching code, up to FEW_VALUES; else a gather from a table
    of K booleans): no row is decoded.  Up to FEW_VALUES values over a
    fixed-width column are one equality pass each; more take a sorted
    search."""
    values = list(values)
    if col.dtype.is_dictionary and not any(is_null_scalar(x) for x in values):
        keys = col.keys
        if keys.dtype.is_string:
            want = {str(x) for x in values}
            km = [k in want for k in keys.host_strings()]
        else:
            want = set(values)
            km = [k in want for k in keys.data.tolist()]
        matched = [i for i, hit in enumerate(km) if hit]
        if len(matched) <= FEW_VALUES:
            mask = torch.zeros(col.length, dtype=torch.bool, device=col.device)
            for c in matched:
                mask |= col.data == c
        else:
            mask = torch.tensor(km, dtype=torch.bool).to(col.device)[
                col.data.clamp(min=0).long()]
        return mask if col.validity is None else mask & col.validity
    if not values:
        return torch.zeros(col.length, dtype=torch.bool, device=col.device)
    if len(values) <= FEW_VALUES and plain_fixed(col.dtype) and not any(
            is_null_scalar(x) for x in values):
        # a few values: one equality pass each, no search (a value the
        # column cannot hold matches no row)
        mask = torch.zeros(col.length, dtype=torch.bool, device=col.device)
        for x in values:
            if holds(col.dtype, x):
                mask |= col.data == (to_ticks(x, col.dtype) if col.dtype.is_temporal else x)
        return mask if col.validity is None else mask & col.validity
    needles = Column.from_pylist(values, device=col.device)
    if needles.validity is None and col.validity is not None:
        # no null value to match: search the values alone, then mask
        return contains(needles, col.with_validity(None)) & col.validity
    return contains(needles, col)
