"""LIST columns (port of ``cudf_tpu/ops/lists.py``; libcudf's
cpp/src/lists/: extract.cu, contains.cu, explode.cu, count_elements.cu,
sequences.cu, segmented_sort, the set operations).

A LIST column is Arrow's list layout: int64 ``offsets`` [n + 1] from 0
and one child column, row i being ``child[offsets[i]:offsets[i + 1]]``;
a null row is empty.  Every op runs on the column's device: per-element
row ids come from ``segment_expand`` (a ``torch.searchsorted`` of the
element positions in the offsets), per-row reductions are
``scatter_reduce_`` / ``index_add_`` over those ids, and the one host
sync of an op that builds a new child is its element count.
``from_pylists`` and ``to_pylists`` are the host factories, counted in
``HOST_ROUTES`` as the reference goes to the host there too.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from cudf_tpu_torch.core import bitmask as bm
from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.ops import copying
from cudf_tpu_torch.ops._utils import count_host_route, segment_expand


def make_list_column(offsets: torch.Tensor, child: Column,
                     validity: Optional[torch.Tensor] = None) -> Column:
    return Column(dt.list_dtype(child.dtype), offsets.shape[0] - 1, None, validity,
                  offsets.to(torch.int64), (child,))


def offsets_of(lens: torch.Tensor) -> torch.Tensor:
    """int64[n + 1]: 0 then the running sum of ``lens``."""
    out = torch.zeros(lens.shape[0] + 1, dtype=torch.int64, device=lens.device)
    torch.cumsum(lens, 0, out=out[1:])
    return out


def lengths(col: Column) -> torch.Tensor:
    return col.offsets[1:] - col.offsets[:-1]


def element_rows(col: Column) -> torch.Tensor:
    """int64[child length]: the row of every element."""
    return segment_expand(col.offsets, col.children[0].length)


def from_pylists(lists, dtype=None, *, device) -> Column:
    """Host factory: a list of lists (None: a null row) onto ``device``;
    ``dtype`` is the child's."""
    count_host_route("from_pylists")
    flat, lens, valid = [], [], []
    for row in lists:
        if row is None:
            lens.append(0)
            valid.append(False)
        else:
            row = list(row)
            flat.extend(row)
            lens.append(len(row))
            valid.append(True)
    offsets = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    child = Column.from_pylist(flat, dtype, device=device)
    return make_list_column(torch.from_numpy(offsets).to(device), child,
                            bm.from_numpy_mask(np.array(valid, bool), device))


def to_pylists(col: Column) -> list:
    """Host export: each row's values as a Python list, None for a null row."""
    count_host_route("to_pylists")
    offs = col.offsets.cpu().tolist()
    vals = col.children[0].to_pylist()
    valid = None if col.validity is None else col.validity.cpu().tolist()
    return [None if valid is not None and not valid[i] else vals[offs[i]:offs[i + 1]]
            for i in range(col.length)]


def count_elements(col: Column) -> Column:
    return Column(dt.INT64, col.length, lengths(col), col.validity)


def extract_list_element(col: Column, index: int) -> Column:
    """``list.get(i)`` with Python's negative indices (extract.cu): null
    where a row is shorter or null."""
    lens = lengths(col)
    idx = torch.full_like(lens, index) if index >= 0 else lens + index
    ok = (idx >= 0) & (idx < lens)
    out = copying.gather(col.children[0], torch.where(ok, col.offsets[:-1] + idx, -1),
                         bounds_check=True)
    return out.with_validity(bm.and_masks(out.validity, col.validity))


def explode(col: Column, outer: bool = False):
    """(the elements, the source row of each) (explode.cu); with ``outer``
    an empty or null row gives one null element.  One host sync (the
    element count) for ``outer``."""
    child = col.children[0]
    if not outer:
        return child, element_rows(col)
    lens = lengths(col)
    out_offsets = offsets_of(torch.clamp(lens, min=1))
    total = int(out_offsets[-1])
    row = segment_expand(out_offsets, total)
    within = torch.arange(total, dtype=torch.int64, device=col.device) - out_offsets[row]
    has = within < lens[row]
    src = torch.where(has, col.offsets[row] + within, -1)
    return copying.gather(child, src, bounds_check=True), row


def _matches(col: Column, value) -> torch.Tensor:
    """bool[elements]: the element equals ``value`` and is not null."""
    from cudf_tpu_torch.ops.binaryop import binary_operation

    eq = binary_operation(col.children[0], value, "eq")
    return eq.data if eq.validity is None else eq.data & eq.validity


def contains(col: Column, value) -> Column:
    """``list.contains(scalar)`` (contains.cu)."""
    m = _matches(col, value)
    got = torch.zeros(col.length, dtype=torch.int64, device=col.device)
    got.index_add_(0, element_rows(col), m.long())
    return Column(dt.BOOL8, col.length, got > 0, col.validity)


def index_of(col: Column, value) -> Column:
    """The first position of ``value`` in each row, -1 where absent."""
    m = _matches(col, value)
    row = element_rows(col)
    within = torch.arange(row.shape[0], dtype=torch.int64, device=col.device) - col.offsets[row]
    big = torch.iinfo(torch.int64).max
    first = torch.full((col.length,), big, dtype=torch.int64, device=col.device)
    first.scatter_reduce_(0, row, torch.where(m, within, big), "amin")
    return Column(dt.INT64, col.length, torch.where(first == big, -1, first), col.validity)


def concatenate_rows(cols: Sequence[Column]) -> Column:
    """Row-wise list concatenation (concatenate_rows.cu): row i is the
    lists of row i one after another, null where any is.  Each output
    element's source is found by one search of its position in the row's
    running list lengths, then one gather from the stacked children."""
    k, n, dev = len(cols), cols[0].length, cols[0].device
    lens = torch.stack([lengths(c) for c in cols])                       # [k, n]
    run = torch.cumsum(lens, 0)                                          # ends, per row
    offsets = offsets_of(run[-1])
    total = int(offsets[-1])
    row = segment_expand(offsets, total)
    within = torch.arange(total, dtype=torch.int64, device=dev) - offsets[row]
    ends = run.t().contiguous()                                          # [n, k]
    which = torch.searchsorted(ends[row], within[:, None], right=True)[:, 0]
    before = torch.where(which > 0, ends[row, (which - 1).clamp(min=0)], 0)
    starts = torch.stack([c.offsets[:-1] for c in cols])                 # [k, n]
    bases = offsets_of(torch.tensor([c.children[0].length for c in cols], device=dev))
    src = bases[which] + starts[which, row] + (within - before)
    child = copying.gather(copying.concatenate([c.children[0] for c in cols]), src,
                           bounds_check=False)
    return make_list_column(offsets, child, bm.and_masks(*[c.validity for c in cols]))


def segmented_sort(col: Column, ascending: bool = True) -> Column:
    """Each list sorted (segmented_sort.cu), nulls last: one stable sort
    by (row, value)."""
    from cudf_tpu_torch.ops.row_ops import lex_sort_permutation, order_keys

    child = col.children[0]
    order = lex_sort_permutation([element_rows(col), *order_keys(child, ascending, "last")])
    return make_list_column(col.offsets, copying.gather(child, order, bounds_check=False),
                            col.validity)


def unique_per_row(col: Column) -> Column:
    """Each list's distinct values, ascending (a null kept once)."""
    from cudf_tpu_torch.ops.row_ops import equality_keys, lex_sort_permutation, order_keys
    from cudf_tpu_torch.ops.stream_compaction import filter_indices

    child = col.children[0]
    row = element_rows(col)
    order = lex_sort_permutation([row, *order_keys(child, True, "last")])
    row_s = row[order]
    neq = torch.ones(row_s.shape[0], dtype=torch.bool, device=col.device)
    neq[1:] = row_s[1:] != row_s[:-1]
    for key in equality_keys(child):
        ks = key[order]
        neq[1:] |= ks[1:] != ks[:-1]
    keep = filter_indices(neq)
    lens = torch.zeros(col.length, dtype=torch.int64, device=col.device)
    lens.index_add_(0, row_s[keep], torch.ones_like(keep))
    return make_list_column(offsets_of(lens),
                            copying.gather(child, order[keep], bounds_check=False),
                            col.validity)


def sequences(starts: Column, sizes: Column, steps: Optional[Column] = None) -> Column:
    """Per-row arithmetic sequences (sequences.cu)."""
    offsets = offsets_of(sizes.data.long())
    total = int(offsets[-1])
    row = segment_expand(offsets, total)
    within = torch.arange(total, dtype=torch.int64, device=starts.device) - offsets[row]
    step = steps.data[row] if steps is not None else 1
    vals = starts.data[row] + within.to(starts.data.dtype) * step
    return make_list_column(offsets, Column(starts.dtype, total, vals.to(starts.data.dtype)))
