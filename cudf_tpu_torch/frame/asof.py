"""``merge_asof``: nearest-key joins (port of ``cudf_tpu/frame/asof.py``;
pandas' merge_asof semantics).

The right rows are sorted by (by, on) with ``ops/row_ops.py``'s LSD chain
of stable argsorts (equal keys keep their order, so "backward" finds the
last of them, as pandas does), and each left row's match is one search of
its (by, on) tuple among them (``ops/join.py`` ``_lex_searchsorted``),
kept where the found row's ``by`` equals the left row's.  Keys of any
width are compared as they are: the reference packs ``group * 2^40 + on``
into one int64, which nanosecond timestamps overflow.  ``nearest`` takes
the closer of the backward and forward matches (backward on a tie), and
``tolerance`` (a number, or a Timedelta in the ``on`` column's unit)
drops matches farther away.  The result has the left rows in order, the
``on`` and ``by`` columns once (the left's), the right's other columns
gathered (null where no row matches) and ``suffixes`` on shared names.
"""

from __future__ import annotations

from typing import Optional

import torch

from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import Column, to_ticks
from cudf_tpu_torch.core.table import Table
from cudf_tpu_torch.frame.index import default_index
from cudf_tpu_torch.ops import copying
from cudf_tpu_torch.ops import datetime as dto
from cudf_tpu_torch.ops.join import _aligned_keys, _lex_searchsorted
from cudf_tpu_torch.ops.row_ops import lex_sort_permutation


def _on_values(col: Column) -> torch.Tensor:
    col = dto.days_as_seconds(col)
    return col.data.long() if col.dtype.is_temporal else col.data


def _tolerance(tolerance, col: Column):
    col = dto.days_as_seconds(col)
    if col.dtype.is_temporal:
        return to_ticks(tolerance, dt.unit_dtype("m", col.dtype.time_unit))
    return tolerance


def merge_asof(left, right, on: str, by: Optional[str] = None, direction: str = "backward",
               suffixes=("_x", "_y"), tolerance=None):
    from cudf_tpu_torch.frame.dataframe import DataFrame

    if direction not in ("backward", "forward", "nearest"):
        raise ValueError(f"direction {direction!r}")
    l_on, r_on = _on_values(left._table[on]), _on_values(right._table[on])
    if l_on.dtype != r_on.dtype:
        common = torch.promote_types(l_on.dtype, r_on.dtype)
        l_on, r_on = l_on.to(common), r_on.to(common)
    l_ops, r_ops = ([], []) if by is None else _aligned_keys([left._table[by]],
                                                             [right._table[by]])
    order = lex_sort_permutation([*r_ops, r_on])
    r_sorted = [op[order] for op in (*r_ops, r_on)]
    needles = [*l_ops, l_on]
    nr = r_on.shape[0]

    def same_group(pos):
        ok = (pos >= 0) & (pos < nr)
        safe = torch.clamp(pos, 0, max(nr - 1, 0))
        for h, nd in zip(r_sorted[:-1], needles[:-1]):
            ok &= h[safe] == nd
        return ok, safe

    on_sorted = r_sorted[-1]
    if direction != "forward":
        back, back_safe = same_group(_lex_searchsorted(r_sorted, needles, "right") - 1)
    if direction != "backward":
        fwd, fwd_safe = same_group(_lex_searchsorted(r_sorted, needles, "left"))
    if direction == "backward":
        found, pos = back, back_safe
    elif direction == "forward":
        found, pos = fwd, fwd_safe
    else:
        d_back = torch.where(back, l_on - on_sorted[back_safe], 0)
        d_fwd = torch.where(fwd, on_sorted[fwd_safe] - l_on, 0)
        take_back = back & (~fwd | (d_back <= d_fwd))
        found, pos = back | fwd, torch.where(take_back, back_safe, fwd_safe)
    if tolerance is not None:
        found = found & ((on_sorted[pos] - l_on).abs() <= _tolerance(tolerance,
                                                                     left._table[on]))
    ridx = torch.where(found, order[pos] if nr else pos, -1)

    out = {}
    shared = set(right._table.names) - {on, by}
    for n, c in left._table.items():
        out[f"{n}{suffixes[0]}" if n in shared else n] = c
    for n, c in right._table.items():
        if n in (on, by):
            continue
        out[f"{n}{suffixes[1]}" if n in left._table.names else n] = \
            copying.gather(c, ridx, bounds_check=True)
    return DataFrame._from(Table(out), default_index(left._table.num_rows))
