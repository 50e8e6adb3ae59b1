"""The comparison that decides ``correct``: a question's answer, as the
timed path produced it, against the plain reference.

The answers kept for the check stay on the device until the window has
closed (``columns``); then each column is read on its own (``decode``:
a category as the number its key spells) and compared with the
reference's.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from portbench.datagen.common import parse_ids


def _name(n) -> str:
    return "_".join(str(p) for p in n if p != "") if isinstance(n, tuple) else str(n)


def columns(res, index_levels: int = 0) -> List[tuple]:
    """[(name, port Column)] of a DataFrame or Series answer: its first
    ``index_levels`` index levels, then its columns (a Series' values as
    "value")."""
    cols = []
    if index_levels:
        idx = res.index
        levels = list(getattr(idx, "_columns", None) or [idx.column()])
        names = list(getattr(idx, "names", None) or [None] * len(levels))
        for i in range(index_levels):
            if i >= len(levels):                # too few levels: the names will differ
                cols.append((f"missing_index{i}", None))
                continue
            name = names[i] if i < len(names) and names[i] is not None else \
                "index" if i == 0 else f"index{i}"
            cols.append((name, levels[i]))
    if hasattr(res, "_table"):
        cols += [(_name(n), res._table[n]) for n in res._table.names]
    else:
        cols.append(("value", res._column))
    return cols


def decode(col, device, keys_cache: Dict[int, torch.Tensor]):
    """(values, valid) of one answer column on ``device``: integers as
    int64, floats as float64, "id<n>" strings as n.  A column is a port
    Column or, for the control, a (values, valid) pair."""
    if isinstance(col, tuple):
        data, valid = col
    else:
        data, valid = col.data, col.validity
        if col.dtype.is_dictionary:
            keys = col.keys
            if id(keys) not in keys_cache:
                keys_cache[id(keys)] = parse_ids(keys.data, keys.offsets)
            table = keys_cache[id(keys)]
            codes = data.long().clamp(0, max(table.numel() - 1, 0))
            data = table[codes] if table.numel() else codes
        elif col.dtype.is_string:
            data = parse_ids(data, col.offsets)
    data = data.to(device)
    valid = None if valid is None else valid.to(device)
    return (data.double() if data.is_floating_point() else data.long()), valid


def compare(q: str, expected: dict, answer: List[tuple], device,
            keys_cache: Dict[int, torch.Tensor]) -> Dict[str, float]:
    """{"<q>.mismatch": rows that differ, "<q>.<column>.gap": ...}: a row
    differs where a key, label, count or integer column, or whether a
    value is missing (null or NaN), differs; a float column's gap is its
    largest difference over the reference's largest magnitude."""
    names = [n for n, _ in answer]
    out = {}
    if names != list(expected):
        return {f"{q}.mismatch": math.inf}
    bad_rows = None
    for name, col in answer:
        want = expected[name]
        want, want_valid = want() if callable(want) else want
        got, got_valid = decode(col, device, keys_cache)
        if got.numel() != want.numel():
            return {f"{q}.mismatch": float(abs(got.numel() - want.numel()))}
        miss_w = _missing(want, want_valid)
        miss_g = _missing(got, got_valid)
        differ = miss_w != miss_g
        both = ~miss_w & ~miss_g
        if want.is_floating_point():
            g = got.double()
            gap = (g[both] - want[both]).abs().max() if bool(both.any()) else torch.tensor(0.0)
            scale = want[~miss_w].abs().max() if bool((~miss_w).any()) else torch.tensor(0.0)
            out[f"{q}.{name}.gap"] = float(gap / scale) if float(scale) > 0 else float(gap)
        else:
            differ |= both & (got != want)
        bad_rows = differ if bad_rows is None else bad_rows | differ
        del got, want, miss_w, miss_g, both
    out[f"{q}.mismatch"] = float(bad_rows.sum()) if bad_rows is not None else 0.0
    return out


def _missing(v, valid):
    miss = torch.zeros(v.shape, dtype=torch.bool, device=v.device) if valid is None else ~valid
    return miss | torch.isnan(v) if v.is_floating_point() else miss


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict]:
    """(every number within its limit, and none without one; {name:
    [number, limit]} in the limits' order, then any number without a
    limit beside None)."""
    shown, ok = {}, True
    for name, limit in limits.items():
        if name not in numbers:
            continue
        v = numbers[name]
        shown[name] = [v, limit]
        ok &= v <= limit
    unknown = [n for n in numbers if n not in limits]
    if unknown:
        ok = False
        for n in unknown:
            shown[n] = [numbers[n], None]
    return ok, shown
