"""db-benchmark's join questions in plain PyTorch, written apart from the
port: the pairs of an inner or left join on one key column (a dense table
when the right keys are distinct, else a stable sort, ``searchsorted``
and ``repeat_interleave``), in left-row order with right-row order
inside, as pandas gives them; then every column of both sides gathered
through them.  Adapted from ``chip_smoke.py``'s ``plain_join``.

``expected(q, data, real)`` gives {column: callable} in pandas' column
order; each call gives (values, valid or None): integer and category
columns as int64 numbers (a category as the number its key spells),
floats as float64 after a round trip through ``real`` (float64; the
check's control passes float32).  A category key joins as its numbers,
which its strings ("id" + number) stand for one to one.
"""

from __future__ import annotations

import torch

# (right frame, key, how) of each question
JOINS = {"q1": ("small", "id1", "inner"), "q2": ("medium", "id2", "inner"),
         "q3": ("medium", "id2", "left"), "q4": ("medium", "id5", "inner"),
         "q5": ("big", "id3", "inner")}


def pairs(lk: torch.Tensor, rk: torch.Tensor, how: str):
    """(li, ri) int64: ri -1 where a left row (``how="left"``) finds none."""
    dev = lk.device
    hi = int(torch.maximum(lk.max(), rk.max())) + 1
    if torch.unique(rk).numel() == rk.numel():
        tbl = torch.full((hi,), -1, dtype=torch.int64, device=dev)
        tbl[rk] = torch.arange(rk.numel(), device=dev)
        r = tbl[lk]
        if how == "left":
            return torch.arange(lk.numel(), device=dev), r
        li = torch.nonzero(r >= 0).squeeze(1)
        return li, r[li]
    sk, perm = torch.sort(rk, stable=True)
    lo = torch.searchsorted(sk, lk)
    found = torch.searchsorted(sk, lk, right=True) - lo
    cnt = found.clamp(min=1) if how == "left" else found
    M = int(cnt.sum())

    def rep(t):
        return torch.repeat_interleave(t, cnt, output_size=M)

    li = rep(torch.arange(lk.numel(), device=dev))
    within = torch.arange(M, device=dev) - rep(torch.cumsum(cnt, 0) - cnt)
    ri = perm[(rep(lo) + within).clamp(max=rk.numel() - 1)]
    return li, torch.where(within < rep(found), ri, -1)


def expected(q: str, data, real=torch.float64):
    right, on, how = JOINS[q]
    li, ri = pairs(data.values("x", on), data.values(right, on), how)
    lcols, rcols = list(data.tables["x"]), list(data.tables[right])

    def column(frame, c, rows):
        def get():
            t = data.tables[frame][c]
            if t.is_floating_point():
                v = t.to(real).double()[rows.clamp(min=0)]
            else:
                v = data.values(frame, c)[rows.clamp(min=0)]
            return v, None if frame == "x" or how == "inner" else rows >= 0
        return get

    out = {}
    for c in lcols:
        out[c if c == on or c not in rcols else f"{c}_x"] = column("x", c, li)
    for c in rcols:
        if c != on:
            out[c if c not in lcols else f"{c}_y"] = column(right, c, ri)
    return out
