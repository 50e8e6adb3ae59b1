"""db-benchmark's groupby questions of the sort tier (q2, q6, q8, q9,
q10) in plain PyTorch, written apart from the port: group codes packed
from the key numbers, groups in order of first appearance
(``scatter_reduce_`` "amin" of row ids), sums by ``index_add_``, counts
by ``bincount``; medians from a stable sort within groups, std and corr
in two passes; q10 over two packed int64 keys with a stable sort.
Adapted from ``chip_smoke.py``'s ``plain_g1``.

``expected(q, data, real)`` gives {column: (values, valid or None)}: key
and integer columns as int64 numbers (a category as the number its key
spells), float columns as float64 computed in ``real`` (float64; the
check's control passes float32).
"""

from __future__ import annotations

import torch

X = "x"


def _first_groups(codes, G):
    """The codes in [0, G) that occur, in order of first appearance, and
    each row's position among them."""
    n, dev = codes.numel(), codes.device
    first = torch.full((G,), n, dtype=torch.int64, device=dev).scatter_reduce_(
        0, codes, torch.arange(n, device=dev), "amin")
    present = torch.nonzero(first < n).squeeze(1)
    groups = present[torch.argsort(first[present])]
    pos = torch.empty(G, dtype=torch.int64, device=dev)
    pos[groups] = torch.arange(groups.numel(), device=dev)
    return groups, pos[codes]


def _sums(gpos, G, v, real):
    acc = real if v.is_floating_point() else torch.int64
    return torch.zeros(G, dtype=acc, device=v.device).index_add_(0, gpos, v.to(acc))


def _counts(gpos, G):
    return torch.bincount(gpos, minlength=G)


def _out(cols):
    return {k: (v.double() if v.is_floating_point() else v.long(), valid)
            for k, (v, valid) in cols.items()}


def expected(q: str, data, real=torch.float64):
    K = int(data.config["K"])
    ids = {c: data.values(X, c) - 1 for c in ("id1", "id2", "id3", "id4", "id5", "id6")}
    K3 = int(data.config["N"]) // K
    t = data.tables[X]
    v1, v2, v3 = t["v1"], t["v2"], t["v3"].to(real)

    def by(*keys):
        """(groups, gpos) of the keys packed into one int64 code."""
        code, size = torch.zeros_like(ids["id1"]), 1
        for k in keys:
            span = K3 if k in ("id3", "id6") else K
            code, size = code * span + ids[k], size * span
        return _first_groups(code, size)

    def unpack(groups, *keys):
        out = {}
        for k in reversed(keys):
            span = K3 if k in ("id3", "id6") else K
            out[k] = (groups % span + 1, None)
            groups = groups // span
        return {k: out[k] for k in keys}

    if q == "q2":
        groups, gpos = by("id1", "id2")
        out = unpack(groups, "id1", "id2")
        out["v1"] = (_sums(gpos, groups.numel(), v1, real), None)
        return _out(out)
    if q == "q6":
        return _out(_q6(by, unpack, v3, real))
    if q == "q8":
        return _out(_q8(t["id6"], v3))
    if q == "q9":
        groups, gpos = by("id2", "id4")
        G = groups.numel()
        cnt = _counts(gpos, G)
        x, y = v1.to(real), v2.to(real)
        dx = x - (_sums(gpos, G, x, real) / cnt)[gpos]
        dy = y - (_sums(gpos, G, y, real) / cnt)[gpos]
        r = _sums(gpos, G, dx * dy, real) / torch.sqrt(
            _sums(gpos, G, dx * dx, real) * _sums(gpos, G, dy * dy, real))
        out = unpack(groups, "id2", "id4")
        out["value"] = (r * r, None)
        return _out(out)
    if q == "q10":
        return _out(_q10(ids, K, K3, v3, real))
    raise KeyError(q)


def _q6(by, unpack, v3, real):
    """median and std (ddof 1) of v3 by id4, id5."""
    groups, gpos = by("id4", "id5")
    G = groups.numel()
    n = gpos.numel()
    cnt = _counts(gpos, G)
    perm = torch.sort(v3, stable=True).indices
    perm = perm[torch.sort(gpos[perm], stable=True).indices]
    xs = v3[perm]
    starts = torch.cumsum(cnt, 0) - cnt
    lo = (starts + (cnt - 1).clamp(min=0) // 2).clamp(max=n - 1)
    hi = (starts + cnt // 2).clamp(max=n - 1)
    median = (xs[lo] + xs[hi]) / 2
    mean = _sums(gpos, G, v3, real) / cnt.clamp(min=1)
    d = v3 - mean[gpos]
    std = torch.sqrt(_sums(gpos, G, d * d, real) / (cnt - 1).clamp(min=1))
    out = unpack(groups, "id4", "id5")
    out["v3_median"] = (median, cnt > 0)
    out["v3_std"] = (std, cnt > 1)
    return out


def _q8(id6, v3):
    """The two largest v3 of each id6, in the order of a stable descending
    sort of v3, with their row labels."""
    perm = torch.sort(v3, descending=True, stable=True).indices
    s_ids = id6[perm]
    p2 = torch.sort(s_ids, stable=True).indices
    s = s_ids[p2]
    pos = torch.arange(s.numel(), device=s.device)
    rank = pos - torch.searchsorted(s, s)             # each run's first position
    keep = torch.zeros(s.numel(), dtype=torch.bool, device=s.device)
    keep[p2] = rank < 2
    rows = perm[torch.nonzero(keep).squeeze(1)]
    return {"index": (rows, None), "id6": (id6[rows], None), "v3": (v3[rows], None)}


def _q10(ids, K, K3, v3, real):
    """sum v3 and count by all six ids, over two packed int64 keys."""
    k1 = (ids["id1"] * K + ids["id2"]) * K3 + ids["id3"]
    k2 = (ids["id4"] * K + ids["id5"]) * K3 + ids["id6"]
    perm = torch.sort(k2, stable=True).indices
    perm = perm[torch.sort(k1[perm], stable=True).indices]
    s1, s2 = k1[perm], k2[perm]
    new = torch.ones_like(s1, dtype=torch.bool)
    new[1:] = (s1[1:] != s1[:-1]) | (s2[1:] != s2[:-1])
    run = torch.cumsum(new, 0) - 1
    starts = torch.nonzero(new).squeeze(1)
    first_row = perm[starts]                  # stable: each run's first row
    order = torch.argsort(first_row)          # groups by first appearance
    G = starts.numel()
    gpos = torch.empty_like(run)
    gpos[perm] = run
    rank = torch.empty_like(order)
    rank[order] = torch.arange(G, device=order.device)
    gpos = rank[gpos]
    a, b = k1[first_row[order]], k2[first_row[order]]
    return {"id1": (a // (K * K3) + 1, None), "id2": (a // K3 % K + 1, None),
            "id3": (a % K3 + 1, None), "id4": (b // (K * K3) + 1, None),
            "id5": (b // K3 % K + 1, None), "id6": (b % K3 + 1, None),
            "v3": (_sums(gpos, G, v3, real), None), "v1": (_counts(gpos, G), None)}
