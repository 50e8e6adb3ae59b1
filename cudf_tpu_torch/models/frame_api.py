"""The frame API's requests on the card: ``join`` in db-benchmark J1's
form, reshapes and UDFs over its G1 table, and the missing-data methods
over G1's columns with 5% nulls, each beside a plain PyTorch version
written apart from the port.

- ``REQUESTS[name](frames)`` is the call a pandas user writes, on the
  port's frames: ``frames`` holds J1's (``fact_<size>``, ``dim_<size>``:
  ``id`` int32 and ``v1`` / ``v2`` float64), G1's (``g1``: id1-id3
  dictionaries over "id001"... , id4, id5 in 1..100, id6 in 1..n/100, v1
  in 1..5, v2 in 1..15, v3 in [0, 100)) and ``nulls`` (G1's id4, id6, v1
  and v3, each null in 5% of rows, and v2 without nulls), with
  ``update`` (a Series of 1e6 labels of ``nulls``).
- ``ANSWERS[name](result, frames)`` and ``PLAIN[name](frames)`` give the
  same ``{key: tensor}``: a column's values (0 where null) and, where it
  has nulls, its validity under ``<key>_valid``; dictionary columns as
  their codes.
- ``NEEDS[name]`` are the kernels the request must launch, ``RTOL[name]``
  the float tolerance (sums 1e-12, means 1e-9; the rest exact) and
  ``ROUTE[name]`` the UDF route it must take (``frame/series.py``
  ``UDF_ROUTES``).
- ``GROUPS`` names the requests of each table.
"""

from __future__ import annotations

import torch

from cudf_tpu_torch.frame.reshape import concat, crosstab, get_dummies, melt, pivot_table
from cudf_tpu_torch.frame.tools import cut, qcut
from cudf_tpu_torch.models import g1

RADIX = ["digit_histogram", "tile_sort_data", "merge_scatter", "bucket_aggregate"]
ONEHOT = ["onehot_groupby_aggregate"]
PROBE = RADIX + ["window_probe"]
UPDATE_ROWS = 1_000_000
MAP_ROWS = 100_000


# ----------------------------------------------------------------------
# answers
# ----------------------------------------------------------------------

def _cv(key, col) -> dict:
    """A column as {key: values (0 where null), key_valid: validity}."""
    if col.validity is None or bool(col.validity.all()):
        return {key: col.data}
    return {key: torch.where(col.validity, col.data, torch.zeros_like(col.data)),
            f"{key}_valid": col.validity}


def _masked(key, data, valid) -> dict:
    """Plain values and their validity in ``_cv``'s form."""
    if bool(valid.all()):
        return {key: data}
    return {key: torch.where(valid, data, torch.zeros_like(data)), f"{key}_valid": valid}


def _frame(res) -> dict:
    out = {}
    for name, col in res._table.items():
        out.update(_cv(str(name), col))
    return out


def _indexed(res) -> dict:
    """A frame's index (its levels) and columns."""
    idx = res._index
    levels = idx._columns if hasattr(idx, "_columns") else (idx.column(res.device),)
    out = {f"index{i}": c.data for i, c in enumerate(levels)}
    out.update(_frame(res))
    return out


def _grid(res) -> dict:
    """A pivot's index keys, column keys and cells as one (columns x rows)
    tensor (with its validity when a cell is missing)."""
    cols = res._table.columns
    cells = torch.stack([c.data for c in cols])
    out = {"index": res._index.column(res.device).data,
           "columns": torch.tensor([int(n) for n in res._table.names], device=cells.device),
           "cells": cells}
    if any(c.validity is not None for c in cols):
        valid = torch.stack([c.validity if c.validity is not None else
                             torch.ones_like(c.data, dtype=torch.bool) for c in cols])
        out["cells"] = torch.where(valid, cells, torch.zeros_like(cells))
        out["cells_valid"] = valid
    return out


# ----------------------------------------------------------------------
# plain PyTorch
# ----------------------------------------------------------------------

def _first_groups(codes: torch.Tensor, G: int):
    """The codes that occur, by first appearance, and each row's group."""
    n = codes.numel()
    first = torch.full((G,), n, dtype=torch.int64, device=codes.device).scatter_reduce_(
        0, codes, torch.arange(n, device=codes.device), "amin")
    present = torch.nonzero(first < n).squeeze(1)
    groups = present[torch.argsort(first[present])]
    pos = torch.empty(G, dtype=torch.int64, device=codes.device)
    pos[groups] = torch.arange(groups.numel(), device=codes.device)
    return groups, pos[codes]


def _sum(codes, G, v):
    """index_add_ sums in int64 or float64; integer sums in v's own dtype
    when every one fits it (pandas 3)."""
    acc = torch.float64 if v.is_floating_point() else torch.int64
    s = torch.zeros(G, dtype=acc, device=v.device).index_add_(0, codes, v.to(acc))
    if not v.is_floating_point():
        info = torch.iinfo(v.dtype)
        if info.min <= int(s.min()) and int(s.max()) <= info.max:
            s = s.to(v.dtype)
    return s


def _sorted_present(codes, G):
    return torch.nonzero(torch.bincount(codes, minlength=G)).squeeze(1)


def _data(frames, table, name):
    return frames[table]._table[name].data


def _dense_join(lk, rk):
    """Per left row the right row of its key, -1 without one (the right
    keys unique, >= 1)."""
    tbl = torch.full((int(torch.maximum(lk.max(), rk.max())) + 1,), -1, dtype=torch.int64,
                     device=lk.device)
    tbl[rk.long()] = torch.arange(rk.numel(), device=lk.device)
    return tbl[lk.long()]


def plain_join(frames, size, how):
    lk, rk = _data(frames, f"fact_{size}", "id"), _data(frames, f"dim_{size}", "id")
    v1, v2 = _data(frames, f"fact_{size}", "v1"), _data(frames, f"dim_{size}", "v2")
    r = _dense_join(lk, rk)
    if how == "left":
        hit = r >= 0
        return {"index0": torch.arange(lk.numel(), device=lk.device), "id": lk, "v1": v1,
                **_masked("v2", v2[r.clamp(min=0)], hit)}
    li = torch.nonzero(r >= 0).squeeze(1)
    return {"index0": li, "id": lk[li], "v1": v1[li], "v2": v2[r[li]]}


def plain_index_join(frames, size):
    lk, rk = _data(frames, f"fact_{size}", "id"), _data(frames, f"dim_{size}", "id")
    r = _dense_join(lk, rk)
    li = torch.nonzero(r >= 0).squeeze(1)
    return {"index0": lk[li], "v1": _data(frames, f"fact_{size}", "v1")[li],
            "v2": _data(frames, f"dim_{size}", "v2")[r[li]]}


def plain_concat_q1(frames):
    """q1 over the two halves put back together: the halves' id1 codes
    and v1 appended, then sums by first appearance; and whether every
    appended column equals the table's."""
    df = frames["g1"]
    n = len(df)
    cat = {name: torch.cat([c.data[:n // 2], c.data[n // 2:]]) for name, c in df._table.items()}
    groups, gpos = _first_groups(cat["id1"].long(), df._table["id1"].keys.length)
    same = all(torch.equal(cat[name], c.data) for name, c in df._table.items())
    return {"id1": groups.int(), "v1": _sum(gpos, groups.numel(), cat["v1"]),
            "equal": torch.tensor([same])}


def plain_pivot_by(frames, key, values):
    g = frames["g1"]._table
    k = g[key]
    codes = k.data.long() if k.dtype.is_dictionary else k.data.long() - 1
    G = k.keys.length if k.dtype.is_dictionary else int(codes.max()) + 1
    present = _sorted_present(codes, G)
    out = {"index0": present.int() if k.dtype.is_dictionary else (present + 1).int()}
    for v in values:
        out[v] = _sum(codes, G, g[v].data)[present]
    return out


def plain_pivot_grid(frames, count=False):
    """mean v3 (or the row count) by (id4, id5) as a (id5 x id4) grid."""
    g = frames["g1"]._table
    r, c = g["id4"].data.long() - 1, g["id5"].data.long() - 1
    R, C = int(r.max()) + 1, int(c.max()) + 1
    cnt = torch.bincount(c * R + r, minlength=R * C)
    dev = cnt.device
    out = {"index": torch.arange(1, R + 1, dtype=torch.int32, device=dev),
           "columns": torch.arange(1, C + 1, device=dev)}
    if count:
        out["cells"] = cnt.view(C, R)
        return out
    sums = torch.zeros(R * C, dtype=torch.float64, device=dev).index_add_(
        0, c * R + r, g["v3"].data)
    cells, seen = (sums / cnt).view(C, R), (cnt > 0).view(C, R)
    out.update({"cells": cells} if bool(seen.all()) else _masked("cells", cells, seen))
    return out


def plain_melt(frames):
    g = frames["g1"]._table
    n = g["id6"].length
    names = ["v1", "v2", "v3"]
    return {"id6": g["id6"].data.repeat(3),
            "variable": torch.arange(3, dtype=torch.int32,
                                     device=g["id6"].device).repeat_interleave(n),
            "value": torch.cat([g[v].data.double() for v in names])}


def plain_dummies(frames):
    codes = frames["g1"]._table["id1"].data[:len(frames["g1"]) // 10].long()
    hot = codes[:, None] == torch.arange(100, device=codes.device)[None, :]
    return {str(i): hot[:, i] for i in range(100)}


def _edges_cut(x, edges, include_lowest=False):
    """Bin numbers of x over ascending edges, right-closed: torch.bucketize."""
    b = torch.bucketize(x, edges, right=False) - 1
    if include_lowest:
        b = torch.where(x == edges[0], 0, b)
    return b.int()


def plain_cut(frames, bins=10):
    v3 = frames["g1"]._table["v3"].data
    lo, hi = (float(t) for t in torch.aminmax(v3))
    edges = torch.linspace(0, 1, bins + 1, dtype=torch.float64, device=v3.device) * (hi - lo) \
        + lo
    edges[0] = lo - (hi - lo) * 0.001
    edges[-1] = hi
    return {"codes": _edges_cut(v3, edges), "categories": torch.tensor([bins])}


def plain_qcut(frames, q=4):
    v3 = frames["g1"]._table["v3"].data
    s = torch.sort(v3).values
    pos = torch.linspace(0, 1, q + 1, dtype=torch.float64, device=v3.device) * (v3.numel() - 1)
    lo, hi = pos.floor().long(), pos.ceil().long()
    edges = s[lo] + (pos - lo) * (s[hi] - s[lo])
    return {"codes": _edges_cut(v3, edges, include_lowest=True),
            "categories": torch.tensor([q])}


def _cut_answer(res, frames):
    c = res._column
    return {"codes": c.data, "categories": torch.tensor([c.keys.length])}


def plain_interpolate(frames):
    """Linear between the valid neighbours found by searchsorted over the
    valid positions; leading nulls stay, trailing take the last value."""
    c = frames["nulls"]._table["v3"]
    n = c.length
    pos = torch.arange(n, device=c.device)
    at = torch.nonzero(c.validity).squeeze(1)
    k = torch.searchsorted(at, pos, right=True)           # valid positions <= row
    prev = at[(k - 1).clamp(min=0)]
    nxt = at[k.clamp(max=at.numel() - 1)]
    has_prev, has_next = k > 0, k < at.numel()
    x = c.data
    inner = x[prev] + (x[nxt] - x[prev]) * (pos - prev).double() / (nxt - prev).clamp(
        min=1).double()
    vals = torch.where(c.validity, x, torch.where(has_next, inner, x[prev]))
    return _masked("v3", vals, c.validity | has_prev)


def plain_combine_first(frames):
    t = frames["nulls"]._table
    v3, v1 = t["v3"], t["v1"]
    vals = torch.where(v3.validity, v3.data, v1.data.double())
    return _masked("v3", vals, v3.validity | v1.validity)


def plain_update(frames):
    c = frames["nulls"]._table["v3"]
    other = frames["update"]
    labels, src = other._index.column(c.device).data, other._column
    ok = src.validity
    data, valid = c.data.clone(), c.validity.clone()
    data[labels[ok]] = src.data[ok]
    valid[labels[ok]] = True
    return _masked("v3", data, valid)


def plain_dropna_columns(frames):
    t = frames["nulls"]._table
    return {n: c.data for n, c in t.items() if c.validity is None or bool(c.validity.all())}


def plain_quantiles(frames):
    t = frames["nulls"]._table
    qs = torch.tensor([0.25, 0.5, 0.75], dtype=torch.float64)
    out = {}
    for name, c in t.items():
        x = c.data[c.validity] if c.validity is not None else c.data
        s = torch.sort(x.double()).values
        pos = qs.to(s.device) * (s.numel() - 1)
        lo, hi = pos.floor().long(), pos.ceil().long()
        out[name] = s[lo] + (pos - lo) * (s[hi] - s[lo])
    return out


def plain_row_max(frames):
    t = frames["nulls"]._table
    m = torch.stack([torch.where(t[n].validity, t[n].data.double(), float("-inf"))
                     if t[n].validity is not None else t[n].data.double()
                     for n in ("v1", "v3", "v2")], 1).max(1).values
    return {"max": m}


def plain_apply_masked(frames):
    c = frames["nulls"]._table["v3"]
    return _masked("v3", c.data * 2.0 + 1.0, c.validity)


# ----------------------------------------------------------------------
# the requests
# ----------------------------------------------------------------------

def _join_on(frames, size, how):
    return frames[f"fact_{size}"].join(frames[f"dim_{size}"].set_index("id"), on="id", how=how)


def _concat_q1(frames):
    df = frames["g1"]
    n = len(df)
    cat = concat([df.iloc[:n // 2], df.iloc[n // 2:]])
    return cat, g1.q1(cat)


def _concat_answer(res, frames):
    cat, q1 = res
    df = frames["g1"]
    same = cat.index.equals(df.index) and all(
        torch.equal(cat._table[nm].data, c.data) for nm, c in df._table.items())
    return {"id1": q1._table["id1"].data, "v1": q1._table["v1"].data,
            "equal": torch.tensor([same])}


def _update(frames):
    s = frames["nulls"]["v3"].copy(deep=False)
    s.update(frames["update"])
    return s


def _row_udf(r):
    return r["v1"] * r["v3"] + r["v2"]


def _pivot(**kw):
    return lambda frames: pivot_table(frames["g1"], **kw)


REQUESTS = {
    "join_inner_small": lambda f: _join_on(f, "small", "inner"),
    "join_inner_medium": lambda f: _join_on(f, "medium", "inner"),
    "join_inner_big": lambda f: _join_on(f, "big", "inner"),
    "join_left_big": lambda f: _join_on(f, "big", "left"),
    "join_index_medium": lambda f: f["fact_medium"].set_index("id").join(
        f["dim_medium"].set_index("id"), how="inner"),
    "concat_then_q1": _concat_q1,
    "pivot_table_id1": _pivot(values="v1", index="id1", aggfunc="sum"),
    "pivot_table_id6": _pivot(values=["v1", "v3"], index="id6", aggfunc="sum"),
    "pivot_table_id4_id5": _pivot(values="v3", index="id4", columns="id5", aggfunc="mean"),
    "crosstab_id4_id5": lambda f: crosstab(f["g1"]["id4"], f["g1"]["id5"]),
    "melt": lambda f: melt(f["g1"][["id6", "v1", "v2", "v3"]], id_vars="id6"),
    "get_dummies_id1_1e7": lambda f: get_dummies(f["g1"]["id1"].iloc[:len(f["g1"]) // 10]),
    "cut_v3_10": lambda f: cut(f["g1"]["v3"], 10),
    "qcut_v3_4": lambda f: qcut(f["g1"]["v3"], 4),
    "apply_v3": lambda f: f["g1"]["v3"].apply(lambda x: x * 2.0 + 1.0),
    "map_id4_dict": lambda f: f["g1"]["id4"].map({k: 1000 + k for k in range(1, 101)}),
    "apply_rows_v1_v2_v3": lambda f: f["g1"][["v1", "v2", "v3"]].apply(
        _row_udf, axis=1, engine="torch"),
    "map_id4_callable_1e5": lambda f: f["g1"]["id4"].iloc[:MAP_ROWS].map(lambda k: k * 3),
    "apply_masked_v3": lambda f: f["nulls"]["v3"].apply(lambda m: m * 2.0 + 1.0,
                                                        masked=True),
    "interpolate_v3": lambda f: f["nulls"]["v3"].interpolate(),
    "combine_first_v3_v1": lambda f: f["nulls"]["v3"].combine_first(f["nulls"]["v1"]),
    "update_1e6": _update,
    "dropna_columns": lambda f: f["nulls"].dropna(axis=1),
    "quantile_3": lambda f: f["nulls"].quantile([0.25, 0.5, 0.75]),
    "agg_max_rows": lambda f: f["nulls"][["v1", "v3", "v2"]].agg("max", axis=1),
}

ANSWERS = {
    **{f"join_{k}": (lambda r, f: _indexed(r)) for k in
       ("inner_small", "inner_medium", "inner_big", "left_big", "index_medium")},
    "concat_then_q1": _concat_answer,
    "pivot_table_id1": lambda r, f: {"index0": r._index.column(r.device).data,
                                     **_frame(r)},
    "pivot_table_id6": lambda r, f: {"index0": r._index.column(r.device).data,
                                     **_frame(r)},
    "pivot_table_id4_id5": lambda r, f: _grid(r),
    "crosstab_id4_id5": lambda r, f: _grid(r),
    "melt": lambda r, f: {"id6": r._table["id6"].data, "variable": r._table["variable"].data,
                          "value": r._table["value"].data},
    "get_dummies_id1_1e7": lambda r, f: {str(i): c.data for i, c in enumerate(
        r._table.columns)},
    "cut_v3_10": _cut_answer,
    "qcut_v3_4": _cut_answer,
    "apply_v3": lambda r, f: {"v3": r._column.data},
    "map_id4_dict": lambda r, f: _cv("id4", r._column),
    "apply_rows_v1_v2_v3": lambda r, f: {"row": r._column.data},
    "map_id4_callable_1e5": lambda r, f: {"id4": r._column.data},
    "apply_masked_v3": lambda r, f: _cv("v3", r._column),
    "interpolate_v3": lambda r, f: _cv("v3", r._column),
    "combine_first_v3_v1": lambda r, f: _cv("v3", r._column),
    "update_1e6": lambda r, f: _cv("v3", r._column),
    "dropna_columns": lambda r, f: {n: c.data for n, c in r._table.items()},
    "quantile_3": lambda r, f: {n: c.data for n, c in r._table.items()},
    "agg_max_rows": lambda r, f: {"max": r._column.data},
}

PLAIN = {
    "join_inner_small": lambda f: plain_join(f, "small", "inner"),
    "join_inner_medium": lambda f: plain_join(f, "medium", "inner"),
    "join_inner_big": lambda f: plain_join(f, "big", "inner"),
    "join_left_big": lambda f: plain_join(f, "big", "left"),
    "join_index_medium": lambda f: plain_index_join(f, "medium"),
    "concat_then_q1": plain_concat_q1,
    "pivot_table_id1": lambda f: plain_pivot_by(f, "id1", ["v1"]),
    "pivot_table_id6": lambda f: plain_pivot_by(f, "id6", ["v1", "v3"]),
    "pivot_table_id4_id5": plain_pivot_grid,
    "crosstab_id4_id5": lambda f: plain_pivot_grid(f, count=True),
    "melt": plain_melt,
    "get_dummies_id1_1e7": plain_dummies,
    "cut_v3_10": plain_cut,
    "qcut_v3_4": plain_qcut,
    "apply_v3": lambda f: {"v3": _data(f, "g1", "v3") * 2.0 + 1.0},
    "map_id4_dict": lambda f: {"id4": _data(f, "g1", "id4").long() + 1000},
    "apply_rows_v1_v2_v3": lambda f: {"row": _data(f, "g1", "v1") * _data(f, "g1", "v3")
                                      + _data(f, "g1", "v2")},
    "map_id4_callable_1e5": lambda f: {"id4": _data(f, "g1", "id4")[:MAP_ROWS].long() * 3},
    "apply_masked_v3": plain_apply_masked,
    "interpolate_v3": plain_interpolate,
    "combine_first_v3_v1": plain_combine_first,
    "update_1e6": plain_update,
    "dropna_columns": plain_dropna_columns,
    "quantile_3": plain_quantiles,
    "agg_max_rows": plain_row_max,
}

# what each request launches: an inner join what the same merge does (the
# build and, past one window, the partition of both sides; the probe),
# the pivots by one key the groupby tier of its cardinality (id1: one-hot
# A; id6: radix B, F, G, D); the left join, the two-key pivots and the
# rest no kernel
NEEDS = {name: [] for name in REQUESTS}
NEEDS.update({"join_inner_small": ["bucket_aggregate", "window_probe"],
              "join_inner_medium": PROBE, "join_inner_big": PROBE,
              "join_index_medium": PROBE, "concat_then_q1": ONEHOT,
              "pivot_table_id1": ONEHOT, "pivot_table_id6": RADIX})

RTOL = {name: 0.0 for name in REQUESTS}
RTOL.update({"pivot_table_id6": 1e-12, "pivot_table_id4_id5": 1e-9, "interpolate_v3": 1e-12,
             "quantile_3": 1e-12})

ROUTE = {"apply_v3": "vmap", "apply_rows_v1_v2_v3": "vmap", "apply_masked_v3": "vmap",
         "map_id4_callable_1e5": "host"}

GROUPS = {
    "j1": [n for n in REQUESTS if n.startswith("join")],
    "g1": ["concat_then_q1", "pivot_table_id1", "pivot_table_id6", "pivot_table_id4_id5",
           "crosstab_id4_id5", "melt", "get_dummies_id1_1e7", "cut_v3_10", "qcut_v3_4",
           "apply_v3", "map_id4_dict", "apply_rows_v1_v2_v3", "map_id4_callable_1e5"],
    "nulls": ["apply_masked_v3", "interpolate_v3", "combine_first_v3_v1", "update_1e6",
              "dropna_columns", "quantile_3", "agg_max_rows"],
}
