"""The LIST, STRUCT and decimal requests on the card: the list-returning
groupbys, ``explode`` and the ``list`` / ``struct`` accessors over
db-benchmark G1, ``str.split`` / ``str.findall`` into lists over G1's
``id3`` as text, and TPC-H's money columns as DECIMAL(15,2) through q1's
and q6's arithmetic, each beside a plain PyTorch version written apart
from the port.

- ``frames`` holds ``g1`` (G1's columns: ``id1`` DICTIONARY32 over
  "id001".."id100" in order, ``id4`` and ``id6`` int32 keys, ``v1`` in
  1..5, ``v2`` in 1..15, ``v3`` in [0, 100)) and ``id3s`` (``id3`` as
  12-byte text, ``models/strings_dt.py`` ``prepare``), or ``lineitem``
  (TPC-H's: ``l_extendedprice``, ``l_discount``, ``l_tax`` float64 money
  with two decimals, ``l_quantity`` 1..50).
- ``REQUESTS[name](frames)`` is the call a pandas user writes (a
  ``groupby().agg(list)``, ``.explode()``, a decimal ``astype``);
  ``ANSWERS[name](result, frames)`` and ``PLAIN[name](frames)`` give the
  same ``{key: tensor}``, compared exactly (``RTOL`` 0): a LIST result as
  its offsets and flat values, a STRING result as its bytes and offsets,
  a decimal as its unscaled int64 values.
- ``NEEDS[name]`` are the kernels of A-H a request launches: none (the
  list aggregations take the sort tier; the rest are elementwise ops,
  searches and sorts).  ``ROUTE[name]`` is "device" for all: no request
  takes a string host route or a ``HOST_ROUTES`` route.
- TPC-H types ``l_extendedprice``, ``l_discount`` and ``l_tax`` as
  DECIMAL(15,2) (spec §1.4): the requests cast them to decimal64 at scale
  -2 (half to even, ``torch.round`` of x * 100) and take q1's
  ``disc_price = price * (1 - discount)`` (scale -4) and
  ``charge = disc_price * (1 + tax)`` (scale -6), and q6's predicate; the
  plain versions are int64 arithmetic on ``round(x * 100)``.
"""

from __future__ import annotations

import decimal as _pydec

import torch

from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.ops import groupby as gb_ops

MONEY = dt.decimal_dtype(-2)                   # TPC-H DECIMAL(15,2)
K_ID1 = 100                                    # "id001".."id100"
V1_VALUES, V2_VALUES = 5, 15


# ----------------------------------------------------------------------
# answers
# ----------------------------------------------------------------------

def _list(col) -> dict:
    """A LIST column as its offsets and flat values (a STRING child as
    bytes and offsets)."""
    child = col.children[0]
    out = {"offsets": col.offsets}
    if child.dtype.is_string:
        out.update(chars=child.data, child_offsets=child.offsets)
    else:
        out["values"] = child.data
    return out


def _with_valid(out: dict, col) -> dict:
    """The validity under ``valid`` where the column has a null."""
    if col.validity is not None and not bool(col.validity.all()):
        out["valid"] = col.validity
    return out


def _text(col) -> dict:
    return _with_valid({"chars": col.data, "offsets": col.offsets}, col)


def _index_codes(series) -> torch.Tensor:
    """A groupby result's key labels as int64 (a dictionary key's codes)."""
    return series._index.column(series.device).data.long()


def _agg_list(res, frames) -> dict:
    return _list(res._column)


def _explode_pairs(res, frames) -> dict:
    """Exploded (id1, v1) rows as a count of each pair."""
    pair = _index_codes(res) * V1_VALUES + (res._column.data.long() - 1)
    return {"pairs": torch.bincount(pair, minlength=K_ID1 * V1_VALUES)}


def _values(res, frames) -> dict:
    return _with_valid({"values": res._column.data}, res._column)


def _histogram_counts(res, frames) -> dict:
    return {"keys": _index_codes(res), "counts": res._column.data}


def _topk_pairs(res, frames) -> dict:
    return {"keys": _index_codes(res), "values": res._column.data}


def _decimal(res, frames) -> dict:
    return {"values": res._column.data}


def _string(res, frames) -> dict:
    return _text(res._column)


# ----------------------------------------------------------------------
# requests
# ----------------------------------------------------------------------

def _money(frames, name):
    return frames["lineitem"][name].astype(MONEY)


def _disc_price(frames):
    return _money(frames, "l_extendedprice") * (1 - _money(frames, "l_discount"))


def _charge(frames):
    return _disc_price(frames) * (1 + _money(frames, "l_tax"))


def _q6_mask(frames):
    disc = _money(frames, "l_discount")
    qty = frames["lineitem"]["l_quantity"].astype(MONEY)
    return disc.between(_pydec.Decimal("0.05"), _pydec.Decimal("0.07")) & \
        (qty < _pydec.Decimal(24))


def _topk_exploded(frames):
    """G1 q8 (the two largest v3 of each id6) as ``group_topk(k=2)``, then
    ``explode``."""
    from cudf_tpu_torch.frame.index import Index
    from cudf_tpu_torch.frame.series import Series

    g1 = frames["g1"]
    grouper = gb_ops.make_grouper([g1._table["id6"]])
    keys = gb_ops.group_keys_table(g1._table.select(["id6"]), grouper).column(0)
    lists = gb_ops.group_topk(g1._table["v3"], grouper, 2)
    return Series._from(lists, Index(keys, name="id6"), "v3").explode()


REQUESTS = {
    "agg_list_id1": lambda f: f["g1"].groupby("id1")["v1"].agg(list),
    "agg_list_explode": lambda f: f["g1"].groupby("id1")["v1"].agg(list).explode(),
    "collect_set_id4": lambda f: f["g1"].groupby("id4")["v2"].agg("collect_set"),
    "collect_set_len": lambda f: f["g1"].groupby("id4")["v2"].agg("collect_set").list.len(),
    "histogram_counts": lambda f: f["g1"].groupby("id4")["v1"].agg("histogram").explode()
    .struct.field("count"),
    "topk2_id6": _topk_exploded,
    "split_len": lambda f: f["id3s"].str.split("d").list.len(),
    "split_last": lambda f: f["id3s"].str.split("d").list.get(-1),
    "findall_len": lambda f: f["id3s"].str.findall(r"[1-9]+").list.len(),
    "findall_last": lambda f: f["id3s"].str.findall(r"[1-9]+").list.get(-1),
    "money_cast": lambda f: _money(f, "l_extendedprice"),
    "q1_disc_price": _disc_price,
    "q1_charge": _charge,
    "q6_mask": lambda f: _q6_mask(f),
}

ANSWERS = {
    "agg_list_id1": _agg_list, "agg_list_explode": _explode_pairs,
    "collect_set_id4": _agg_list, "collect_set_len": _values,
    "histogram_counts": _histogram_counts, "topk2_id6": _topk_pairs,
    "split_len": _values, "split_last": _string, "findall_len": _values,
    "findall_last": _string, "money_cast": _decimal, "q1_disc_price": _decimal,
    "q1_charge": _decimal, "q6_mask": _values,
}


# ----------------------------------------------------------------------
# plain versions
# ----------------------------------------------------------------------

def _codes(frames, name) -> torch.Tensor:
    """A G1 key as int64 codes from 0: id1's dictionary codes (its keys are
    in order), id4 / id6 minus one."""
    col = frames["g1"]._table[name]
    return col.data.long() if col.dtype.is_dictionary else col.data.long() - 1


def plain_agg_list(frames) -> dict:
    """Each id1's v1 in row order: a stable sort of the codes."""
    codes = _codes(frames, "id1")
    order = torch.sort(codes, stable=True).indices
    lens = torch.bincount(codes, minlength=K_ID1)
    offsets = torch.zeros(K_ID1 + 1, dtype=torch.int64, device=codes.device)
    torch.cumsum(lens, 0, out=offsets[1:])
    return {"offsets": offsets, "values": frames["g1"]._table["v1"].data[order]}


def plain_explode_pairs(frames) -> dict:
    pair = _codes(frames, "id1") * V1_VALUES + (frames["g1"]._table["v1"].data.long() - 1)
    return {"pairs": torch.bincount(pair, minlength=K_ID1 * V1_VALUES)}


def _presence(frames, key, value, width):
    """[groups, width] counts of each (key, value) pair."""
    cell = _codes(frames, key) * width + (frames["g1"]._table[value].data.long() - 1)
    groups = int(_codes(frames, key).max()) + 1
    return torch.bincount(cell, minlength=groups * width).view(groups, width)


def plain_collect_set(frames) -> dict:
    seen = _presence(frames, "id4", "v2", V2_VALUES) > 0
    offsets = torch.zeros(seen.shape[0] + 1, dtype=torch.int64, device=seen.device)
    torch.cumsum(seen.sum(1), 0, out=offsets[1:])
    values = (torch.nonzero(seen.reshape(-1)).squeeze(1) % V2_VALUES + 1).int()
    return {"offsets": offsets, "values": values}


def plain_collect_set_len(frames) -> dict:
    return {"values": (_presence(frames, "id4", "v2", V2_VALUES) > 0).sum(1)}


def plain_histogram_counts(frames) -> dict:
    counts = _presence(frames, "id4", "v1", V1_VALUES).reshape(-1)
    cells = torch.nonzero(counts).squeeze(1)
    return {"keys": cells // V1_VALUES + 1, "counts": counts[cells]}


def plain_topk(frames) -> dict:
    """Each id6's two largest v3, largest first: a stable descending sort
    of v3, then a stable sort of id6, ranks < 2."""
    t = frames["g1"]._table
    perm = torch.sort(t["v3"].data, descending=True, stable=True).indices
    perm = perm[torch.sort(t["id6"].data[perm], stable=True).indices]
    ids = t["id6"].data[perm]
    pos = torch.arange(ids.numel(), device=ids.device)
    keep = pos - torch.searchsorted(ids, ids) < 2
    return {"keys": ids[keep].long(), "values": t["v3"].data[perm][keep]}


def _matrix(frames) -> torch.Tensor:
    """id3's text as a [rows, 12] byte matrix (every row is 12 bytes)."""
    text = frames["id3s"]._column
    return text.data.view(text.length, -1)


def _pieces_text(mat, start, stop) -> dict:
    """Rows' bytes [start, stop) of a fixed-width matrix as chars and offsets."""
    lens = stop - start
    offsets = torch.zeros(mat.shape[0] + 1, dtype=torch.int64, device=mat.device)
    torch.cumsum(lens, 0, out=offsets[1:])
    cols = torch.arange(mat.shape[1], device=mat.device)
    inside = (cols >= start[:, None]) & (cols < stop[:, None])
    return {"chars": mat[inside], "offsets": offsets}


def plain_split_len(frames) -> dict:
    return {"values": (_matrix(frames) == ord("d")).sum(1) + 1}


def plain_split_last(frames) -> dict:
    mat = _matrix(frames)
    width = mat.shape[1]
    cols = torch.arange(width, device=mat.device)
    last_d = torch.where(mat == ord("d"), cols, -1).max(1).values
    return _pieces_text(mat, last_d + 1, torch.full_like(last_d, width))


def _runs(mat):
    digit = (mat >= ord("1")) & (mat <= ord("9"))
    starts = digit.clone()
    starts[:, 1:] &= ~digit[:, :-1]
    return digit, starts


def plain_findall_len(frames) -> dict:
    _, starts = _runs(_matrix(frames))
    return {"values": starts.sum(1)}


def plain_findall_last(frames) -> dict:
    mat = _matrix(frames)
    digit, starts = _runs(mat)
    cols = torch.arange(mat.shape[1], device=mat.device)
    begin = torch.where(starts, cols, -1).max(1).values
    # the run ends at the first non-digit after its start (or the row's end)
    gap = ~digit & (cols > begin[:, None])
    end = torch.where(gap, cols, mat.shape[1]).min(1).values
    found = begin >= 0
    out = _pieces_text(mat, torch.where(found, begin, 0), torch.where(found, end, 0))
    if not bool(found.all()):
        out["valid"] = found
    return out


def _cents(frames, name) -> torch.Tensor:
    return torch.round(frames["lineitem"]._table[name].data * 100).long()


def plain_money(frames) -> dict:
    return {"values": _cents(frames, "l_extendedprice")}


def plain_disc_price(frames) -> dict:
    return {"values": _cents(frames, "l_extendedprice") * (100 - _cents(frames, "l_discount"))}


def plain_charge(frames) -> dict:
    return {"values": plain_disc_price(frames)["values"] * (100 + _cents(frames, "l_tax"))}


def plain_q6_mask(frames) -> dict:
    d = _cents(frames, "l_discount")
    return {"values": (d >= 5) & (d <= 7) & (_cents(frames, "l_quantity") < 2400)}


def float_q6_mask(frames) -> torch.Tensor:
    """q6's predicate on the float64 columns, as the float queries take it."""
    t = frames["lineitem"]._table
    d = t["l_discount"].data
    return (d >= 0.05) & (d <= 0.07) & (t["l_quantity"].data < 24)


PLAIN = {
    "agg_list_id1": plain_agg_list, "agg_list_explode": plain_explode_pairs,
    "collect_set_id4": plain_collect_set, "collect_set_len": plain_collect_set_len,
    "histogram_counts": plain_histogram_counts, "topk2_id6": plain_topk,
    "split_len": plain_split_len, "split_last": plain_split_last,
    "findall_len": plain_findall_len, "findall_last": plain_findall_last,
    "money_cast": plain_money, "q1_disc_price": plain_disc_price, "q1_charge": plain_charge,
    "q6_mask": plain_q6_mask,
}
NEEDS = {name: [] for name in REQUESTS}
RTOL = {name: 0.0 for name in REQUESTS}
ROUTE = {name: "device" for name in REQUESTS}
GROUPS = {
    "g1": [n for n in REQUESTS if not n.startswith(("money", "q1_", "q6_"))],
    "lineitem": [n for n in REQUESTS if n.startswith(("money", "q1_", "q6_"))],
}


def decimal128_product(charge, rows: int):
    """Two DECIMAL128 columns of ``rows`` charges (scale -6, about 1e11)
    multiplied in two limbs: products near 1e22 pass 2^63."""
    from cudf_tpu_torch.ops import decimal128 as d128
    from cudf_tpu_torch.ops.decimal import cast_to_decimal

    col = cast_to_decimal(charge._column, dt.decimal_dtype(-6, 128))
    a = type(col)(col.dtype, rows, col.data[:rows])
    b = type(col)(col.dtype, rows, col.data.flip(0)[:rows])
    return a, b, d128.binary128(a, b, "mul")
