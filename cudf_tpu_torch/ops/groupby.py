"""Groupby aggregation: the kernel tiers, then the sort tier.

Port of ``cudf_tpu/ops/groupby.py``.  ``groupby_agg`` tries the kernel
tiers first (``_try_onehot_fast_path``, the dispatch of ``:862-1061``).
One integer key column is reduced to int32 codes ``key - key_min`` over
K = max - min + 1 slots, and a dictionary key column's codes serve as
they are, over K = its number of entries (its output key is then the
observed entries' keys, as in the reference):

- K <= 4096: the one-hot tier, kernel A
  (``kernels/hash_aggregate.py``);
- K <= 2^27: the radix tier, kernels B, F, G and D
  (``kernels/radix_partition.py``); min/max there are a plain
  ``scatter_reduce_``, as the reference leaves them to XLA.

The kernel tiers give the observed groups in ascending key order; they
serve sum/count/mean/min/max/size of numeric (not uint64) and bool
values whose float columns hold no NaN under sum/count/mean.

Every other request takes the sort tier: ``make_grouper`` sorts the key
rows (``ops/row_ops.py``'s LSD chain of stable argsorts) into runs, one
a group, in ascending key order with a null group last, and each
aggregation reduces over the dense group ids with ``index_add_`` or
``scatter_reduce_`` (Hopper has atomics; the reference's scatter-free
prefix-sum differences and reset scans are a TPU workaround, and a
prefix-sum difference loses the precision of a large running sum).
Medians, quantiles, nunique and idxmin/idxmax sort by (group, value).
These are PyTorch library calls: the sort tier reaches none of the
kernels A-H, as the reference's reaches no Pallas kernel.

``transform_kernel_tier`` serves a groupby transform of
sum/count/mean/min/max/size on the same tiers: the K-slot results, read
before they are compacted, are gathered back by each row's code; no
grouper sort is built.  The rest of the family runs on the sort tier:
sum_of_squares, m2 and bitwise_and/or/xor (in ``_AGG_DISPATCH``), and the
two-column ``group_cov``/``group_corr`` and the per-row ``group_ewma``,
which the frame layer calls by name.  cov and corr take two passes (the
group means by ``index_add_``, gathered back by group id, then the
centred sums), never the reference's one-pass ``sxy - sx*sy/n``, which
cancels catastrophically for values far from zero.  The bitwise
aggregations take a segmented doubling scan over the values sorted by
group (log2 of the largest group's size passes of a shift, a compare and
a select, then each run's last row): PyTorch has no bitwise
``scatter_reduce_``, and per-bit counts would take one ``index_add_``
pass a bit (64 for int64).  The aggregations that return LIST columns
(``group_collect_list``, ``group_unique``, ``group_collect_set``,
``group_topk``, ``group_histogram``) sort the kept rows by (group, value)
with the same LSD chain, mark where each distinct (group, value) run
starts, and gather; ``group_tdigest`` sorts the same way and sums each
group's centroids by ``index_add_`` (a STRUCT of a LIST of centroids and
the min and max).

Both tiers give pandas' dtypes and nulls.  Integer and bool sums are
exact (int64 accumulation); an integer column's sum and prod come back
in its own dtype when every result fits, else int64 (uint64 for
unsigned), as pandas does.  Float sums are taken in float64; a float32
column's sum, mean, var, std and median come back in float32.  A group
whose values are all null gives a null mean, min, max, first, last and
median, a sum of 0 and a count of 0.  min/max skip NaN on every tier;
the sort tier treats NaN as null throughout, as pandas does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
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
from cudf_tpu_torch.ops.row_ops import (_float_to_ordered_int, equality_keys,
                                        lex_sort_permutation, order_keys, sort_operands)
from cudf_tpu_torch.ops.stream_compaction import filter_indices
from cudf_tpu_torch.utils.config import get_option
from cudf_tpu_torch.utils import tracing

SUPPORTED_AGGS = frozenset({"sum", "count", "mean", "min", "max", "size"})

Request = Tuple[object, Column, str]


def _not_ported(agg: str) -> NotImplementedError:
    if agg == "topk":
        return NotImplementedError(
            "groupby agg 'topk' takes k: call ops.groupby.group_topk(col, grouper, k)")
    return NotImplementedError(
        f"groupby agg {agg!r} is not an aggregation of one column (cov, corr and ewm are "
        "the groupby's own methods; ROADMAP.md queue 1 lists what the port lacks); the sort "
        f"tier serves {', '.join(sorted(_AGG_DISPATCH))}")


# ----------------------------------------------------------------------
# pandas' result dtypes
# ----------------------------------------------------------------------

def _float_out(dtype: dt.DType) -> dt.DType:
    """float32 stays float32; everything else gives float64."""
    return dt.FLOAT32 if dtype == dt.FLOAT32 else dt.FLOAT64


def _fit_int(col: Column, in_dtype: dt.DType) -> Column:
    """One integer result in pandas' dtype (see ``_fit_int_results``)."""
    res = {0: col}
    _fit_int_results(res, {0: in_dtype})
    return res[0]


def _fit_int_results(results: Dict[object, Column], in_dtypes: Dict[object, dt.DType]) -> None:
    """pandas' dtype for integer sums, prods and cumsums, in place: the
    input's own dtype when every value fits it, else int64 (uint64 for an
    unsigned input).  ``results`` hold int64 (two's-complement) values;
    one host sync for all of them."""
    todo = [(name, d) for name, d in in_dtypes.items()
            if d.is_integer and d not in (dt.INT64,)]
    if not todo:
        return
    ranges = []
    for name, _ in todo:
        c = results[name]
        v = c.data if c.validity is None else torch.where(c.validity, c.data, 0)
        ranges.append(torch.stack([v.min(), v.max()]) if v.numel() else
                      torch.zeros(2, dtype=torch.int64, device=v.device))
    bounds = tracing.tolist(torch.stack(ranges), "int_fit")
    for (name, d), (lo, hi) in zip(todo, bounds):
        c = results[name]
        info = np.iinfo(d.storage)
        if d != dt.UINT64 and int(info.min) <= lo and hi <= int(info.max):
            results[name] = Column(d, c.length, c.data.to(d.torch_storage), c.validity)
        elif d.is_unsigned_integer:
            results[name] = Column(dt.UINT64, c.length, c.data.view(torch.uint64), c.validity)


# ----------------------------------------------------------------------
# the kernel tiers
# ----------------------------------------------------------------------

def _key_range(key: Column, valid: Optional[torch.Tensor],
               nan_cols: Sequence[Column] = ()) -> Tuple[int, int, bool]:
    """(min, max) over the rows that form groups ((0, -1) when none do),
    and whether the valid rows of ``nan_cols`` may hold a NaN: one host
    sync.  A column's sum over its valid rows is NaN when one of them is
    (and when +inf meets -inf: those requests take the sort tier too)."""
    if key.length == 0:
        return 0, -1, False
    data = key.data if key.dtype.is_signed_integer else key.data.long()
    if valid is None:
        lo, hi = torch.aminmax(data)
        n = tracing.synced("key_range", data, torch.tensor, key.length, device=data.device)
    else:
        info = torch.iinfo(data.dtype)
        lo = torch.where(valid, data, info.max).min()
        hi = torch.where(valid, data, info.min).max()
        n = valid.sum()
    flags = _nan_flags(nan_cols)
    lo, hi, n, *nan = tracing.tolist(torch.stack([lo.long(), hi.long(), n.long(),
                                                  *[f.long() for f in flags]]), "key_range")
    if n == 0:
        return 0, -1, any(nan)
    return lo, hi, any(nan)


def _kernel_codes(keys: Table, values: Sequence[Request], dropna: bool):
    """(key, int32 codes, K, key_lo, valid) when the kernel tiers serve
    the request, else None (the sort tier then serves it)."""
    if not get_option("groupby.onehot_fast_path"):
        return None
    key = keys.column(0) if keys.num_columns == 1 else None
    if key is None or key.length < int(get_option("groupby.fast_path_min_rows")):
        return None
    if not (key.dtype.is_integer or key.dtype.is_dictionary) or key.dtype == dt.UINT64:
        return None
    if key.has_nulls and not dropna:
        return None          # the null-key group is the sort tier's
    nan_cols: Dict[int, Column] = {}
    for _, col, agg in values:
        if agg not in SUPPORTED_AGGS or not (col.dtype.is_numeric or col.dtype.is_bool):
            return None
        if col.dtype == dt.UINT64:
            return None      # the kernels take no uint64 values
        if col.dtype.is_float and agg in ("sum", "count", "mean"):
            nan_cols[id(col)] = col   # pandas skips NaN there: the sort tier does
    valid = key.validity if dropna else None
    if key.dtype.is_dictionary:
        # the codes are the key, over K = the dictionary's entries (the
        # reference's ``:892-895``); a null code's row is masked out
        K = key.keys.length
        if K == 0 or K > 1 << MAX_DOMAIN_BITS or _may_hold_nan(nan_cols.values()):
            return None
        return key, key.data, K, 0, valid
    lo, hi, has_nan = _key_range(key, valid, list(nan_cols.values()))
    if has_nan:
        return None
    K = max(hi - lo + 1, 1)
    if K > 1 << MAX_DOMAIN_BITS:
        return None
    src = key.data if key.dtype.is_signed_integer else key.data.long()
    return key, (src - lo).to(torch.int32), K, lo, valid


@tracing.annotate("groupby.onehot_fast_path", "ops")
def _try_onehot_fast_path(keys: Table, values: Sequence[Request], dropna: bool,
                          dictionary_codes: bool = False,
                          first_appearance: bool = False) -> Optional[Tuple[Table, Table]]:
    """(group keys, aggregations) from the kernel tiers, or None when the
    request is outside them.  Groups come in ascending key order, or with
    ``first_appearance`` in order of each one's first row (pandas'
    sort=False).  A dictionary key comes back as the observed entries'
    keys (the reference's form), or with ``dictionary_codes`` as a
    dictionary column of their codes (pandas' categorical, observed=True)."""
    req = _kernel_codes(keys, values, dropna)
    if req is None:
        return None
    key, codes, K, key_lo, valid = req
    results, occupied = _slot_results(codes, K, valid, list(values))
    present = filter_indices(occupied > 0)
    if first_appearance:
        present = present[torch.argsort(_first_rows(codes, K, valid, present))]
    compact = {n: copying.gather(c, present, bounds_check=False) for n, c in results.items()}
    _fit_int_results(compact, {name: col.dtype for name, col, agg in values if agg == "sum"})
    if key.dtype.is_dictionary:
        key_col = Column.from_dictionary(present, key.keys) if dictionary_codes else \
            copying.gather(key.keys, present, bounds_check=False)
    else:
        key_col = Column(key.dtype, present.shape[0],
                         (present + key_lo).to(key.dtype.torch_storage))
    return Table({keys.names[0]: key_col}), Table(compact)


def _first_rows(codes: torch.Tensor, K: int, valid: Optional[torch.Tensor],
                present: torch.Tensor) -> torch.Tensor:
    """Each present slot's first row with a valid key: scatter_reduce_
    "amin" of row ids over a prefix of the rows that grows eightfold until
    every present slot has its row there (keys drawn at random meet every
    group early; the whole column at worst).  A scatter over every row puts
    all of them on the K slots' addresses: 1e8 rows on 100 slots take ~60
    ms of contention on an H100, a 65536-row prefix a fraction of one.
    One host sync a round."""
    n = codes.shape[0]
    p = min(n, 1 << 16)
    while True:
        c = codes[:p].long()
        if valid is not None:
            c = torch.where(valid[:p], c, K)
        first = torch.full((K + 1,), n, dtype=torch.int64, device=codes.device)
        first.scatter_reduce_(0, c, torch.arange(p, device=codes.device), "amin")
        rows = first[present]
        if p == n or tracing.to_bool((rows < n).all(), "first_rows"):
            return rows
        p = min(n, p * 8)


@tracing.annotate("groupby.transform_kernel_tier", "ops")
def transform_kernel_tier(key: Column, values: Sequence[Request],
                          dropna: bool = True) -> Optional[Dict[object, Column]]:
    """A groupby transform on the kernel tiers: {name: one value a row},
    each row its group's result (null where the row's key is null), or
    None when the request is outside the tiers.  The K-slot results are
    gathered by each row's code before any compaction: no grouper sort."""
    values = list(values)
    req = _kernel_codes(Table({"__key__": key}), values, dropna)
    if req is None:
        return None
    _, codes, K, _, valid = req
    results, _ = _slot_results(codes, K, valid, values)
    _fit_int_results(results, {name: col.dtype for name, col, agg in values if agg == "sum"})
    rows = (codes if valid is None else torch.where(valid, codes, 0)).long()
    out = {}
    for name, col in results.items():
        spread = copying.gather(col, rows, bounds_check=False)
        out[name] = spread.with_validity(bm.and_masks(spread.validity, valid))
    return out


def _nan_flags(cols) -> List[torch.Tensor]:
    """A flag a column: whether the sum of its valid rows is NaN (one of
    them is NaN, or +inf meets -inf)."""
    return [torch.isnan((c.data if c.validity is None
                         else torch.where(c.validity, c.data, 0)).sum()) for c in cols]


def _may_hold_nan(cols) -> bool:
    """``_nan_flags`` read in one host sync (none without a column)."""
    flags = _nan_flags(cols)
    return tracing.to_bool(torch.stack(flags).any(), "nan_check") if flags else False


def _slot_results(codes: torch.Tensor, K: int, valid: Optional[torch.Tensor],
                  values: List[Request]) -> Tuple[Dict[object, Column], torch.Tensor]:
    """({name: its result in each of the K slots}, each slot's count of
    rows with a valid key) on the one-hot or the radix tier."""
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
        _run_onehot(codes, K, runs)
    occupied = next(r["out"][1] for r in runs.values() if r["mask"] is valid)

    results: Dict[object, Column] = {}
    for name, col, agg in values:
        mask = valid if agg == "size" else masks[id(col)]
        s, c, mn, mx = runs[(id(col), id(mask))]["out"]
        # float32 values: summed in float64, returned in float32 as pandas does
        float_dt = dt.FLOAT32 if col.dtype == dt.FLOAT32 else dt.FLOAT64
        if agg == "sum":
            out_dt = float_dt if s.dtype == torch.float64 else dt.INT64
            results[name] = Column(out_dt, K, s.to(out_dt.torch_storage))
        elif agg in ("count", "size"):
            results[name] = Column(dt.INT64, K, c)
        elif agg == "mean":
            mean = s.double() / c.clamp(min=1)
            results[name] = Column(float_dt, K, mean.to(float_dt.torch_storage), c > 0)
        else:
            results[name] = Column(col.dtype, K, mn if agg == "min" else mx, c > 0)
    return results, occupied


def _by_mask(runs: Dict[Tuple, dict]) -> List[List[dict]]:
    """The runs grouped by the mask they aggregate under."""
    by_mask: Dict[int, List[dict]] = {}
    for run in runs.values():
        by_mask.setdefault(id(run["mask"]), []).append(run)
    return list(by_mask.values())


def _run_onehot(codes: torch.Tensor, K: int, runs: Dict[Tuple, dict]) -> None:
    """Fill run["out"] = (sums, counts, mins, maxs) on the one-hot tier:
    one kernel A call a mask, over all the columns aggregated under it."""
    for group in _by_mask(runs):
        sums, counts, mins, maxs = onehot_groupby_aggregate(
            codes, [r["col"].data for r in group], K, valid=group[0]["mask"],
            with_minmax=[r["minmax"] for r in group])
        for j, run in enumerate(group):
            run["out"] = (sums[j], counts, mins[j], maxs[j])


def _run_radix(codes: torch.Tensor, K: int, runs: Dict[Tuple, dict]) -> None:
    """Fill run["out"] = (sums, counts, mins, maxs) on the radix tier:
    runs that share a mask share one partition of the keys."""
    for group in _by_mask(runs):
        mask = group[0]["mask"]
        k_in = codes if mask is None else torch.where(mask, codes, -1)
        sums, counts = radix_groupby_sum_count(
            k_in, [r["col"].data for r in group], K)
        for run, s in zip(group, sums):
            mn = mx = None
            if run["minmax"]:
                mn, mx = _segment_minmax(k_in, run["col"].data, K, mask is not None)
            run["out"] = (s, counts, mn, mx)


def _segment_minmax(k_in: torch.Tensor, vals: torch.Tensor, K: int, masked: bool):
    """Per-group min and max in vals' dtype, skipping NaN as kernel A
    does (plain scatter_reduce_; an empty group's entries are masked by
    its zero count).  Masked-out rows (code -1) are left out."""
    kv, _, _ = _build.kernel_values(vals)
    if masked:
        keep = filter_indices(k_in >= 0)
        k_in, kv = k_in[keep], kv[keep]
    mins, maxs = segment_minmax_plain(k_in.long(), kv, K)
    return mins.to(vals.dtype), maxs.to(vals.dtype)


# ----------------------------------------------------------------------
# the sort tier: the grouper
# ----------------------------------------------------------------------

@dataclass
class Grouper:
    """The groups of the kept rows (sort::sort_groupby_helper): group ids,
    the stable sort by key, and each group's run in it.  Every index but
    ``kept_rows`` counts kept rows (the rows left after dropna drops
    null and NaN keys), as in the reference."""

    group_ids: torch.Tensor        # int64[n] dense group id a kept row
    num_groups: int
    key_rows: torch.Tensor         # int64[g] each group's first kept row
    sorted_order: torch.Tensor     # int64[n] the stable sort of the kept rows by key
    group_offsets: torch.Tensor    # int64[g + 1] each group's run in sorted order
    row_mask: Optional[torch.Tensor] = None   # bool[frame rows], None: every row kept
    kept_rows: Optional[torch.Tensor] = None  # int64[n] the frame row of each kept row
    sorted_group_ids: Optional[torch.Tensor] = None   # group_ids[sorted_order]

    def frame_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """Kept-row indices as frame rows."""
        return rows if self.kept_rows is None else self.kept_rows[rows]


def _empty_grouper(device, row_mask=None) -> Grouper:
    z = torch.zeros(0, dtype=torch.int64, device=device)
    return Grouper(z, 0, z, z, torch.zeros(1, dtype=torch.int64, device=device),
                   row_mask, None if row_mask is None else z, z)


@tracing.annotate("groupby.make_grouper", "ops")
def make_grouper(keys: Sequence[Column], dropna: bool = True) -> Grouper:
    """Group the rows of the key columns.  Groups are numbered in
    ascending key order (lexicographic over the keys), a null key after
    every value; with dropna, rows with a null or NaN key are left out.
    One host sync (the group count and, under dropna, the kept-row
    count)."""
    keys = list(keys)
    n, dev = keys[0].length, keys[0].device
    row_mask = None
    if dropna and any(k.validity is not None or k.dtype.is_float for k in keys):
        row_mask = torch.ones(n, dtype=torch.bool, device=dev)
        for k in keys:
            if k.validity is not None:
                row_mask &= k.validity
            if k.dtype.is_float:
                row_mask &= ~torch.isnan(k.data)
    if n == 0:
        return _empty_grouper(dev, row_mask)
    ops = sort_operands(keys)
    eq = [k for col in keys for k in equality_keys(col)]
    if row_mask is not None:
        # dropped rows sort last, as one run: their operands are zeroed
        ops = [(~row_mask).to(torch.int8)] + [torch.where(row_mask, op, 0) for op in ops]
    order = lex_sort_permutation(ops)
    neq = torch.zeros(n, dtype=torch.bool, device=dev)
    neq[:1] = True
    for k in eq:
        s = k[order]
        neq[1:] |= s[1:] != s[:-1]
    if row_mask is not None:
        neq &= row_mask[order]
        num_groups, n_kept = tracing.tolist(torch.stack([neq.sum(), row_mask.sum()]),
                                            "group_count")
    else:
        num_groups, n_kept = tracing.to_int(neq.sum(), "group_count"), n
    if n_kept == 0:
        return _empty_grouper(dev, row_mask)
    order = order[:n_kept]
    gid_sorted = torch.cumsum(neq[:n_kept], 0) - 1
    kept_rows = None
    if n_kept == n:
        row_mask = None
    elif row_mask is not None:
        rank = torch.cumsum(row_mask, 0) - 1           # frame row -> kept row
        kept_rows = torch.empty(n_kept, dtype=torch.int64, device=dev)
        kept_rows[rank[order]] = order
        order = rank[order]
    offsets = torch.searchsorted(gid_sorted, torch.arange(num_groups + 1, device=dev))
    group_ids = torch.empty(n_kept, dtype=torch.int64, device=dev)
    group_ids[order] = gid_sorted
    return Grouper(group_ids, num_groups, order[offsets[:-1]], order, offsets,
                   row_mask, kept_rows, gid_sorted)


@tracing.annotate("groupby.group_keys_table", "ops")
def group_keys_table(keys_table: Table, grouper: Grouper) -> Table:
    """One row a group: the key values, in group order."""
    return copying.gather_table(keys_table, grouper.frame_rows(grouper.key_rows),
                                bounds_check=False)


def _apply_row_mask(col: Column, grouper: Grouper) -> Column:
    """The column's kept rows."""
    if grouper.kept_rows is None:
        return col
    return copying.gather(col, grouper.kept_rows, bounds_check=False)


# ----------------------------------------------------------------------
# the sort tier: aggregations over the group ids
# ----------------------------------------------------------------------

def _segment_data(col: Column) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(data, valid) with NaN treated as null (pandas skipna)."""
    v = col.validity
    if col.dtype.is_float:
        notnan = ~torch.isnan(col.data)
        v = notnan if v is None else v & notnan
    return col.data, v


def _sizes(g: Grouper) -> torch.Tensor:
    return g.group_offsets[1:] - g.group_offsets[:-1]


def _group_sum(x: torch.Tensor, g: Grouper) -> torch.Tensor:
    """Per-group sums of x (int64 or float64), one atomic add a row."""
    return torch.zeros(g.num_groups, dtype=x.dtype, device=x.device).index_add_(
        0, g.group_ids, x)


def _valid_count(v: Optional[torch.Tensor], g: Grouper) -> torch.Tensor:
    return _sizes(g) if v is None else _group_sum(v.long(), g)


def _accumulate(data: torch.Tensor, v: Optional[torch.Tensor], fill) -> torch.Tensor:
    """int64 (integers, bool) or float64 values, ``fill`` at invalid rows."""
    x = data.double() if data.is_floating_point() else (
        data.view(torch.int64) if data.dtype == torch.uint64 else data.long())
    return x if v is None else torch.where(v, x, fill)


def group_count(col: Column, grouper: Grouper) -> Column:
    _, v = _segment_data(_apply_row_mask(col, grouper))
    return Column(dt.INT64, grouper.num_groups, _valid_count(v, grouper))


@tracing.annotate("groupby.group_size", "ops")
def group_size(grouper: Grouper) -> Column:
    return Column(dt.INT64, grouper.num_groups, _sizes(grouper))


def group_sum(col: Column, grouper: Grouper) -> Column:
    """Sums; an all-null group sums to 0 (pandas min_count=0).  A STRING
    column's sum is each group's values joined in row order, a null as
    "" (pandas')."""
    if col.dtype.is_string:
        return _group_concat(col, grouper)
    data, v = _segment_data(_apply_row_mask(col, grouper))
    s = _group_sum(_accumulate(data, v, 0), grouper)
    if col.dtype.is_float:
        out_dt = _float_out(col.dtype)
        return Column(out_dt, grouper.num_groups, s.to(out_dt.torch_storage))
    return _fit_int(Column(dt.INT64, grouper.num_groups, s), col.dtype)


def _group_concat(col: Column, grouper: Grouper) -> Column:
    """Each group's strings joined: the rows gathered in group order lay
    each group's bytes side by side, so the groups' offsets are the
    gathered offsets at the group boundaries."""
    from cudf_tpu_torch.ops.replace import replace_nulls_scalar

    col = _apply_row_mask(col, grouper)
    if col.validity is not None:
        col = replace_nulls_scalar(col, "")
    rows = copying.gather(col, grouper.sorted_order, bounds_check=False)
    offsets = rows.offsets[grouper.group_offsets]
    data = rows.data[tracing.to_int(offsets[0], "string_bytes"):
                     tracing.to_int(offsets[-1], "string_bytes")]
    return Column(col.dtype, grouper.num_groups, data, None, offsets - offsets[0])


def _minmax_values(data: torch.Tensor) -> Tuple[torch.Tensor, Tuple]:
    """A tensor scatter_reduce_ takes on every device with the same order
    as data, and the way back: bool as uint8, uint16/uint32 widened,
    uint64 as order-preserving int64."""
    if data.dtype == torch.bool:
        return data.to(torch.uint8), (torch.bool, None)
    if data.dtype in (torch.uint16, torch.uint32):
        return data.long(), (data.dtype, None)
    if data.dtype == torch.uint64:
        return data.view(torch.int64) ^ (-(1 << 63)), (torch.uint64, -(1 << 63))
    return data, (data.dtype, None)


def _from_minmax(x: torch.Tensor, back) -> torch.Tensor:
    dtype, flip = back
    if flip is not None:
        return (x ^ flip).view(dtype)
    return x.to(dtype)


def _group_minmax(col: Column, grouper: Grouper, which: str) -> Column:
    data, v = _segment_data(_apply_row_mask(col, grouper))
    x, back = _minmax_values(data)
    if x.is_floating_point():
        lo, hi = float("-inf"), float("inf")
    else:
        info = torch.iinfo(x.dtype)
        lo, hi = info.min, info.max
    ident = hi if which == "min" else lo
    if v is not None:
        x = torch.where(v, x, ident)
    out = torch.full((grouper.num_groups,), ident, dtype=x.dtype, device=x.device)
    out.scatter_reduce_(0, grouper.group_ids, x, "amin" if which == "min" else "amax")
    cnt = _valid_count(v, grouper)
    out = torch.where(cnt > 0, out, torch.zeros_like(out))
    return Column(col.dtype, grouper.num_groups, _from_minmax(out, back),
                  None if v is None else cnt > 0)


def group_min(col: Column, grouper: Grouper) -> Column:
    return _group_minmax(col, grouper, "min")


def group_max(col: Column, grouper: Grouper) -> Column:
    return _group_minmax(col, grouper, "max")


def group_mean(col: Column, grouper: Grouper) -> Column:
    data, v = _segment_data(_apply_row_mask(col, grouper))
    s = _group_sum(_accumulate(data, v, 0).double(), grouper)
    cnt = _valid_count(v, grouper)
    out_dt = _float_out(col.dtype)
    mean = s / cnt.clamp(min=1)
    return Column(out_dt, grouper.num_groups, mean.to(out_dt.torch_storage), cnt > 0)


def group_var(col: Column, grouper: Grouper, ddof: int = 1) -> Column:
    """Two passes in float64: the group means, then the squares of the
    deviations from them."""
    data, v = _segment_data(_apply_row_mask(col, grouper))
    x = _accumulate(data, v, 0).double()
    cnt = _valid_count(v, grouper)
    mean = _group_sum(x, grouper) / cnt.clamp(min=1)
    d = x - mean[grouper.group_ids]
    if v is not None:
        d = torch.where(v, d, 0.0)
    ss = _group_sum(d * d, grouper)
    denom = cnt - ddof
    out = torch.where(denom > 0, ss / denom.clamp(min=1), float("nan"))
    out_dt = _float_out(col.dtype)
    return Column(out_dt, grouper.num_groups, out.to(out_dt.torch_storage), denom > 0)


def group_std(col: Column, grouper: Grouper, ddof: int = 1) -> Column:
    var = group_var(col, grouper, ddof)
    return Column(var.dtype, var.length, torch.sqrt(var.data), var.validity)


def group_prod(col: Column, grouper: Grouper) -> Column:
    """Products; an all-null group gives 1 (pandas min_count=0)."""
    data, v = _segment_data(_apply_row_mask(col, grouper))
    x = _accumulate(data, v, 1)
    out = torch.ones(grouper.num_groups, dtype=x.dtype, device=x.device)
    out.scatter_reduce_(0, grouper.group_ids, x, "prod")
    if col.dtype.is_float:
        out_dt = _float_out(col.dtype)
        return Column(out_dt, grouper.num_groups, out.to(out_dt.torch_storage))
    return _fit_int(Column(dt.INT64, grouper.num_groups, out), col.dtype)


def _group_bool(col: Column, grouper: Grouper, which: str) -> Column:
    data, v = _segment_data(_apply_row_mask(col, grouper))
    b = data != 0
    if v is not None:
        b = b & v if which == "any" else b | ~v
    out = torch.full((grouper.num_groups,), 0 if which == "any" else 1, dtype=torch.uint8,
                     device=b.device)
    out.scatter_reduce_(0, grouper.group_ids, b.to(torch.uint8),
                        "amax" if which == "any" else "amin")
    return Column(dt.BOOL8, grouper.num_groups, out.bool())


def group_any(col: Column, grouper: Grouper) -> Column:
    return _group_bool(col, grouper, "any")


def group_all(col: Column, grouper: Grouper) -> Column:
    return _group_bool(col, grouper, "all")


def _group_first_last(col: Column, grouper: Grouper, first: bool) -> Column:
    """The first (last) valid value of each group in row order."""
    col = _apply_row_mask(col, grouper)
    n = col.length
    _, v = _segment_data(col)
    pos = torch.arange(n, dtype=torch.int64, device=col.device)
    none = n if first else -1
    if v is not None:
        pos = torch.where(v, pos, none)
    picked = torch.full((grouper.num_groups,), none, dtype=torch.int64, device=col.device)
    picked.scatter_reduce_(0, grouper.group_ids, pos, "amin" if first else "amax")
    return copying.gather(col, torch.where(picked == none, -1, picked), bounds_check=True)


def group_first(col: Column, grouper: Grouper) -> Column:
    return _group_first_last(col, grouper, first=True)


def group_last(col: Column, grouper: Grouper) -> Column:
    return _group_first_last(col, grouper, first=False)


@tracing.annotate("groupby.group_nth", "ops")
def group_nth(col: Column, grouper: Grouper, n: int) -> Column:
    """Each group's n-th row (from the end for n < 0), null where the group
    is shorter."""
    col = _apply_row_mask(col, grouper)
    starts = grouper.group_offsets[:-1]
    sizes = _sizes(grouper)
    nn = torch.full_like(sizes, n) if n >= 0 else sizes + n
    ok = (nn >= 0) & (nn < sizes)
    at = (starts + nn).clamp(0, max(col.length - 1, 0))
    rows = torch.where(ok, grouper.sorted_order[at], -1)
    return copying.gather(col, rows, bounds_check=True)


def _valid_view(col: Column) -> Column:
    """The column with NaN as null."""
    _, v = _segment_data(col)
    return Column(col.dtype, col.length, col.data, v)


def _sort_within_groups(grouper: Grouper, operands: Sequence[torch.Tensor]) -> torch.Tensor:
    """The stable sort of the kept rows by (group, operands...)."""
    gid = grouper.group_ids
    if grouper.num_groups < 1 << 31:
        gid = gid.int()
    return lex_sort_permutation([gid, *operands])


def group_nunique(col: Column, grouper: Grouper, dropna: bool = True) -> Column:
    """Distinct values a group; with dropna, null and NaN are not counted."""
    col = _valid_view(_apply_row_mask(col, grouper))
    eq = equality_keys(col)
    order = _sort_within_groups(grouper, eq)
    gs = grouper.group_ids[order]
    neq = torch.zeros(col.length, dtype=torch.bool, device=col.device)
    neq[:1] = True
    for k in [gs, *eq]:
        s = k[order] if k is not gs else k
        neq[1:] |= s[1:] != s[:-1]
    counts = torch.zeros(grouper.num_groups, dtype=torch.int64, device=col.device).index_add_(
        0, gs, neq.long())
    if dropna and col.validity is not None:
        counts = counts - (_group_sum((~col.validity).long(), grouper) > 0).long()
    return Column(dt.INT64, grouper.num_groups, counts)


def _value_sorted(col: Column, grouper: Grouper):
    """(the kept rows' values as float64 sorted by (group, value) with
    nulls and NaN last in each group, the valid count a group)."""
    data, v = _segment_data(_apply_row_mask(col, grouper))
    x = data.double()
    key = _float_to_ordered_int(x)
    if v is not None:
        key = torch.where(v, key, torch.iinfo(torch.int64).max)
    order = _sort_within_groups(grouper, [key])
    return x[order], _valid_count(v, grouper)


# ----------------------------------------------------------------------
# aggregations that return LIST columns
# ----------------------------------------------------------------------

def group_collect_list(col: Column, grouper: Grouper) -> Column:
    """Each group's values in row order, nulls kept (group_collect.cu)."""
    from cudf_tpu_torch.ops.lists import make_list_column

    col = _apply_row_mask(col, grouper)
    return make_list_column(grouper.group_offsets,
                            copying.gather(col, grouper.sorted_order, bounds_check=False))


def _distinct_per_group(col: Column, grouper: Grouper):
    """(rows, run_gid, run_counts): one kept row a distinct (group, value)
    pair (its first in row order), ordered by (group, value) with a null
    value last, and how many rows each pair has."""
    order = _sort_within_groups(grouper, order_keys(col, True, "last"))
    gs = grouper.group_ids[order]
    neq = torch.ones(col.length, dtype=torch.bool, device=col.device)
    neq[1:] = gs[1:] != gs[:-1]
    for key in equality_keys(col):
        ks = key[order]
        neq[1:] |= ks[1:] != ks[:-1]
    starts = filter_indices(neq)
    ends = torch.cat([starts[1:], tracing.synced("host_values", col.device, torch.tensor,
                                                  [col.length], device=col.device)])
    return order[starts], gs[starts], ends - starts


def _runs_to_lists(vals: Column, run_gid: torch.Tensor, grouper: Grouper) -> Column:
    from cudf_tpu_torch.ops.lists import make_list_column, offsets_of

    per_group = torch.zeros(grouper.num_groups, dtype=torch.int64, device=run_gid.device)
    per_group.index_add_(0, run_gid, torch.ones_like(run_gid))
    return make_list_column(offsets_of(per_group), vals)


def group_collect_set(col: Column, grouper: Grouper) -> Column:
    """Each group's distinct values in ascending order, a null value once
    and last (group_collect.cu + drop_list_duplicates)."""
    col = _apply_row_mask(col, grouper)
    rows, run_gid, _ = _distinct_per_group(col, grouper)
    return _runs_to_lists(copying.gather(col, rows, bounds_check=False), run_gid, grouper)


def group_unique(col: Column, grouper: Grouper) -> Column:
    """Each group's distinct values in order of first appearance, as
    pandas' ``SeriesGroupBy.unique`` gives them (the reference gives
    collect_set's ascending order)."""
    col = _apply_row_mask(col, grouper)
    rows, run_gid, _ = _distinct_per_group(col, grouper)
    by_row = lex_sort_permutation([run_gid, rows])
    return _runs_to_lists(copying.gather(col, rows[by_row], bounds_check=False),
                          run_gid[by_row], grouper)


def group_histogram(col: Column, grouper: Grouper) -> Column:
    """LIST<STRUCT<value, count>>: each group's distinct values, ascending,
    and how many rows hold each (the HISTOGRAM aggregation)."""
    from cudf_tpu_torch.ops.structs import make_struct_column

    col = _apply_row_mask(col, grouper)
    rows, run_gid, counts = _distinct_per_group(col, grouper)
    child = make_struct_column([("value", copying.gather(col, rows, bounds_check=False)),
                                ("count", Column(dt.INT64, counts.shape[0], counts))])
    return _runs_to_lists(child, run_gid, grouper)


def group_topk(col: Column, grouper: Grouper, k: int, largest: bool = True) -> Column:
    """Each group's k largest (smallest) valid values, in that order
    (group_topk.cu); a group of fewer valid values gives them all."""
    from cudf_tpu_torch.ops.lists import make_list_column, offsets_of

    col = _valid_view(_apply_row_mask(col, grouper))
    order = _sort_within_groups(grouper, order_keys(col, not largest, "last"))
    valid = _valid_count(col.validity, grouper)
    keep_n = torch.clamp(valid, max=int(k))
    gs = grouper.group_ids[order]
    within = torch.arange(col.length, dtype=torch.int64, device=col.device) - \
        grouper.group_offsets[:-1][gs]
    rows = order[filter_indices(within < keep_n[gs])]
    return make_list_column(offsets_of(keep_n), copying.gather(col, rows, bounds_check=False))


def group_tdigest(col: Column, grouper: Grouper, delta: int = 100) -> Column:
    """Each group's t-digest (the TDIGEST aggregation,
    tdigest_aggregation.cu; the k1 scale of ``ops/tdigest.py``):
    STRUCT<centroids: LIST<STRUCT<mean, weight>>, min, max>.  The kept rows
    sort by (group, null last, value) with the LSD chain; each value's
    centroid is its group's ``floor(k1(q) * delta)``, and the centroid sums
    are ``index_add_`` into G * delta slots (the empty ones dropped)."""
    from cudf_tpu_torch.ops.lists import make_list_column, offsets_of
    from cudf_tpu_torch.ops.structs import make_struct_column
    from cudf_tpu_torch.ops.tdigest import k_scale

    kept = _apply_row_mask(col, grouper)
    data, v = _segment_data(kept)
    x = data.double()
    key = _float_to_ordered_int(x)
    if v is not None:
        key = torch.where(v, key, torch.iinfo(torch.int64).max)
    order = _sort_within_groups(grouper, [key])
    gid = grouper.group_ids[order]
    xs = x[order]
    w = torch.ones_like(xs) if v is None else v[order].double()
    G = grouper.num_groups
    dev = xs.device
    totals = torch.zeros(G, dtype=torch.float64, device=dev).index_add_(0, gid, w)
    # each value's cumulative weight within its group, less half its own
    before = torch.cumsum(totals, 0) - totals
    cum_mid = torch.cumsum(w, 0) - before[gid] - w * 0.5
    q = cum_mid / torch.clamp(totals[gid], min=1e-300)
    local = torch.clamp(torch.floor(k_scale(q) * delta).long(), 0, delta - 1)
    slot = torch.where(w > 0, gid * delta + local, G * delta)
    wsum = torch.zeros(G * delta + 1, dtype=torch.float64, device=dev).index_add_(
        0, slot, w)[:-1]
    xsum = torch.zeros(G * delta + 1, dtype=torch.float64, device=dev).index_add_(
        0, slot, torch.where(w > 0, xs, 0.0))[:-1]
    rows = filter_indices(wsum > 0)
    weights = wsum[rows]
    means = xsum[rows] / weights
    per_group = torch.bincount(rows // delta, minlength=G)
    m = rows.shape[0]
    centroids = make_list_column(offsets_of(per_group), make_struct_column(
        [("mean", Column(dt.FLOAT64, m, means)), ("weight", Column(dt.FLOAT64, m, weights))]))
    mn, mx = group_min(col, grouper), group_max(col, grouper)
    return make_struct_column([
        ("centroids", centroids),
        ("min", Column(dt.FLOAT64, G, mn.data.double(), mn.validity)),
        ("max", Column(dt.FLOAT64, G, mx.data.double(), mx.validity))])


def group_quantile(col: Column, grouper: Grouper, q: float = 0.5,
                   interpolation: str = "linear") -> Column:
    """Per-group quantile of the valid values (float64), pandas'
    interpolations; a group without valid values gives null."""
    return group_quantiles(col, grouper, [q], interpolation)[0]


@tracing.annotate("groupby.group_quantiles", "ops")
def group_quantiles(col: Column, grouper: Grouper, qs: Sequence[float],
                    interpolation: str = "linear") -> List[Column]:
    """``group_quantile`` at each of ``qs`` from one sort by (group,
    value); q = 0 and 1 are each group's min and max (float64)."""
    xs, cnt = _value_sorted(col, grouper)
    return [Column(dt.FLOAT64, grouper.num_groups,
                   _interpolate(xs, cnt, grouper, q, interpolation), cnt > 0) for q in qs]


def _interpolate(xs, cnt, grouper: Grouper, q: float, interpolation: str) -> torch.Tensor:
    n = xs.shape[0]
    starts = grouper.group_offsets[:-1]
    pos = q * (cnt - 1).clamp(min=0).double()
    lo, hi = torch.floor(pos).long(), torch.ceil(pos).long()
    dlo = xs[(starts + lo).clamp(0, max(n - 1, 0))]
    dhi = xs[(starts + hi).clamp(0, max(n - 1, 0))]
    frac = pos - lo
    if interpolation == "linear":
        return dlo + frac * (dhi - dlo)
    if interpolation == "lower":
        return dlo
    if interpolation == "higher":
        return dhi
    if interpolation == "midpoint":
        return (dlo + dhi) / 2
    if interpolation == "nearest":
        return torch.where(frac <= 0.5, dlo, dhi)
    raise ValueError(f"interpolation {interpolation!r}")


def group_median(col: Column, grouper: Grouper) -> Column:
    """The middle valid value, or the midpoint (a + b) / 2 of the middle
    two, as pandas computes it; float32 values give float32."""
    xs, cnt = _value_sorted(col, grouper)
    out = _interpolate(xs, cnt, grouper, 0.5, "midpoint")
    out_dt = _float_out(col.dtype)
    return Column(out_dt, grouper.num_groups, out.to(out_dt.torch_storage), cnt > 0)


def _group_arg_extreme_rows(col: Column, grouper: Grouper, which: str) -> torch.Tensor:
    """Each group's kept row of its min (max) valid value, the first such
    row on ties; -1 for a group without valid values."""
    col = _valid_view(_apply_row_mask(col, grouper))
    ops = sort_operands([col], [which == "min"], "last")
    first = _sort_within_groups(grouper, ops)[grouper.group_offsets[:-1]]
    if col.validity is None:
        return first
    return torch.where(_valid_count(col.validity, grouper) > 0, first, -1)


def group_idxminmax(col: Column, grouper: Grouper, which: str) -> Column:
    """The frame row of each group's min (max); null for a group without
    valid values.  The frame layer maps rows to index labels."""
    rows = _group_arg_extreme_rows(col, grouper, which)
    ok = rows >= 0
    rows = torch.where(ok, grouper.frame_rows(rows.clamp(min=0)), 0)
    return Column(dt.INT64, grouper.num_groups, rows, ok)


# ----------------------------------------------------------------------
# the rest of the family: sum_of_squares, m2, cov/corr, ewma, bitwise
# ----------------------------------------------------------------------

def group_sum_of_squares(col: Column, grouper: Grouper) -> Column:
    """Sums of x * x in float64; null for a group without valid values."""
    data, v = _segment_data(_apply_row_mask(col, grouper))
    x = _accumulate(data, v, 0).double()
    out = _group_sum(x * x, grouper)
    return Column(dt.FLOAT64, grouper.num_groups, out,
                  None if v is None else _valid_count(v, grouper) > 0)


def _centred(x: torch.Tensor, v: Optional[torch.Tensor], cnt: torch.Tensor,
             grouper: Grouper) -> torch.Tensor:
    """x less its group's mean over the valid rows (0 at invalid rows):
    the first of two passes."""
    mean = _group_sum(x, grouper) / cnt.clamp(min=1)
    d = x - mean[grouper.group_ids]
    return d if v is None else torch.where(v, d, 0.0)


def group_m2(col: Column, grouper: Grouper) -> Column:
    """The sum of squared deviations from the group mean (cuDF's M2, what
    Chan's merge of partial variances takes), in two passes; null for a
    group without valid values."""
    data, v = _segment_data(_apply_row_mask(col, grouper))
    x = _accumulate(data, v, 0).double()
    cnt = _valid_count(v, grouper)
    d = _centred(x, v, cnt, grouper)
    return Column(dt.FLOAT64, grouper.num_groups, _group_sum(d * d, grouper),
                  None if v is None else cnt > 0)


def group_moments(col: Column, grouper: Grouper) -> Tuple[torch.Tensor, ...]:
    """float64 (count, mean, M2, residual) a group, over the valid rows:
    the mean m, M2 = sum (x - m)^2 and residual = sum (x - m), both about
    that rounded m.  The residual makes a merge of partial moments exact to
    first order in m's rounding (``engine/streaming.py``'s Chan merge)."""
    data, v = _segment_data(_apply_row_mask(col, grouper))
    x = _accumulate(data, v, 0).double()
    cnt = _valid_count(v, grouper)
    mean = _group_sum(x, grouper) / cnt.clamp(min=1)
    d = x - mean[grouper.group_ids]
    if v is not None:
        d = torch.where(v, d, 0.0)
    return cnt.double(), mean, _group_sum(d * d, grouper), _group_sum(d, grouper)


def _pair(cx: Column, cy: Column, grouper: Grouper):
    """(x, y, the rows where both are valid, their count a group): float64
    values, NaN as null, the invalid rows' values 0."""
    dx, vx = _segment_data(_apply_row_mask(cx, grouper))
    dy, vy = _segment_data(_apply_row_mask(cy, grouper))
    v = bm.and_masks(vx, vy)
    x, y = _accumulate(dx, v, 0).double(), _accumulate(dy, v, 0).double()
    return x, y, v, _valid_count(v, grouper)


def _cov_of(sxy: torch.Tensor, cnt: torch.Tensor, ddof: int) -> Column:
    denom = cnt - ddof
    ok = denom > 0
    return Column(dt.FLOAT64, sxy.shape[0], torch.where(ok, sxy / denom.clamp(min=1),
                                                        float("nan")), ok)


def _corr_of(sxy, sxx, syy, cnt) -> Column:
    denom = torch.sqrt(sxx * syy)
    ok = (cnt > 1) & (denom > 0)
    return Column(dt.FLOAT64, sxy.shape[0],
                  torch.where(ok, sxy / torch.where(ok, denom, 1.0), float("nan")), ok)


def group_cov(cx: Column, cy: Column, grouper: Grouper, ddof: int = 1) -> Column:
    """Each group's covariance of x and y over the rows where both are
    valid (pandas' pairwise-complete rows), in two passes: the centred
    products' sum over count - ddof; null (NaN) where count - ddof < 1."""
    x, y, v, cnt = _pair(cx, cy, grouper)
    sxy = _group_sum(_centred(x, v, cnt, grouper) * _centred(y, v, cnt, grouper), grouper)
    return _cov_of(sxy, cnt, ddof)


def group_corr(cx: Column, cy: Column, grouper: Grouper) -> Column:
    """Each group's Pearson correlation over the pairwise-complete rows, in
    two passes; null (NaN) where a group has fewer than two such rows or
    either column is constant there, as pandas gives NaN."""
    x, y, v, cnt = _pair(cx, cy, grouper)
    dx, dy = _centred(x, v, cnt, grouper), _centred(y, v, cnt, grouper)
    return _corr_of(*(_group_sum(a * b, grouper) for a, b in ((dx, dy), (dx, dx), (dy, dy))),
                    cnt)


@tracing.annotate("groupby.group_pairwise", "ops")
def group_pairwise(cols: Sequence[Column], grouper: Grouper, which: str = "cov",
                   ddof: int = 1) -> Dict[Tuple[int, int], Column]:
    """``group_cov`` (or ``group_corr``) of every pair i <= j of the
    columns.  Columns without nulls or NaN share one centring and one sum
    of squares each (every row is pairwise-complete); a pair with missing
    values takes its own pairwise-complete rows."""
    full = {}
    for i, c in enumerate(cols):
        data, v = _segment_data(_apply_row_mask(c, grouper))
        if v is not None and not tracing.to_bool(v.all(), "null_check"):
            continue
        full[i] = _centred(_accumulate(data, None, 0).double(), None, _sizes(grouper), grouper)
    squares = {i: _group_sum(d * d, grouper) for i, d in full.items()}
    out = {}
    for i in range(len(cols)):
        for j in range(i, len(cols)):
            if i in full and j in full:
                sxy = squares[i] if i == j else _group_sum(full[i] * full[j], grouper)
                cnt = _sizes(grouper)
                out[i, j] = _cov_of(sxy, cnt, ddof) if which == "cov" else \
                    _corr_of(sxy, squares[i], squares[j], cnt)
            else:
                out[i, j] = group_cov(cols[i], cols[j], grouper, ddof) if which == "cov" \
                    else group_corr(cols[i], cols[j], grouper)
    return out


def group_ewma(col: Column, grouper: Grouper, alpha: float, adjust: bool = True,
               ignore_na: bool = False) -> Column:
    """The exponentially weighted mean of each kept row within its group,
    in row order (``ops/scan.py`` ``ewm_mean``'s semantics a group): the
    doubling affine scan over the rows sorted by group, each group's first
    row resetting it (its multiplier 0).  Rows before a group's first
    valid value are null; later null rows carry the running mean."""
    from cudf_tpu_torch.ops.scan import affine_scan, running_extreme

    data, v = _segment_data(_apply_row_mask(col, grouper))
    n, dev = data.shape[0], data.device
    order = grouper.sorted_order
    x = data.double()[order]
    valid = torch.ones(n, dtype=torch.bool, device=dev) if v is None else v[order]
    start = torch.zeros(n, dtype=torch.bool, device=dev)
    start[grouper.group_offsets[:-1]] = True
    # valid rows of the group before this one
    inc = torch.cumsum(valid.long(), 0)
    first = grouper.group_offsets[:-1][grouper.sorted_group_ids]
    seen_before = (inc - valid.long() - (inc[first] - valid[first].long())) > 0
    xv = torch.where(valid, x, 0.0)
    one_m = 1.0 - alpha
    if adjust:
        a = torch.full((n,), one_m, dtype=torch.float64, device=dev)
        if ignore_na:
            a = torch.where(valid, a, 1.0)
        a = torch.where(start, 0.0, a)
        w = valid.double()
        out = affine_scan(a, w * xv) / affine_scan(a, w)
    else:
        if ignore_na:
            beta = torch.full((n,), alpha, dtype=torch.float64, device=dev)
        else:
            pos = torch.arange(n, dtype=torch.int64, device=dev)
            # the last valid row of the group at or before each row (-1: none)
            last = running_extreme(torch.where(valid, pos, -1), "cummax")
            last = torch.where(last >= first, last, -1)
            prev = torch.cat([last.new_full((1,), -1), last[:-1]])
            prev = torch.where(start, -1, prev)
            beta = alpha / (one_m ** ((pos - 1 - prev).double() + 1.0) + alpha)
        a = torch.where(valid, torch.where(seen_before, 1.0 - beta, 0.0), 1.0)
        a = torch.where(start, 0.0, a)
        b = torch.where(valid, torch.where(seen_before, beta * xv, xv), 0.0)
        out = affine_scan(a, b)
    ok = seen_before | valid
    out = torch.where(ok, out, float("nan"))
    res = torch.empty_like(out)
    res[order] = out
    keep = torch.empty_like(ok)
    keep[order] = ok
    return Column(dt.FLOAT64, n, res, keep)


_BITWISE = {"and": torch.bitwise_and, "or": torch.bitwise_or, "xor": torch.bitwise_xor}


def _group_bitwise(col: Column, grouper: Grouper, op: str) -> Column:
    """A segmented Hillis-Steele scan over the values sorted by group: at
    distance d a row takes op(itself, the row d before) when that row is of
    its group, for d = 1, 2, 4, ... up to the largest group (one host
    sync for its size); each group's last row then holds the result.
    Values run as int64 bits (uint64 as its bits); null rows hold the
    op's identity; a group without valid values is null."""
    if not (col.dtype.is_integer or col.dtype.is_bool):
        raise TypeError(f"groupby bitwise_{op} of a {col.dtype!r} column")
    data, v = _segment_data(_apply_row_mask(col, grouper))
    x = _accumulate(data, v, -1 if op == "and" else 0)
    order, gs = grouper.sorted_order, grouper.sorted_group_ids
    x = x[order]
    fn = _BITWISE[op]
    sizes = _sizes(grouper)
    d, largest = 1, tracing.to_int(sizes.max(), "group_size_max") if grouper.num_groups else 0
    while d < largest:
        same = gs[d:] == gs[:-d]
        x = torch.cat([x[:d], torch.where(same, fn(x[d:], x[:-d]), x[d:])])
        d *= 2
    out = x[(grouper.group_offsets[1:] - 1).clamp(min=0)] if grouper.num_groups else x[:0]
    if col.dtype.is_bool:
        data_out = out != 0
    elif col.dtype == dt.UINT64:
        data_out = out.view(torch.uint64)
    else:
        data_out = out.to(col.dtype.torch_storage)
    return Column(col.dtype, grouper.num_groups, data_out,
                  None if v is None else _valid_count(v, grouper) > 0)


def group_bitwise_and(col: Column, grouper: Grouper) -> Column:
    return _group_bitwise(col, grouper, "and")


def group_bitwise_or(col: Column, grouper: Grouper) -> Column:
    return _group_bitwise(col, grouper, "or")


def group_bitwise_xor(col: Column, grouper: Grouper) -> Column:
    return _group_bitwise(col, grouper, "xor")


_AGG_DISPATCH = {
    "sum": group_sum,
    "count": group_count,
    "size": lambda col, g: group_size(g),
    "mean": group_mean,
    "min": group_min,
    "max": group_max,
    "var": group_var,
    "std": group_std,
    "prod": group_prod,
    "product": group_prod,
    "any": group_any,
    "all": group_all,
    "first": group_first,
    "last": group_last,
    "nunique": group_nunique,
    "median": group_median,
    "quantile": group_quantile,
    "idxmin": lambda col, g: group_idxminmax(col, g, "min"),
    "idxmax": lambda col, g: group_idxminmax(col, g, "max"),
    "sum_of_squares": group_sum_of_squares,
    "m2": group_m2,
    "bitwise_and": group_bitwise_and,
    "bitwise_or": group_bitwise_or,
    "bitwise_xor": group_bitwise_xor,
    "collect": group_collect_list,
    "list": group_collect_list,
    "unique": group_unique,
    "collect_set": group_collect_set,
    "histogram": group_histogram,
    "tdigest": group_tdigest,
}
LIST_AGGS = frozenset({"collect", "list", "unique", "collect_set", "histogram"})


_TEMPORAL_AS_TICKS = frozenset({"mean", "median", "std"})


def _temporal_aggregate(col: Column, grouper: Grouper, agg: str) -> Optional[Column]:
    """pandas' temporal results, or None where the plain dispatch serves:
    mean and median of timestamps (durations) are timestamps (durations)
    and std a duration, in the column's unit, their float ticks truncated
    toward zero; a duration sums to a duration; timestamps do not sum or
    multiply, and no temporal column has a var (pandas raises TypeError)."""
    if agg == "var" or (agg in ("sum", "prod", "product") and col.dtype.is_timestamp) or (
            agg in ("prod", "product")):
        raise TypeError(f"a {col.dtype!r} column does not support groupby {agg!r}")
    if agg == "sum":
        res = group_sum(Column(dt.INT64, col.length, col.data, col.validity), grouper)
        return Column(col.dtype, res.length, res.data.to(torch.int64), res.validity)
    if agg not in _TEMPORAL_AS_TICKS:
        return None
    res = _AGG_DISPATCH[agg](Column(dt.INT64, col.length, col.data, col.validity), grouper)
    ticks = torch.where(res.validity, res.data, 0) if res.validity is not None else res.data
    out = dt.unit_dtype("m", col.dtype.time_unit) if agg == "std" else col.dtype
    return Column(out, res.length, ticks.to(torch.int64), res.validity)


@tracing.annotate("groupby.aggregate", "ops")
def aggregate(col: Column, grouper: Grouper, agg: str) -> Column:
    """One sort-tier aggregation of col over the grouper's groups."""
    fn = _AGG_DISPATCH.get(agg)
    if fn is None:
        raise _not_ported(agg)
    if col.dtype.is_temporal:
        out = _temporal_aggregate(col, grouper, agg)
        if out is not None:
            return out
    return fn(col, grouper)


@tracing.annotate("groupby.groupby_agg", "ops")
def groupby_agg(keys: Table, values: Sequence[Request],
                dropna: bool = True) -> Tuple[Table, Table]:
    """values: (output_name, column, agg) triples -> (group keys, aggs).

    Port of ``cudf_tpu/ops/groupby.py:1039``: the kernel tiers serve the
    request when they can, else the sort tier (groups in ascending key
    order, a null group last)."""
    values = list(values)
    for _, _, agg in values:
        if agg not in _AGG_DISPATCH:
            raise _not_ported(agg)
    fast = _try_onehot_fast_path(keys, values, dropna)
    if fast is not None:
        return fast
    grouper = make_grouper(list(keys.columns), dropna=dropna)
    return group_keys_table(keys, grouper), Table(
        {name: aggregate(col, grouper, agg) for name, col, agg in values})


# ----------------------------------------------------------------------
# grouped scans and shifts, one value a kept row
# ----------------------------------------------------------------------

def _unsort(x_sorted: torch.Tensor, grouper: Grouper) -> torch.Tensor:
    out = torch.empty_like(x_sorted)
    out[grouper.sorted_order] = x_sorted
    return out


@tracing.annotate("groupby.group_cumsum", "ops")
def group_cumsum(col: Column, grouper: Grouper) -> Column:
    """Running sums within groups in row order; null (and NaN) rows give
    null and add nothing.  Integers are exact; floats run in float64 as
    one prefix sum less each group's start, so a float result carries the
    rounding of the whole prefix."""
    col = _apply_row_mask(col, grouper)
    data, v = _segment_data(col)
    x = _accumulate(data, v, 0)
    xs = x[grouper.sorted_order]
    cs = torch.cumsum(xs, 0)
    starts = grouper.group_offsets[:-1]
    base = (cs[starts] - xs[starts])[grouper.sorted_group_ids]
    out = _unsort(cs - base, grouper)
    if col.dtype.is_float:
        out_dt = _float_out(col.dtype)
        return Column(out_dt, col.length, out.to(out_dt.torch_storage), v)
    return _fit_int(Column(dt.INT64, col.length, out, v), col.dtype)


@tracing.annotate("groupby.group_cumcount", "ops")
def group_cumcount(grouper: Grouper) -> Column:
    """Each kept row's position in its group (0-based, row order)."""
    n = grouper.sorted_order.shape[0]
    pos = torch.arange(n, dtype=torch.int64, device=grouper.sorted_order.device)
    within = pos - grouper.group_offsets[:-1][grouper.sorted_group_ids]
    return Column(dt.INT64, n, _unsort(within, grouper))


@tracing.annotate("groupby.group_shift", "ops")
def group_shift(col: Column, grouper: Grouper, periods: int = 1) -> Column:
    """The value ``periods`` rows earlier in the group (later for
    periods < 0), null where there is none."""
    col = _apply_row_mask(col, grouper)
    n = col.length
    order = grouper.sorted_order
    gs = grouper.sorted_group_ids
    src = torch.arange(n, dtype=torch.int64, device=col.device) - periods
    inb = (src >= 0) & (src < n)
    srcc = src.clamp(0, max(n - 1, 0))
    rows = torch.where(inb & (gs[srcc] == gs), order[srcc], -1)
    return copying.gather(col, _unsort(rows, grouper), bounds_check=True)
