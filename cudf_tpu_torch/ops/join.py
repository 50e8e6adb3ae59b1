"""Inner joins through the kernel and dense tiers.

Port of the inner-join dispatch in ``cudf_tpu/ops/join.py``
(``_join`` ``:445``, ``_try_radix_inner`` ``:320``, ``_radix_inner_multi``
``:399``, ``_try_dense_inner`` ``:272``).  One integer key column per
side is reduced to int32 codes ``key - rmin`` over the build side's
range, with null and out-of-range rows at -1:

- the radix tier (kernels B, F, G, D and H, ``kernels/radix_partition.py``)
  serves a unique build side, or one with at most
  ``join.multi_fan_out_max`` rows per key, over a domain of at most 2^27
  keys, from ``join.fast_path_min_rows`` probe rows up;
- the dense tier serves a unique build side over a dense domain with one
  table gather per probe row;
- when neither serves the left side as the build side, both try the
  left side as the build side and probe from the right.

Pairs come in left-row order, with build order inside each left row (the
pandas inner-merge order).  Null keys match null keys, as in cudf and
pandas merge (``nulls_equal=True``); the tiers leave null rows out, which
is exact while at most one side has nulls.  Everything else needs the
sort-merge tier, which is not ported yet: it raises NotImplementedError.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.kernels.radix_partition import (MAX_DOMAIN_BITS,
                                                    radix_join_inner_multi,
                                                    radix_join_inner_unique)
from cudf_tpu_torch.ops._utils import dense_key_table, dense_probe
from cudf_tpu_torch.ops.stream_compaction import filter_indices
from cudf_tpu_torch.utils.config import get_option

SORT_MERGE_MISSING = (
    "this join needs the sort-merge tier (ops/join.py _probe_ranges over "
    "ops/sort.py), which is not ported yet: ROADMAP.md queue 1, item 3. "
    "The kernel and dense tiers serve inner joins "
    "on one integer key column per side with null keys on at most one "
    "side, a build side (either side) with at most join.multi_fan_out_max "
    "rows per key over at most 2^27 key values, and probes of at least "
    "join.fast_path_min_rows rows unless the dense tier takes them")

Maps = Tuple[torch.Tensor, torch.Tensor]


def _both_sides_have_nulls(lc: Column, rc: Column) -> bool:
    """True when both key columns hold nulls (host syncs only when both
    carry validity masks)."""
    if lc.validity is None or rc.validity is None:
        return False
    return lc.has_nulls and rc.has_nulls


def _empty(device) -> Maps:
    z = torch.zeros(0, dtype=torch.int64, device=device)
    return z, z


def _build_stats(rc: Column) -> Tuple[int, int, int]:
    """(min, max, count) over the build key's valid rows: one host sync."""
    d = rc.data if rc.data.dtype in (torch.int32, torch.int64) else rc.data.long()
    if rc.validity is None:
        lo, hi = torch.aminmax(d)
        n = torch.tensor(rc.length, device=d.device)
    else:
        info = torch.iinfo(d.dtype)
        lo = torch.where(rc.validity, d, info.max).min()
        hi = torch.where(rc.validity, d, info.min).max()
        n = rc.validity.sum()
    return tuple(int(x) for x in torch.stack([lo.long(), hi.long(), n.long()]).tolist())


def _codes(col: Column, rmin: int, rmax: int) -> torch.Tensor:
    """int32 codes key - rmin, -1 for null rows and keys outside
    [rmin, rmax].  Keys of up to 4 bytes (not uint32) stay in int32 when
    the range fits it; the others go through int64."""
    d = col.data
    if d.element_size() <= 4 and d.dtype != torch.uint32 and -2**31 <= rmin <= rmax < 2**31:
        d = d.to(torch.int32)
    else:
        d = d.long()
    codes = torch.where((d < rmin) | (d > rmax), -1, d - rmin).to(torch.int32)
    if col.validity is not None:
        codes = torch.where(col.validity, codes, -1)
    return codes


def _try_radix_inner(lc: Column, rc: Column, preserve_order: bool = True
                     ) -> Optional[Maps]:
    """(left, right) gather maps from the radix tier with ``rc`` as the
    build side, or None when the shape does not qualify.  With
    preserve_order the pairs come in left-row order (one stable sort of
    the pairs by left row), else in partitioned order."""
    if not get_option("join.radix_fast_path"):
        return None
    if not (lc.dtype.is_integer and rc.dtype.is_integer):
        return None
    nl, nr = lc.length, rc.length
    if nl < int(get_option("join.fast_path_min_rows")) or nr < 2:
        return None
    rmin, rmax, n_rvalid = _build_stats(rc)
    if n_rvalid == 0:
        return _empty(lc.device)
    domain = rmax - rmin + 1
    if domain > 1 << MAX_DOMAIN_BITS:
        return None
    rcodes = _codes(rc, rmin, rmax)
    lcodes = _codes(lc, rmin, rmax)
    rows = torch.arange(nl, dtype=torch.int32, device=lc.device)
    if domain >= n_rvalid:                      # a unique build side is possible
        _, pvl, bid, unique = radix_join_inner_unique(lcodes, rows, rcodes, domain)
        if unique:
            keep = filter_indices(bid >= 0)
            li, ri = pvl[keep], bid[keep]
            if preserve_order:
                li, order = torch.sort(li, stable=True)
                ri = ri[order]
            return li.long(), ri.long()
    return _radix_inner_multi(lcodes, rows, rcodes, domain, n_rvalid, preserve_order)


def _radix_inner_multi(lcodes: torch.Tensor, rows: torch.Tensor, rcodes: torch.Tensor,
                       domain: int, n_rvalid: int, preserve_order: bool
                       ) -> Optional[Maps]:
    """The bounded-fan-out radix tier: stacked ordinal tables, then a
    count-then-allocate expansion (one host sync for the pair count).
    Pairs come per left row in build order."""
    m_max = int(get_option("join.multi_fan_out_max"))
    if m_max < 1 or n_rvalid > m_max * domain:  # pigeonhole: fan-out exceeds m_max
        return None
    _, pvl, bids, _ = radix_join_inner_multi(lcodes, rows, rcodes, domain, m_max=m_max)
    if bids is None:                            # fan-out exceeds m_max
        return None
    cnts = (bids >= 0).sum(dim=0)               # a row's matches are bids[:c]
    M = int(cnts.sum())
    if M == 0:
        return _empty(lcodes.device)
    li = torch.repeat_interleave(pvl, cnts, output_size=M)
    starts = torch.cumsum(cnts, 0) - cnts
    j = torch.arange(M, device=cnts.device) - torch.repeat_interleave(starts, cnts,
                                                                      output_size=M)
    at = torch.repeat_interleave(torch.arange(cnts.shape[0], device=cnts.device), cnts,
                                 output_size=M)
    ri = bids[j, at]
    if preserve_order:
        li, order = torch.sort(li, stable=True)
        ri = ri[order]
    return li.long(), ri.long()


def _try_dense_inner(lc: Column, rc: Column) -> Optional[Maps]:
    """Direct-address inner join for one integer key whose build side
    ``rc`` is unique over a dense domain: one gather per probe row.
    Pairs come in left-row order; None when the shape does not qualify.
    Unlike the reference, it also serves probes of fewer than 64 rows,
    which the reference leaves to its sort-merge tier (not ported)."""
    if not get_option("join.dense_fast_path"):
        return None
    if not (lc.dtype.is_integer and rc.dtype.is_integer):
        return None
    if rc.length < 2:
        return None
    rmin, rmax, n_rvalid = _build_stats(rc)
    if n_rvalid == 0:
        return _empty(lc.device)
    domain = rmax - rmin + 1
    if domain > max(4 * rc.length, 1 << 16) or domain > 1 << MAX_DOMAIN_BITS:
        return None
    rcodes = _codes(rc, rmin, rmax)
    counts = torch.bincount(rcodes.long() + 1, minlength=domain + 1)[1:]
    if int(counts.max()) > 1:
        return None
    r_idx, found = dense_probe(dense_key_table(rcodes, 0, domain), _codes(lc, rmin, rmax), 0)
    li = filter_indices(found)
    return li, r_idx[li]


def _join(left_keys: Sequence[Column], right_keys: Sequence[Column], how: str,
          nulls_equal: bool = True) -> Maps:
    if how != "inner" or len(left_keys) != 1 or len(right_keys) != 1:
        raise NotImplementedError(SORT_MERGE_MISSING)
    lc, rc = left_keys[0], right_keys[0]
    if lc.length == 0 or rc.length == 0:
        return _empty(lc.device)
    if nulls_equal and _both_sides_have_nulls(lc, rc):
        raise NotImplementedError(SORT_MERGE_MISSING)   # null rows must pair up
    fast = _try_radix_inner(lc, rc)
    if fast is None:
        fast = _try_dense_inner(lc, rc)
    if fast is not None:
        return fast
    # build on the left side when it is the one the tiers take (the
    # dim.merge(fact) shape), probe from the right, and restore left-row
    # order with build order inside: one sort of the (left, right) pairs
    fast = _try_radix_inner(rc, lc, preserve_order=False)
    if fast is None:
        fast = _try_dense_inner(rc, lc)
    if fast is None:
        raise NotImplementedError(SORT_MERGE_MISSING)
    ri, li = fast
    pair = torch.sort(li * rc.length + ri).values
    return pair // rc.length, pair % rc.length


def inner_join(left_keys: Sequence[Column], right_keys: Sequence[Column],
               nulls_equal: bool = True) -> Maps:
    """cudf::inner_join -> (left gather map, right gather map), int64.

    ``nulls_equal=True`` is the cudf/pandas merge semantic: null keys
    match null keys (which needs the sort-merge tier when both sides hold
    nulls)."""
    return _join(left_keys, right_keys, how="inner", nulls_equal=nulls_equal)
