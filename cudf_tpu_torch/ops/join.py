"""Joins: inner, left, full, semi, anti, cross, the mixed joins and a
reusable build (port of ``cudf_tpu/ops/join.py``).  Every join returns
int64 gather maps; -1 marks a row without a partner, which a
bounds-checked gather turns into nulls.

``_join`` dispatches as the reference's ``_join`` (``:445``) does:

- dictionary keys on both sides join as int32 codes in one code space
  (``_dict_code_pair``: the smaller side's dictionary is matched against
  the larger's, and its codes recoded), so they reach the kernel tiers;
- an inner join on one integer key, unless both sides hold nulls that
  must pair up, tries the kernel tiers with the right side as the build
  side: the radix tier (kernels B, F, G, D and H,
  ``kernels/radix_partition.py``) for a build side with at most
  ``join.multi_fan_out_max`` rows a key over at most 2^27 key values,
  from ``join.fast_path_min_rows`` probe rows up, then the dense tier (a
  unique build side over a dense domain, one table gather a probe row);
- then the same tiers with the left side as the build side;
- everything else takes the sort-merge tier: the right side's key
  operands (``row_ops.equality_keys``) are sorted once, each left row
  finds its match range [lo, hi) by binary search, and one host sync
  sizes the expansion of the ranges into pairs.

Pairs come in left-row order, with right-row order inside each left row
(the pandas merge order); a full join appends the right rows without a
match, in right-row order.  ``nulls_equal=True`` (cudf and pandas merge)
pairs null keys with null keys; ``nulls_equal=False`` (the engine's
polars default) matches no null key.  The sort-merge tier is
``torch.sort``, ``torch.searchsorted`` and stable argsorts: the
reference's tier reaches no TPU kernel, and this one adds none.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.kernels.radix_partition import (MAX_DOMAIN_BITS,
                                                    radix_join_inner_multi,
                                                    radix_join_inner_unique)
from cudf_tpu_torch.ops._utils import dense_key_table, dense_probe, segment_expand
from cudf_tpu_torch.ops.row_ops import equality_keys, lex_sort_permutation
from cudf_tpu_torch.ops.stream_compaction import filter_indices
from cudf_tpu_torch.utils.config import get_option

Maps = Tuple[torch.Tensor, torch.Tensor]


def _empty(device) -> Maps:
    z = torch.zeros(0, dtype=torch.int64, device=device)
    return z, z


def _none(n: int, device) -> torch.Tensor:
    return torch.full((n,), -1, dtype=torch.int64, device=device)


# ----------------------------------------------------------------------
# key operands aligned across the two sides
# ----------------------------------------------------------------------

def _searchable(op: torch.Tensor) -> torch.Tensor:
    """An operand torch.sort and torch.searchsorted take on every device:
    int32 or int64 (bool and 8- and 16-bit operands widen to int32)."""
    return op if op.dtype in (torch.int32, torch.int64) else op.to(torch.int32)


def _aligned_keys(left: Sequence[Column], right: Sequence[Column],
                  nulls_equal: bool = False) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Equality operands of both sides, pairwise of one dtype."""
    l_ops: List[torch.Tensor] = []
    r_ops: List[torch.Tensor] = []
    for lc, rc in zip(left, right):
        for a, b in zip(*_align_pair(lc, rc, nulls_equal=nulls_equal)):
            a, b = _searchable(a), _searchable(b)
            if a.dtype != b.dtype:
                a, b = a.long(), b.long()
            l_ops.append(a)
            r_ops.append(b)
    return l_ops, r_ops


def _dict_code_pair(a: Column, b: Column) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """int32 codes of two dictionary columns in one code space, or None
    when they are not both dictionaries over keys of one dtype.

    The smaller column's dictionary is matched against the larger's (a
    sort and a search over the keys), and only the smaller column's codes
    are gathered through the remap: the larger column's codes are used as
    they are.  A key absent from the larger dictionary becomes -1, which
    no code of the larger side equals.  Null rows keep their columns'
    validity; the caller masks them."""
    if not (a.dtype.is_dictionary and b.dtype.is_dictionary):
        return None
    ak, bk = a.keys, b.keys
    if ak.dtype != bk.dtype:
        return None
    acodes, bcodes = a.data.to(torch.int32), b.data.to(torch.int32)
    if ak is bk:
        return acodes, bcodes
    swap = a.length < b.length
    big, small = (b, a) if swap else (a, b)
    if small.keys.length == 0 or big.keys.length == 0:
        remap = _none(max(small.keys.length, 1), a.device).to(torch.int32)
    else:
        # strings in one chunk count on both sides: bytes, then length,
        # decide ("a" differs from "a\x00", as in pandas)
        big_ops, small_ops = _aligned_keys([big.keys], [small.keys])
        order, lo, hi = _probe_ranges(small_ops, big_ops)
        remap = torch.where(hi > lo, order[lo.clamp(max=order.shape[0] - 1)], -1
                            ).to(torch.int32)
    sc = small.data.long() if small.validity is None else torch.where(
        small.validity, small.data, 0).long()
    small_codes = remap[sc.clamp(0, remap.shape[0] - 1)]
    return (small_codes, bcodes) if swap else (acodes, small_codes)


def _chunk_count(*cols: Column) -> int:
    """The 8-byte chunks the longest row of these STRING columns needs
    (one host sync)."""
    lens = [(c.offsets[1:] - c.offsets[:-1]).max() for c in cols if c.length]
    longest = int(torch.stack(lens).max()) if lens else 0
    return max(1, -(-longest // 8))


def _align_pair(a: Column, b: Column, nulls_equal: bool = False
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """One key column pair in a common dtype, as equality operands.  With
    nulls_equal both sides carry a validity operand (a null row equals a
    null row and no value); else null rows are the caller's to mask."""
    codes = _dict_code_pair(a, b)
    if codes is not None:
        a = Column(dt.INT32, a.length, codes[0], a.validity)
        b = Column(dt.INT32, b.length, codes[1], b.validity)
    elif a.dtype != b.dtype or a.dtype.is_dictionary:
        # dictionaries over keys of different dtypes, or a dictionary
        # beside another layout: the decoded values
        a, b = a.decode_dictionary(), b.decode_dictionary()
        if a.dtype != b.dtype:
            if a.dtype.is_string != b.dtype.is_string:
                raise TypeError(f"cannot join a {a.dtype!r} key with a {b.dtype!r} key")
            from cudf_tpu_torch.ops.unary import cast

            target = dt.common_dtype(a.dtype, b.dtype)
            a, b = cast(a, target), cast(b, target)
    if nulls_equal and (a.validity is not None or b.validity is not None):
        a = a.with_validity(_valid(a))
        b = b.with_validity(_valid(b))
    else:
        a, b = a.with_validity(None), b.with_validity(None)
    if a.dtype.is_string:
        k = _chunk_count(a, b)
        return equality_keys(a, nchunks=k), equality_keys(b, nchunks=k)
    return equality_keys(a), equality_keys(b)


def _valid(col: Column) -> torch.Tensor:
    if col.validity is not None:
        return col.validity
    return torch.ones(col.length, dtype=torch.bool, device=col.device)


def _null_row_mask(cols: Sequence[Column]) -> Optional[torch.Tensor]:
    """bool[n], True where any key is null (such rows never match), or
    None when no key column has a mask."""
    mask = None
    for c in cols:
        if c.validity is not None:
            mask = ~c.validity if mask is None else mask | ~c.validity
    return mask


def _both_sides_have_nulls(lc: Column, rc: Column) -> bool:
    """True when both key columns hold nulls (host syncs only when both
    carry validity masks)."""
    if lc.validity is None or rc.validity is None:
        return False
    return bool(torch.stack([(~lc.validity).any(), (~rc.validity).any()]).all())


# ----------------------------------------------------------------------
# the sort-merge machinery
# ----------------------------------------------------------------------

def _sorted_build(r_ops: List[torch.Tensor]) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """(the operands in ascending lexicographic order, the stable order)."""
    if len(r_ops) == 1:
        s, order = torch.sort(r_ops[0], stable=True)
        return [s], order
    order = lex_sort_permutation(r_ops)
    return [op[order] for op in r_ops], order


def _probe_ranges(l_ops: List[torch.Tensor], r_ops: List[torch.Tensor]
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(right order, lo, hi): the right rows sorted once; left row i
    matches the right rows at sorted positions [lo[i], hi[i])."""
    r_sorted, r_order = _sorted_build(r_ops)
    return (r_order, _lex_searchsorted(r_sorted, l_ops, "left"),
            _lex_searchsorted(r_sorted, l_ops, "right"))


def _lex_searchsorted(sorted_ops: List[torch.Tensor], needle_ops: List[torch.Tensor],
                      side: str) -> torch.Tensor:
    """Insertion points (int64) of the needles' operand tuples in the
    sorted haystack's, as torch.searchsorted gives for one operand.

    With more than one operand the haystack and needles are sorted
    together, with a tie operand that puts a needle before (side "left")
    or after ("right") the haystack rows equal to it; a needle's
    insertion point is its sorted position less the needles before it.
    The stable sort's permutation is the tag: positions at or above the
    haystack's length are needles."""
    if len(sorted_ops) == 1:
        return torch.searchsorted(sorted_ops[0], needle_ops[0], right=side == "right")
    nh, nn = sorted_ops[0].shape[0], needle_ops[0].shape[0]
    dev = sorted_ops[0].device
    operands = [torch.cat([h, n]) for h, n in zip(sorted_ops, needle_ops)]
    needle_tie = 0 if side == "left" else 1
    tie = torch.cat([torch.full((nh,), 1 - needle_tie, dtype=torch.int8, device=dev),
                     torch.full((nn,), needle_tie, dtype=torch.int8, device=dev)])
    perm = lex_sort_permutation([*operands, tie])
    is_needle = perm >= nh
    before = torch.cumsum(is_needle, 0) - is_needle.long()
    insert = torch.arange(nh + nn, device=dev) - before
    # haystack rows park on the sentinel slot nn, so that duplicate
    # indices land only where nothing is read
    res = torch.zeros(nn + 1, dtype=torch.int64, device=dev)
    res[torch.where(is_needle, perm - nh, nn)] = insert
    return res[:nn]


def _expand_matches(counts: torch.Tensor, lo: torch.Tensor, r_order: torch.Tensor,
                    keep_unmatched_left: bool) -> Maps:
    """counts[i] matches of left row i from sorted right position lo[i]
    -> (left rows, right rows); with keep_unmatched_left a row without a
    match appears once, its right row -1.  One host sync for the total."""
    emit = counts.clamp(min=1) if keep_unmatched_left else counts
    offsets = torch.cat([torch.zeros(1, dtype=torch.int64, device=counts.device),
                         torch.cumsum(emit, 0)])
    total = int(offsets[-1])
    if total == 0:
        return _empty(counts.device)
    row = segment_expand(offsets, total)
    within = torch.arange(total, device=counts.device) - offsets[row]
    pos = lo[row] + within
    nr = r_order.shape[0]
    right = torch.where(counts[row] > 0, r_order[pos.clamp(0, max(nr - 1, 0))]
                        if nr else pos, -1)
    return row, right


def _restricted_right(r_ops: List[torch.Tensor], right_keys: Sequence[Column],
                      nulls_equal: bool):
    """The right operands the sort-merge tier matches against, and the
    right rows they stand for (None: all of them): without nulls_equal,
    right rows with a null key are left out."""
    r_null = None if nulls_equal else _null_row_mask(right_keys)
    if r_null is None:
        return r_ops, None
    keep_r = filter_indices(~r_null)
    return [k[keep_r] for k in r_ops], keep_r


def _unrestrict(right: torch.Tensor, keep_r: Optional[torch.Tensor]) -> torch.Tensor:
    if keep_r is None:
        return right
    return torch.where(right >= 0, keep_r[right.clamp(min=0)], -1)


def _sort_merge(left_keys: Sequence[Column], right_keys: Sequence[Column],
                keep_left: bool, nulls_equal: bool) -> Maps:
    l_ops, r_ops = _aligned_keys(left_keys, right_keys, nulls_equal=nulls_equal)
    r_ops, keep_r = _restricted_right(r_ops, right_keys, nulls_equal)
    r_order, lo, hi = _probe_ranges(l_ops, r_ops)
    counts = hi - lo
    l_null = None if nulls_equal else _null_row_mask(left_keys)
    if l_null is not None:
        counts = torch.where(l_null, 0, counts)
    li, ri = _expand_matches(counts, lo, r_order, keep_left)
    return li, _unrestrict(ri, keep_r)


# ----------------------------------------------------------------------
# the kernel and dense tiers (inner joins on one integer key)
# ----------------------------------------------------------------------

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
    if not (lc.dtype.is_integer and rc.dtype.is_integer) or dt.UINT64 in (lc.dtype, rc.dtype):
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
    which the reference leaves to its sort-merge tier."""
    if not get_option("join.dense_fast_path"):
        return None
    if not (lc.dtype.is_integer and rc.dtype.is_integer) or dt.UINT64 in (lc.dtype, rc.dtype):
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


def _try_kernel_tiers(lc: Column, rc: Column) -> Optional[Maps]:
    """An inner join on one key through the radix and dense tiers: the
    right side as the build side, then the left (probing from the right,
    and restoring left-row order with right order inside by one sort of
    the pairs); None when neither orientation qualifies."""
    fast = _try_radix_inner(lc, rc)
    if fast is None:
        fast = _try_dense_inner(lc, rc)
    if fast is not None:
        return fast
    fast = _try_radix_inner(rc, lc, preserve_order=False)
    if fast is None:
        fast = _try_dense_inner(rc, lc)
    if fast is None:
        return None
    ri, li = fast
    pair = torch.sort(li * rc.length + ri).values
    return pair // rc.length, pair % rc.length


# ----------------------------------------------------------------------
# the joins
# ----------------------------------------------------------------------

def _join(left_keys: Sequence[Column], right_keys: Sequence[Column], how: str,
          nulls_equal: bool = True) -> Maps:
    if how not in ("inner", "left", "outer"):
        raise ValueError(f"unknown join how={how!r}")
    left_keys, right_keys = list(left_keys), list(right_keys)
    if len(left_keys) != len(right_keys) or not left_keys:
        raise ValueError("a join needs the same number (at least one) of key columns a side")
    nl, nr = left_keys[0].length, right_keys[0].length
    dev = left_keys[0].device
    if len(left_keys) == 1:
        # dictionary keys join as codes in one code space, which also
        # qualifies them for the kernel tiers
        codes = _dict_code_pair(left_keys[0], right_keys[0])
        if codes is not None:
            left_keys = [Column(dt.INT32, nl, codes[0], left_keys[0].validity)]
            right_keys = [Column(dt.INT32, nr, codes[1], right_keys[0].validity)]
    if how == "inner":
        if nl == 0 or nr == 0:
            return _empty(dev)
        # the kernel tiers leave null rows out, which is exact unless
        # null keys must pair up across the two sides
        if len(left_keys) == 1 and not (
                nulls_equal and _both_sides_have_nulls(left_keys[0], right_keys[0])):
            fast = _try_kernel_tiers(left_keys[0], right_keys[0])
            if fast is not None:
                return fast
    elif nl == 0 and how == "left":
        return _empty(dev)
    elif nr == 0:
        return torch.arange(nl, device=dev), _none(nl, dev)
    elif nl == 0:                                  # an outer join of an empty left side
        return _none(nr, dev), torch.arange(nr, device=dev)
    li, ri = _sort_merge(left_keys, right_keys, how in ("left", "outer"), nulls_equal)
    if how == "outer":
        # the right rows no pair holds, at the end in right-row order (a
        # scatter into nr + 1 slots: the -1s park on the last one)
        matched = torch.zeros(nr + 1, dtype=torch.bool, device=dev)
        matched[torch.where(ri >= 0, ri, nr)] = True
        unmatched = filter_indices(~matched[:nr])
        li = torch.cat([li, _none(unmatched.shape[0], dev)])
        ri = torch.cat([ri, unmatched])
    return li, ri


def inner_join(left_keys: Sequence[Column], right_keys: Sequence[Column],
               nulls_equal: bool = True) -> Maps:
    """cudf::inner_join -> (left gather map, right gather map), int64."""
    return _join(left_keys, right_keys, how="inner", nulls_equal=nulls_equal)


def left_join(left_keys: Sequence[Column], right_keys: Sequence[Column],
              nulls_equal: bool = True) -> Maps:
    """cudf::left_join: every left row, its right map -1 without a match."""
    return _join(left_keys, right_keys, how="left", nulls_equal=nulls_equal)


def full_join(left_keys: Sequence[Column], right_keys: Sequence[Column],
              nulls_equal: bool = True) -> Maps:
    """cudf::full_join: the left join's pairs, then the unmatched right
    rows with left map -1."""
    return _join(left_keys, right_keys, how="outer", nulls_equal=nulls_equal)


def _match_mask(left_keys: Sequence[Column], right_keys: Sequence[Column],
                nulls_equal: bool = True) -> torch.Tensor:
    """bool[nl]: whether each left row has a match (the sort-merge tier)."""
    left_keys, right_keys = list(left_keys), list(right_keys)
    l_ops, r_ops = _aligned_keys(left_keys, right_keys, nulls_equal=nulls_equal)
    r_ops, _ = _restricted_right(r_ops, right_keys, nulls_equal)
    _, lo, hi = _probe_ranges(l_ops, r_ops)
    mask = hi > lo
    l_null = None if nulls_equal else _null_row_mask(left_keys)
    return mask if l_null is None else mask & ~l_null


def semi_join(left_keys: Sequence[Column], right_keys: Sequence[Column],
              nulls_equal: bool = True) -> torch.Tensor:
    """cudf::left_semi_join: the left rows with at least one match, in order."""
    return filter_indices(_match_mask(left_keys, right_keys, nulls_equal))


def anti_join(left_keys: Sequence[Column], right_keys: Sequence[Column],
              nulls_equal: bool = True) -> torch.Tensor:
    """cudf::left_anti_join: the left rows without a match, in order."""
    return filter_indices(~_match_mask(left_keys, right_keys, nulls_equal))


def cross_join(nl: int, nr: int, *, device) -> Maps:
    """Every (left, right) pair, left-major, as maps on ``device``."""
    left = torch.arange(nl, device=device).repeat_interleave(nr)
    right = torch.arange(nr, device=device).repeat(nl)
    return left, right


def merge_sorted(key_cols_list: Sequence[Sequence[Column]], ascending=None,
                 na_position: str = "last") -> torch.Tensor:
    """cudf::merge of tables already sorted by their keys: the gather map
    into their concatenation (one stable lexicographic sort of it)."""
    from cudf_tpu_torch.ops import copying
    from cudf_tpu_torch.ops.row_ops import lex_sort_indices

    cols = [copying.concatenate([t[i] for t in key_cols_list])
            for i in range(len(key_cols_list[0]))]
    return lex_sort_indices(cols, ascending=ascending, na_position=na_position)


# ----------------------------------------------------------------------
# mixed joins: equality pairs narrowed by a predicate over them
# ----------------------------------------------------------------------

def _mixed_pairs(left_keys, right_keys, predicate):
    li, ri = inner_join(left_keys, right_keys)
    if li.shape[0] == 0:
        return li, ri, torch.zeros(0, dtype=torch.bool, device=li.device)
    m = predicate(li, ri)
    if isinstance(m, Column):
        mb = m.data.to(torch.bool)
        m = mb if m.validity is None else mb & m.validity
    return li, ri, m.to(torch.bool)


def _matched_left(nl: int, li: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """bool[nl]: the left rows with a surviving pair."""
    matched = torch.zeros(nl + 1, dtype=torch.bool, device=li.device)
    matched[torch.where(m, li, nl)] = True
    return matched[:nl]


def mixed_inner_join(left_keys, right_keys, predicate) -> Maps:
    """(left map, right map) of the equality pairs for which
    ``predicate(li, ri) -> bool[k]`` (or a BOOL8 Column) holds."""
    li, ri, m = _mixed_pairs(left_keys, right_keys, predicate)
    keep = filter_indices(m)
    return li[keep], ri[keep]


def mixed_left_join(left_keys, right_keys, predicate) -> Maps:
    """The surviving pairs, then each left row without one (right map -1)."""
    nl = left_keys[0].length
    li, ri, m = _mixed_pairs(left_keys, right_keys, predicate)
    keep = filter_indices(m)
    unmatched = filter_indices(~_matched_left(nl, li, m))
    return (torch.cat([li[keep], unmatched]),
            torch.cat([ri[keep], _none(unmatched.shape[0], li.device)]))


def mixed_semi_join(left_keys, right_keys, predicate) -> torch.Tensor:
    """The left rows with at least one surviving pair."""
    li, _, m = _mixed_pairs(left_keys, right_keys, predicate)
    return filter_indices(_matched_left(left_keys[0].length, li, m))


def mixed_anti_join(left_keys, right_keys, predicate) -> torch.Tensor:
    """The left rows without a surviving pair."""
    li, _, m = _mixed_pairs(left_keys, right_keys, predicate)
    return filter_indices(~_matched_left(left_keys[0].length, li, m))


# ----------------------------------------------------------------------
# a build side sorted once, probed many times
# ----------------------------------------------------------------------

class HashJoin:
    """cudf::hash_join: the build side's state kept across probes; here
    its sorted key operands, searched by each probe.

    >>> hj = HashJoin(right_key_columns)
    >>> li, ri = hj.inner_join(probe_keys)      # repeatable, build reused
    """

    def __init__(self, build_keys: Sequence[Column], nulls_equal: bool = True):
        self._build_keys = list(build_keys)
        self.num_build_rows = self._build_keys[0].length if self._build_keys else 0
        self._nulls_equal = nulls_equal
        self._last = None         # (signature, probe dictionaries, sorted state)

    def _state_for(self, probe_keys):
        probe_keys = list(probe_keys)
        l_ops, r_ops = _aligned_keys(probe_keys, self._build_keys,
                                     nulls_equal=self._nulls_equal)
        # a probe's dictionary decides the build side's codes when the
        # build side is the smaller one: the last probe's dictionaries are
        # kept and the sort is reused only for these same objects
        sig = tuple((o.dtype, o.shape) for o in r_ops)
        dicts = [c.keys if c.dtype.is_dictionary else None for c in probe_keys]
        last = self._last
        if last is None or last[0] != sig or any(a is not b for a, b in zip(last[1], dicts)):
            r_ops, keep_r = _restricted_right(r_ops, self._build_keys, self._nulls_equal)
            r_sorted, r_order = _sorted_build(r_ops)
            self._last = last = (sig, dicts, (r_sorted, r_order, keep_r))
        return l_ops, last[2]

    def _ranges(self, probe_keys):
        l_ops, (r_sorted, r_order, keep_r) = self._state_for(probe_keys)
        lo = _lex_searchsorted(r_sorted, l_ops, "left")
        counts = _lex_searchsorted(r_sorted, l_ops, "right") - lo
        if not self._nulls_equal:
            l_null = _null_row_mask(list(probe_keys))
            if l_null is not None:
                counts = torch.where(l_null, 0, counts)
        return counts, lo, r_order, keep_r

    def _expand(self, probe_keys, keep_unmatched):
        counts, lo, r_order, keep_r = self._ranges(probe_keys)
        li, ri = _expand_matches(counts, lo, r_order, keep_unmatched)
        return li, _unrestrict(ri, keep_r)

    def inner_join(self, probe_keys) -> Maps:
        return self._expand(probe_keys, keep_unmatched=False)

    def left_join(self, probe_keys) -> Maps:
        return self._expand(probe_keys, keep_unmatched=True)

    def semi_join(self, probe_keys) -> torch.Tensor:
        return filter_indices(self._ranges(probe_keys)[0] > 0)

    def anti_join(self, probe_keys) -> torch.Tensor:
        return filter_indices(self._ranges(probe_keys)[0] == 0)


class DistinctHashJoin(HashJoin):
    """cudf::distinct_hash_join: a build side with unique keys, so a
    probe row has at most one match and no expansion is needed."""

    def inner_join(self, probe_keys) -> Maps:
        counts, lo, r_order, keep_r = self._ranges(probe_keys)
        li = filter_indices(counts > 0)
        ri = r_order[lo[li].clamp(0, max(r_order.shape[0] - 1, 0))]
        return li, ri if keep_r is None else keep_r[ri]
