"""Dictionary (categorical) encode and re-encode (port of
``cudf_tpu/ops/dictionary.py``: ``encode``, ``factorize``,
``match_dictionaries`` and ``set_keys``).

A dictionary column holds int32 codes into sorted, distinct keys (STRING,
numeric or temporal, no nulls).  ``encode`` and ``factorize`` sort the values once
(``row_ops``' lexicographic sort) and number the runs.  Two dictionaries
meet over the union of their keys: the keys alone are merged and each
column's codes go through one small remap table, so no row is decoded
(libcudf's ``match_dictionaries`` does the same).  The reference decodes
every row and re-encodes them, which drops keys no row uses; here such
keys stay, so the codes may differ from the reference's while the values
they stand for do not.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.ops import copying
from cudf_tpu_torch.ops._utils import inverse_permutation
from cudf_tpu_torch.ops.row_ops import equality_keys, lex_sort_indices
from cudf_tpu_torch.ops.stream_compaction import filter_indices


def encode(col: Column) -> Column:
    """A value column as DICTIONARY32: sorted distinct keys and int32 codes."""
    if col.dtype.is_dictionary:
        return col
    codes, keys = factorize(col, sort=True)
    return Column.from_dictionary(codes, keys, col.validity)


def factorize(col: Column, sort: bool = True) -> Tuple[torch.Tensor, Column]:
    """(int32 codes, distinct keys), the keys ascending (with ``sort``) or
    in order of first appearance.  A null row's code is 0, masked by the
    column's validity (pandas' -1 is the frame layer's)."""
    n, dev = col.length, col.device
    base = col.decode_dictionary() if col.dtype.is_dictionary else col
    if n == 0:
        return torch.zeros(0, dtype=torch.int32, device=dev), base
    order = lex_sort_indices([base])                    # nulls last, stable
    neq = torch.zeros(n, dtype=torch.bool, device=dev)
    neq[:1] = True
    for k in equality_keys(base):
        s = k[order]
        neq[1:] |= s[1:] != s[:-1]
    gid_sorted = torch.cumsum(neq, 0) - 1
    codes = gid_sorted[inverse_permutation(order)]
    has_nulls = base.validity is not None and bool((~base.validity).any())
    if base.validity is not None:
        codes = torch.where(base.validity, codes, 0)
    rep_rows = order[filter_indices(neq)]
    if has_nulls:                                       # the null run sorts last
        rep_rows = rep_rows[:-1]
    keys = copying.gather(base, rep_rows, bounds_check=False).with_validity(None)
    if not sort:
        appearance = torch.argsort(rep_rows)
        keys = copying.gather(keys, appearance, bounds_check=False)
        remap = inverse_permutation(appearance)
        codes = remap[codes.clamp(0, max(appearance.shape[0] - 1, 0))] if \
            appearance.shape[0] else codes
    return codes.to(torch.int32), keys


def _remap(col: Column, table: torch.Tensor, keys: Column) -> Column:
    codes = col.data.long()
    if col.validity is not None:
        codes = torch.where(col.validity, codes, 0)
    data = table[codes] if table.shape[0] else codes
    return Column.from_dictionary(data, keys, col.validity)


def unify_dictionaries(cols: Sequence[Column]) -> List[Column]:
    """The columns (dictionaries, or value columns, which are encoded) over
    one keys column, the sorted union of their keys."""
    cols = [encode(c) for c in cols]
    first = cols[0].keys
    if all(c.keys is first for c in cols):
        return cols
    all_keys = copying.concatenate([c.keys for c in cols])
    union = encode(all_keys)
    out, start = [], 0
    for c in cols:
        table = union.data[start:start + c.keys.length].long()
        out.append(_remap(c, table, union.keys))
        start += c.keys.length
    return out


def match_dictionaries(a: Column, b: Column) -> Tuple[Column, Column]:
    """Two dictionary columns re-encoded over the union of their keys
    (cudf::dictionary::match_dictionaries), so they compare by code."""
    ea, eb = unify_dictionaries([a, b])
    return ea, eb


def set_keys(col: Column, new_keys: Column) -> Column:
    """The codes re-encoded against ``new_keys`` (sorted and distinct,
    cudf::dictionary::set_keys); a value absent from them becomes null."""
    from cudf_tpu_torch.ops.search import first_match

    if col.dtype.is_dictionary:
        table = first_match(new_keys, col.keys)          # one search over the keys
        codes = col.data.long()
        if col.validity is not None:
            codes = torch.where(col.validity, codes, 0)
        pos = table[codes] if table.shape[0] else codes
    else:
        pos = first_match(new_keys, col)
    found = pos >= 0
    validity = found if col.validity is None else col.validity & found
    if bool(validity.all()):
        validity = None
    return Column.from_dictionary(pos.clamp(min=0), new_keys, validity)
