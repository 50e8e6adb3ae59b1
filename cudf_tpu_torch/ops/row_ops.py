"""Row-wise comparators and hashers over column sets (port of
``cudf_tpu/ops/row_ops.py`` for fixed-width, temporal, STRING and
DICTIONARY32 columns).

Every column is lowered to a short list of flat orderable tensors, the
"key operands":

- ``order_keys``: operands whose lexicographic ascending order is the
  requested row order (ascending or descending, nulls first or last).
  Floats map to order-preserving signed ints (NaN above +inf), unsigned
  ints to int64.
- ``equality_keys``: operands whose tuple equality is row equality with
  pandas' rules (null == null, NaN == NaN, -0.0 == +0.0).
- ``row_hash``: one 64-bit splitmix hash a row.

Temporal columns order as their int64 ticks.  A STRING column becomes
the reference's operands: its bytes packed big-endian into 8-byte int64
chunks (top bit flipped, so signed order is byte order), then its
length.  A dictionary column is not decoded: its operand is one int32 a
row, the rank of the row's key among the distinct keys in UTF-8 byte
order, gathered by code from a table of K ranks computed once a
dictionary (``dictionary_ranks``).  It gives the order the reference's
decoded strings give, and equal keys share a rank, so equality holds
even when a dictionary repeats a key.  (Row hashes of a dictionary
column therefore hash ranks, not the reference's decoded bytes.)

Every transform works on int8/int32/int64 tensors and ``.view``s, since
PyTorch's unsigned types have almost no bitwise or shift support on CUDA.
Unlike the reference, every NaN orders as the positive canonical NaN
(the reference orders a NaN with its sign bit set below -inf), and a
null row's value operand is 0 (the reference keeps the row's data there,
which orders null rows by it before a later key and splits a null
group).

torch has no variadic sort: ``lex_sort_indices`` is an LSD chain of
stable argsorts, one per operand, which gives the same permutation as
the reference's single stable ``lax.sort``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from cudf_tpu_torch.core.column import Column

_F64_NAN_BITS = 0x7FF8000000000000
_F32_NAN_BITS = 0x7FC00000


def _refuse_layout(col: Column) -> None:
    """LIST and STRUCT columns have no row order or row equality here, as
    in the reference (its operands read a data buffer they lack)."""
    if col.dtype.is_nested:
        raise NotImplementedError(
            f"row operators over {col.dtype!r} columns (sort, group or join keys): "
            "ROADMAP.md, beyond the reference")


def _limb_operands(col: Column) -> List[torch.Tensor]:
    """A two-limb decimal's value operands: the signed high limb, then the
    low limb with its top bit flipped (unsigned order as signed)."""
    return [col.children[0].data, col.data ^ (-(1 << 63))]


def string_chunks(col: Column, nchunks: Optional[int] = None) -> List[torch.Tensor]:
    """A STRING column's order operands: ceil(max_len / 8) int64 chunks of
    its bytes, big-endian with the top bit flipped (signed order is byte
    order; bytes past a row's end are 0), then the int64 length.  One
    host sync for the longest row unless ``nchunks`` is given."""
    starts = col.offsets[:-1]
    lens = col.offsets[1:] - starts
    if nchunks is None:
        nchunks = max(1, -(-int(lens.max()) // 8)) if col.length else 1
    chars = col.data if col.data.shape[0] else torch.zeros(1, dtype=torch.uint8,
                                                           device=col.device)
    out = []
    for c in range(nchunks):
        word = torch.zeros(col.length, dtype=torch.int64, device=col.device)
        for b in range(8):
            pos = c * 8 + b
            idx = (starts + pos).clamp(max=chars.shape[0] - 1)
            byte = torch.where(pos < lens, chars[idx].to(torch.int64), 0)
            # the first byte carries the flipped top bit: (byte - 128) * 2^56
            # is the signed value of its bits, with no shift into the sign
            word = word + (byte - 128 if b == 0 else byte) * (1 << (8 * (7 - b)))
        out.append(word)
    out.append(lens)
    return out


def string_compare(l: Column, r: Column) -> torch.Tensor:
    """int8 in {-1, 0, 1}: l's rows against r's in UTF-8 byte order (r may
    be one row, compared with every row of l)."""
    n = max(int((c.offsets[1:] - c.offsets[:-1]).max()) if c.length else 0 for c in (l, r))
    k = max(1, -(-n // 8))
    cmp = torch.zeros(l.length, dtype=torch.int8, device=l.device)
    for a, b in zip(string_chunks(l, k), string_chunks(r, k)):
        step = (a > b).to(torch.int8) - (a < b).to(torch.int8)
        cmp = torch.where(cmp == 0, step, cmp)
    return cmp


def dictionary_ranks(keys: Column) -> torch.Tensor:
    """int32[K]: each key's rank among the distinct keys, ascending (UTF-8
    byte order for strings), equal keys equal; computed on the keys'
    device with no host sync and cached on the keys column."""
    if "ranks" not in keys._cache:
        if keys.length == 0:
            ranks = torch.zeros(0, dtype=torch.int32, device=keys.device)
        else:
            ops = string_chunks(keys) if keys.dtype.is_string else _order_operands(
                keys, True, "last", narrow=False)
            order = lex_sort_permutation(ops)
            new = torch.zeros(keys.length, dtype=torch.int32, device=keys.device)
            for op in ops:
                s = op[order]
                new[1:] |= (s[1:] != s[:-1]).to(torch.int32)
            ranks = torch.empty_like(new)
            ranks[order] = torch.cumsum(new, 0, dtype=torch.int32)
        keys._cache["ranks"] = ranks
    return keys._cache["ranks"]


def _dictionary_operand(col: Column) -> torch.Tensor:
    codes = col.data if col.validity is None else torch.where(col.validity, col.data, 0)
    return dictionary_ranks(col.keys)[codes.long()]


def _canonical_float_bits(x: torch.Tensor) -> torch.Tensor:
    """Signed-int bits of x with -0.0 made +0.0 and every NaN the positive
    canonical NaN (int64 for float64, int32 for float32)."""
    x = torch.where(x == 0, torch.zeros_like(x), x)
    if x.dtype == torch.float64:
        return torch.where(torch.isnan(x), _F64_NAN_BITS, x.view(torch.int64))
    return torch.where(torch.isnan(x), _F32_NAN_BITS, x.view(torch.int32))


def _float_to_ordered_int(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving bijection of canonical floats to signed ints: a
    negative float's bits b become b ^ 0x7FFF...F, the others stay."""
    b = _canonical_float_bits(x)
    flip = 0x7FFFFFFFFFFFFFFF if b.dtype == torch.int64 else 0x7FFFFFFF
    return torch.where(b < 0, b ^ flip, b)


def _order_value(col: Column, narrow: bool) -> torch.Tensor:
    """The value operand of one column, ascending.  With narrow, integer
    columns of up to 32 bits sort as int32 (the same order, half the
    bytes); else every integer widens to int64, as in the reference."""
    d = col.data
    if col.dtype.is_dictionary:
        return _dictionary_operand(col)
    if col.dtype.is_float:
        return _float_to_ordered_int(d)
    if col.dtype.is_bool:
        return d.to(torch.int8)
    if d.dtype == torch.uint64:
        return d.view(torch.int64) ^ (-(1 << 63))
    if col.dtype.is_unsigned_integer:
        if narrow:
            return d.to(torch.int32 if d.element_size() <= 2 else torch.int64)
        return d.to(torch.int64) ^ (-(1 << 63))       # the reference's operand
    if narrow and d.element_size() <= 4:
        return d if d.dtype == torch.int32 else d.to(torch.int32)
    return d if d.dtype == torch.int64 else d.to(torch.int64)


def _order_operands(col: Column, ascending: bool, na_position: str,
                    narrow: bool) -> List[torch.Tensor]:
    _refuse_layout(col)
    ops: List[torch.Tensor] = []
    if col.dtype.is_string:
        if col.validity is not None:
            flag = (~col.validity).to(torch.int8)
            ops.append(-flag if na_position == "first" else flag)
        for c in string_chunks(col):
            c = c if col.validity is None else torch.where(col.validity, c, 0)
            ops.append(c if ascending else ~c)
        return ops
    if col.dtype.is_decimal and col.children:
        if col.validity is not None:
            flag = (~col.validity).to(torch.int8)
            ops.append(-flag if na_position == "first" else flag)
        for v in _limb_operands(col):
            v = v if col.validity is None else torch.where(col.validity, v, 0)
            ops.append(v if ascending else ~v)
        return ops
    v = _order_value(col, narrow)
    if col.validity is not None:
        flag = (~col.validity).to(torch.int8)
        ops.append(-flag if na_position == "first" else flag)
        # null rows tie on the value of 0, so a later key orders them (the
        # reference leaves their data here and splits a null group)
        d_flip = col.data.dtype == torch.uint64 or (
            col.dtype.is_unsigned_integer and not narrow)
        v = torch.where(col.validity, v, -(1 << 63) if d_flip else 0)
    ops.append(v if ascending else ~v)
    return ops


def order_keys(col: Column, ascending: bool = True,
               na_position: str = "last") -> List[torch.Tensor]:
    """Operands whose lexicographic ascending order is this column's
    requested order: an int8 null flag when the column has a mask, then
    the value (int64, or int32 for float32, int8 for bool)."""
    return _order_operands(col, ascending, na_position, narrow=False)


def equality_keys(col: Column, nchunks: Optional[int] = None) -> List[torch.Tensor]:
    """Operands whose tuple equality is row equality (pandas' null and NaN
    rules): the validity as int8 when masked, then the value with nulls
    zeroed (floats as canonical bits, uint64 as its int64 view, uint16 and
    uint32 widened to int64; a STRING column's ``nchunks`` chunks, by
    default as many as its longest row needs, then its length)."""
    _refuse_layout(col)
    ops: List[torch.Tensor] = []
    if col.validity is not None:
        ops.append(col.validity.to(torch.int8))
    if col.dtype.is_string:
        chunks = string_chunks(col, nchunks)
        return ops + (chunks if col.validity is None else
                      [torch.where(col.validity, c, 0) for c in chunks])
    if col.dtype.is_decimal and col.children:
        limbs = _limb_operands(col)
        return ops + (limbs if col.validity is None else
                      [torch.where(col.validity, v, 0) for v in limbs])
    if col.dtype.is_dictionary:
        v = _dictionary_operand(col)
    elif col.dtype.is_float:
        v = _canonical_float_bits(col.data)
    elif col.data.dtype == torch.uint64:
        v = col.data.view(torch.int64)
    elif col.data.dtype in (torch.uint16, torch.uint32):
        v = col.data.long()              # torch sorts no uint16/uint32
    else:
        v = col.data
    if col.validity is not None:
        v = torch.where(col.validity, v, torch.zeros_like(v))
    ops.append(v)
    return ops


# ----------------------------------------------------------------------
# row hashing: splitmix64 in int64 arithmetic (multiplication and
# addition wrap as they do in uint64; logical right shifts are
# arithmetic shifts masked to the bits they keep)
# ----------------------------------------------------------------------

def _s64(u: int) -> int:
    """A uint64 constant as the int64 of the same bits."""
    return u - (1 << 64) if u >= 1 << 63 else u


_M1 = _s64(0xFF51AFD7ED558CCD)
_M2 = _s64(0xC4CEB9FE1A85EC53)
_GOLDEN = _s64(0x9E3779B97F4A7C15)
_SEED_MIX = 0x243F6A8885A308D3


def _shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bits."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def _mix64(x: torch.Tensor) -> torch.Tensor:
    x = x ^ _shr(x, 33)
    x = x * _M1
    x = x ^ _shr(x, 33)
    x = x * _M2
    return x ^ _shr(x, 33)


def _hash_combine(h: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    return h ^ (_mix64(k) + _GOLDEN + (h << 6) + _shr(h, 2))


def _to_i64(k: torch.Tensor) -> torch.Tensor:
    """The value's uint64 hash input as int64 bits: signed values sign
    extend, bool and unsigned values zero extend."""
    if k.dtype == torch.int64:
        return k
    return k.to(torch.int64)


def _seed_row(n: int, seed: int, device) -> torch.Tensor:
    return torch.full((n,), _s64((seed ^ _SEED_MIX) & ((1 << 64) - 1)), dtype=torch.int64,
                      device=device)


def hash_column(col: Column, seed: int = 0) -> torch.Tensor:
    """Per-row hash of one column: the reference's uint64 bits, held in an
    int64 tensor (``.view(torch.uint64)`` reads them unsigned)."""
    return row_hash([col], seed)


def row_hash(cols: Sequence[Column], seed: int = 0) -> torch.Tensor:
    """Combined per-row hash over key columns, bit for bit the reference's
    ``row_hash``, held in an int64 tensor."""
    cols = list(cols)
    h = _seed_row(cols[0].length, seed, cols[0].device)
    for col in cols:
        for k in equality_keys(col):
            h = _hash_combine(h, _to_i64(k))
    return h


def rows_equal_at(cols: Sequence[Column], left_idx: torch.Tensor,
                  right_idx: torch.Tensor) -> torch.Tensor:
    """bool[m]: rows(left_idx) == rows(right_idx) under pandas equality."""
    eq = None
    for col in cols:
        for k in equality_keys(col):
            e = k[left_idx] == k[right_idx]
            eq = e if eq is None else eq & e
    return eq


def lex_sort_permutation(operands: Sequence[torch.Tensor]) -> torch.Tensor:
    """The stable lexicographic argsort of operand tuples: a stable argsort
    of the last operand, then for each earlier one a gather and another
    stable argsort, composing the permutations (int64)."""
    perm = None
    for op in reversed(list(operands)):
        if perm is None:
            perm = torch.argsort(op, stable=True)
        else:
            perm = perm[torch.argsort(op[perm], stable=True)]
    return perm


def sort_operands(cols: Sequence[Column], ascending: Optional[Sequence[bool]] = None,
                  na_position: str = "last") -> List[torch.Tensor]:
    """``order_keys`` of each column, integers of up to 32 bits left in
    int32: the operands ``lex_sort_indices`` sorts."""
    cols = list(cols)
    if ascending is None:
        ascending = [True] * len(cols)
    ops: List[torch.Tensor] = []
    for col, asc in zip(cols, ascending):
        ops.extend(_order_operands(col, asc, na_position, narrow=True))
    return ops


def lex_sort_indices(cols: Sequence[Column], ascending: Optional[Sequence[bool]] = None,
                     na_position: str = "last") -> torch.Tensor:
    """Stable lexicographic argsort over columns (int64): equal to the
    reference's stable permutation."""
    cols = list(cols)
    if cols[0].length == 0:
        return torch.zeros(0, dtype=torch.int64, device=cols[0].device)
    return lex_sort_permutation(sort_operands(cols, ascending, na_position))
