"""Column hash functions (port of ``cudf_tpu/ops/hashing.py``).

- ``murmurhash3_x86_32`` and ``xxhash_64``: the published algorithms,
  bit for bit the reference's (per-column hashes combined by boost's
  ``hash_combine``, a null row hashing to 0), on the column's device.
  PyTorch has no uint32/uint64 arithmetic on CUDA, so both compute in
  int64: murmur3's 32-bit words are masked to 32 bits after each multiply
  and add (int64's wrapping product keeps the low 64 bits, so the low 32
  are exact), xxhash64 relies on int64's wrapping multiply and add, and a
  logical right shift is an arithmetic one masked to the bits it keeps.
  Results are UINT32 / UINT64 columns, as the reference gives them.
- A fixed-width column hashes its values' little-endian bytes as words
  (one or two 4-byte blocks, or a 1- or 2-byte tail; one or two 8-byte
  lanes or a 4-byte lane), never as a byte matrix.  A STRING column hashes
  a padded [rows, longest row] byte matrix, taken ``CHUNK_BYTES`` at a
  time (one host sync for the longest row).  A dictionary hashes its
  decoded values; a decimal its unscaled value as int64; bool one byte.
- ``checksum`` (md5, sha1, sha224, sha256, sha384, sha512): the
  reference's host tier (hashlib over each row's bytes, nulls skipped), a
  counted host route (``ops/_utils.py`` ``HOST_ROUTES``).

The internal row hash of joins, groupbys and partitioning stays
``ops/row_ops.py`` ``row_hash`` (splitmix64).
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence, Tuple

import torch

from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.ops._utils import count_host_route
from cudf_tpu_torch.ops.row_ops import _s64, _shr
from cudf_tpu_torch.utils import tracing

__all__ = ["murmurhash3_x86_32", "xxhash_64", "hash_values", "checksum"]

M32 = 0xFFFFFFFF
# a STRING column's padded byte matrix is built this many bytes at a time
CHUNK_BYTES = 1 << 26


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def _rotl64(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | _shr(x, 64 - r)


def as_uint32(h: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) as the uint32 tensor of the same bits."""
    return torch.where(h >= 1 << 31, h - (1 << 32), h).to(torch.int32).view(torch.uint32)


def _fixed_words(col: Column) -> Tuple[torch.Tensor, int]:
    """(the values' bits as int64 (zero extended), their byte width)."""
    if col.dtype.is_bool:
        return col.data.long(), 1
    if col.dtype.is_decimal:
        return col.data.long(), 8
    data = col.data
    width = data.element_size()
    signed = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[width]
    bits = data.view(signed).long()
    return (bits if width == 8 else bits & ((1 << (8 * width)) - 1)), width


def _string_chunks(col: Column):
    """(row start, row stop, [rows, m] int64 byte matrix, int64 lengths) of
    a STRING column, a chunk of rows at a time (bytes past a row's end are
    zero)."""
    lens = col.offsets[1:] - col.offsets[:-1]
    longest = max(tracing.to_int(lens.max(), "string_width") if col.length else 0, 4)
    step = max(1, CHUNK_BYTES // longest)
    cols = torch.arange(longest, device=col.device)
    for lo in range(0, col.length, step):
        hi = min(col.length, lo + step)
        starts = col.offsets[lo:hi]
        pos = starts[:, None] + cols[None, :]
        inside = cols[None, :] < lens[lo:hi, None]
        chars = col.data[torch.clamp(pos, max=max(col.data.shape[0] - 1, 0))] \
            if col.data.shape[0] else torch.zeros(pos.shape, dtype=torch.uint8,
                                                  device=col.device)
        yield lo, hi, torch.where(inside, chars.long(), 0), lens[lo:hi]


def _per_column(col: Column, fixed, rows):
    """A column's per-row hash: ``fixed(words, width)`` of fixed-width
    values, ``rows(byte matrix, lengths)`` of strings chunk by chunk, 0 at
    null rows."""
    if col.dtype.is_dictionary:
        return _per_column(col.decode_dictionary(), fixed, rows)
    if col.dtype.is_string:
        h = torch.empty(col.length, dtype=torch.int64, device=col.device)
        for lo, hi, mat, lens in _string_chunks(col):
            h[lo:hi] = rows(mat, lens)
    elif col.dtype.is_nested:
        raise TypeError(f"cannot hash a {col.dtype!r} column")
    else:
        h = fixed(*_fixed_words(col))
    return h if col.validity is None else torch.where(col.validity, h, 0)


# ----------------------------------------------------------------------
# MurmurHash3_x86_32
# ----------------------------------------------------------------------

_C1, _C2 = 0xCC9E2D51, 0x1B873593


def _mix_k1(k1: torch.Tensor) -> torch.Tensor:
    return (_rotl32((k1 * _C1) & M32, 15) * _C2) & M32


def _mix_h(h: torch.Tensor, k1: torch.Tensor) -> torch.Tensor:
    return (_rotl32(h ^ k1, 13) * 5 + 0xE6546B64) & M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & M32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & M32
    return h ^ (h >> 16)


def _murmur_fixed(seed: int):
    def run(words: torch.Tensor, width: int) -> torch.Tensor:
        h = torch.full_like(words, seed & M32)
        if width < 4:                       # one tail block
            h = h ^ _mix_k1(words)
        else:
            for j in range(width // 4):
                h = _mix_h(h, _mix_k1((words >> (32 * j)) & M32))
        return _fmix32(h ^ width)
    return run


def _murmur_rows(seed: int):
    def run(mat: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
        rows, m = mat.shape
        if m % 4:
            mat = torch.nn.functional.pad(mat, (0, 4 - m % 4))
        h = torch.full((rows,), seed & M32, dtype=torch.int64, device=mat.device)
        for j in range(mat.shape[1] // 4):
            b = mat[:, 4 * j:4 * j + 4]
            k1 = _mix_k1(b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24))
            full = lens >= 4 * (j + 1)
            tail = ~full & (lens > 4 * j)
            h = torch.where(full, _mix_h(h, k1), torch.where(tail, h ^ k1, h))
        return _fmix32(h ^ lens)
    return run


def murmurhash3_x86_32(cols: Sequence[Column], seed: int = 0) -> Column:
    """UINT32 murmur3 of each row; columns combined as the reference's
    (boost hash_combine in 32 bits)."""
    cols = list(cols)
    out = None
    for c in cols:
        h = _per_column(c, _murmur_fixed(seed), _murmur_rows(seed))
        out = h if out is None else \
            out ^ ((h + 0x9E3779B9 + ((out << 6) & M32) + (out >> 2)) & M32)
    return Column(dt.UINT32, cols[0].length, as_uint32(out))


# ----------------------------------------------------------------------
# xxhash64
# ----------------------------------------------------------------------

_P1 = _s64(0x9E3779B185EBCA87)
_P2 = _s64(0xC2B2AE3D27D4EB4F)
_P3 = _s64(0x165667B19E3779F9)
_P4 = _s64(0x85EBCA77C2B2AE63)
_P5 = _s64(0x27D4EB2F165667C5)


def _round(acc: torch.Tensor, lane: torch.Tensor) -> torch.Tensor:
    return _rotl64(acc + lane * _P2, 31) * _P1


def _lane8(acc: torch.Tensor, lane: torch.Tensor) -> torch.Tensor:
    return _rotl64(acc ^ (_rotl64(lane * _P2, 31) * _P1), 27) * _P1 + _P4


def _lane4(acc: torch.Tensor, lane: torch.Tensor) -> torch.Tensor:
    return _rotl64(acc ^ (lane * _P1), 23) * _P2 + _P3


def _lane1(acc: torch.Tensor, byte: torch.Tensor) -> torch.Tensor:
    return _rotl64(acc ^ (byte * _P5), 11) * _P1


def _avalanche(acc: torch.Tensor) -> torch.Tensor:
    acc = (acc ^ _shr(acc, 33)) * _P2
    acc = (acc ^ _shr(acc, 29)) * _P3
    return acc ^ _shr(acc, 32)


def _seeded(seed: int, add: int) -> int:
    return _s64((seed + add) & ((1 << 64) - 1))


def _xxh_fixed(seed: int):
    def run(words: torch.Tensor, width: int) -> torch.Tensor:
        acc = torch.full_like(words, _seeded(seed, _P5 & ((1 << 64) - 1))) + width
        if width == 8:
            return _avalanche(_lane8(acc, words))
        if width == 4:
            return _avalanche(_lane4(acc, words))
        for k in range(width):
            acc = _lane1(acc, (words >> (8 * k)) & 0xFF)
        return _avalanche(acc)
    return run


def _xxh_rows(seed: int):
    def run(mat: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
        rows, m = mat.shape
        if m % 8:
            mat = torch.nn.functional.pad(mat, (0, 8 - m % 8))
        m8 = mat.shape[1]

        def load(p: int, k: int = 8) -> torch.Tensor:
            word = mat[:, p]
            for i in range(1, k):
                word = word | (mat[:, p + i] << (8 * i))
            return word

        dev = mat.device
        stripe_end = lens // 32 * 32
        acc = torch.full((rows,), _seeded(seed, _P5 & ((1 << 64) - 1)), dtype=torch.int64,
                         device=dev)
        if m8 >= 32:
            u = (1 << 64) - 1
            v = [torch.full((rows,), _seeded(seed, a), dtype=torch.int64, device=dev)
                 for a in ((_P1 + _P2) & u, _P2 & u, 0, (-_P1) & u)]
            for s in range(m8 // 32):
                use = lens >= 32 * (s + 1)
                v = [torch.where(use, _round(vi, load(32 * s + 8 * i)), vi)
                     for i, vi in enumerate(v)]
            big = _rotl64(v[0], 1) + _rotl64(v[1], 7) + _rotl64(v[2], 12) + _rotl64(v[3], 18)
            for vi in v:
                big = (big ^ _round(torch.zeros_like(vi), vi)) * _P1 + _P4
            acc = torch.where(lens >= 32, big, acc)
        acc = acc + lens
        end8 = stripe_end + (lens - stripe_end) // 8 * 8
        for j in range(m8 // 8):
            use = (8 * j >= stripe_end) & (8 * j + 8 <= lens)
            acc = torch.where(use, _lane8(acc, load(8 * j)), acc)
        for j in range(m8 // 4):
            use = (4 * j == end8) & (4 * j + 4 <= lens)
            acc = torch.where(use, _lane4(acc, load(4 * j, 4)), acc)
        done4 = end8 + torch.where(lens - end8 >= 4, 4, 0)
        for p in range(m8):
            use = (p >= done4) & (p < lens)
            acc = torch.where(use, _lane1(acc, mat[:, p]), acc)
        return _avalanche(acc)
    return run


def xxhash_64(cols: Sequence[Column], seed: int = 0) -> Column:
    """UINT64 xxhash64 of each row (every length: 32-byte stripes, then 8-,
    4- and 1-byte lanes); columns combined by hash_combine in 64 bits."""
    cols = list(cols)
    out = None
    for c in cols:
        h = _per_column(c, _xxh_fixed(seed), _xxh_rows(seed))
        out = h if out is None else \
            out ^ (h + _s64(0x9E3779B97F4A7C15) + (out << 6) + _shr(out, 2))
    return Column(dt.UINT64, cols[0].length, out.view(torch.uint64))


# ----------------------------------------------------------------------
# checksums: the host tier
# ----------------------------------------------------------------------

_HASHLIB = {"md5": hashlib.md5, "sha1": hashlib.sha1, "sha224": hashlib.sha224,
            "sha256": hashlib.sha256, "sha384": hashlib.sha384, "sha512": hashlib.sha512}


def _row_bytes(col: Column) -> List:
    """Each row's bytes (None where null): a string's UTF-8, a value's
    little-endian bytes in its storage dtype (bool one byte)."""
    if col.dtype.is_dictionary:
        col = col.decode_dictionary()
    if col.dtype.is_string:
        return [None if v is None else v.encode() for v in col.host_strings()]
    arr = tracing.synced("export", col.data, col.data.cpu)
    if col.dtype.is_bool:
        arr = arr.to(torch.uint8)
    arr = arr.numpy()
    valid = [True] * col.length if col.validity is None else tracing.tolist(col.validity, "export")
    return [arr[i].tobytes() if ok else None for i, ok in enumerate(valid)]


def checksum(cols: Sequence[Column], method: str = "md5") -> Column:
    """A STRING column of each row's hex digest over its columns' bytes,
    null elements skipped (cudf md5/sha semantics): hashlib on the host."""
    count_host_route(f"hashing.checksum.{method}")
    fn = _HASHLIB[method]
    cols = list(cols)
    parts = [_row_bytes(c) for c in cols]
    out = []
    for i in range(cols[0].length):
        h = fn()
        for p in parts:
            if p[i] is not None:
                h.update(p[i])
        out.append(h.hexdigest())
    return Column.from_strings(out, device=cols[0].device)


def hash_values(cols: Sequence[Column], method: str = "murmur3", seed: int = 0) -> Column:
    """``DataFrame.hash_values`` / ``Series.hash_values``."""
    if method in ("murmur3", "murmurhash3_x86_32"):
        return murmurhash3_x86_32(cols, seed)
    if method in ("xxhash64", "xxhash_64"):
        return xxhash_64(cols, seed)
    if method in _HASHLIB:
        return checksum(cols, method)
    raise ValueError(f"unknown hash method {method!r}")
