"""Parquet selective-scan pushdown (port of
``cudf_tpu/io/parquet_pushdown.py``, host metadata code): the interval
algebra of row ranges, page-index pruning from ColumnIndex/OffsetIndex
stats (libcudf's experimental/page_index_filter.cu), and split-block
bloom probes for equality predicates (bloom_filter_reader.cu).  The
bitsets are a few KB read on the host, and a probe is O(1) a predicate.
The writer builds its bitsets with ``_native.sbbf_insert``.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

from cudf_tpu_torch.io import thrift

Interval = Tuple[int, int]

# ----------------------------------------------------------------------
# interval algebra (rg-relative row ranges, sorted + disjoint)
# ----------------------------------------------------------------------


def intervals_union(ivs: List[Interval]) -> List[Interval]:
    out: List[Interval] = []
    for a, b in sorted(ivs):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def intervals_intersect(xs: List[Interval], ys: List[Interval]) -> List[Interval]:
    out: List[Interval] = []
    i = j = 0
    while i < len(xs) and j < len(ys):
        lo = max(xs[i][0], ys[j][0])
        hi = min(xs[i][1], ys[j][1])
        if lo < hi:
            out.append((lo, hi))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


# ----------------------------------------------------------------------
# page-index (ColumnIndex/OffsetIndex) pruning
# ----------------------------------------------------------------------


def _decode_stat(b: Optional[bytes], phys: int):
    if b is None:
        return None
    fmt = {1: "<i", 2: "<q", 4: "<f", 5: "<d"}.get(phys)
    if fmt is not None:
        return struct.unpack(fmt, b)[0] if len(b) == struct.calcsize(fmt) else None
    if phys == 6:
        return bytes(b)
    return None


def _maybe_match(op: str, val, mn, mx) -> bool:
    """True unless the [mn, mx] range PROVES no row can match."""
    if mn is None or mx is None:
        return True
    if isinstance(val, str) and isinstance(mn, (bytes, bytearray)):
        val = val.encode()
    try:
        if op in ("==", "="):
            return not (val < mn or val > mx)
        if op == "<":
            return mn < val
        if op == "<=":
            return mn <= val
        if op == ">":
            return mx > val
        if op == ">=":
            return mx >= val
    except TypeError:
        return True
    return True


def read_page_index(path: str, cc: thrift.ColumnChunkMeta):
    """(ColumnIndex, OffsetIndex) for a chunk, or (None, None)."""
    if cc.offset_index_offset is None or cc.column_index_offset is None:
        return None, None
    with open(path, "rb") as f:
        f.seek(cc.column_index_offset)
        ci = thrift.ColumnIndex.parse(f.read(cc.column_index_length))
        f.seek(cc.offset_index_offset)
        oi = thrift.OffsetIndex.parse(f.read(cc.offset_index_length))
    return ci, oi


def read_offset_index(path: str, cc: thrift.ColumnChunkMeta) -> Optional[thrift.OffsetIndex]:
    """A chunk's OffsetIndex (page locations), which a chunk without
    statistics (booleans) has without a ColumnIndex."""
    if cc.offset_index_offset is None:
        return None
    with open(path, "rb") as f:
        f.seek(cc.offset_index_offset)
        return thrift.OffsetIndex.parse(f.read(cc.offset_index_length))


def page_keep_intervals(ci: thrift.ColumnIndex, oi: thrift.OffsetIndex,
                        rg_rows: int, col_filters, phys: int) -> List[Interval]:
    """Row intervals (rg-relative) whose pages MAY satisfy every
    (op, val) in col_filters, from per-page min/max stats."""
    starts = [p.first_row_index for p in oi.page_locations]
    bounds = starts[1:] + [rg_rows]
    keep: List[Interval] = []
    for i in range(len(starts)):
        if i < len(ci.null_pages) and ci.null_pages[i]:
            # all-null page: no non-null value can match a comparison
            continue
        mn = _decode_stat(ci.min_values[i], phys) if i < len(ci.min_values) else None
        mx = _decode_stat(ci.max_values[i], phys) if i < len(ci.max_values) else None
        if all(_maybe_match(op, val, mn, mx) for op, val in col_filters):
            keep.append((starts[i], bounds[i]))
    return intervals_union(keep)


# ----------------------------------------------------------------------
# split-block bloom filter (parquet SBBF; bloom_filter_reader.cu role)
# ----------------------------------------------------------------------

_P1 = 0x9E3779B185EBCA87
_P2 = 0xC2B2AE3D27D4EB4F
_P3 = 0x165667B19E3779F9
_P4 = 0x85EBCA77C2B2AE63
_P5 = 0x27D4EB2F165667C5
_M64 = (1 << 64) - 1

SALT = (0x47B6137B, 0x44974D91, 0x8824AD5B, 0xA2B7289D,
        0x705495C7, 0x2DF1424B, 0x9EFC4947, 0x5C6BFB31)


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def xxhash64(data: bytes, seed: int = 0) -> int:
    """Spec-exact XXH64 of one predicate literal (host scalar; the
    writer hashes its values with ``_native``)."""
    n = len(data)
    pos = 0
    if n >= 32:
        v1 = (seed + _P1 + _P2) & _M64
        v2 = (seed + _P2) & _M64
        v3 = seed & _M64
        v4 = (seed - _P1) & _M64
        while pos + 32 <= n:
            for vi in range(4):
                k = int.from_bytes(data[pos:pos + 8], "little")
                if vi == 0:
                    v1 = (_rotl((v1 + k * _P2) & _M64, 31) * _P1) & _M64
                elif vi == 1:
                    v2 = (_rotl((v2 + k * _P2) & _M64, 31) * _P1) & _M64
                elif vi == 2:
                    v3 = (_rotl((v3 + k * _P2) & _M64, 31) * _P1) & _M64
                else:
                    v4 = (_rotl((v4 + k * _P2) & _M64, 31) * _P1) & _M64
                pos += 8
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M64
        for v in (v1, v2, v3, v4):
            h ^= (_rotl((v * _P2) & _M64, 31) * _P1) & _M64
            h = ((h * _P1) + _P4) & _M64
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while pos + 8 <= n:
        k = int.from_bytes(data[pos:pos + 8], "little")
        h ^= (_rotl((k * _P2) & _M64, 31) * _P1) & _M64
        h = ((_rotl(h, 27) * _P1) + _P4) & _M64
        pos += 8
    if pos + 4 <= n:
        h ^= (int.from_bytes(data[pos:pos + 4], "little") * _P1) & _M64
        h = ((_rotl(h, 23) * _P2) + _P3) & _M64
        pos += 4
    while pos < n:
        h ^= (data[pos] * _P5) & _M64
        h = (_rotl(h, 11) * _P1) & _M64
        pos += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    h ^= h >> 32
    return h


def value_plain_bytes(val, phys: int) -> Optional[bytes]:
    """Canonical plain encoding of a predicate literal for hashing
    (the format the writer hashed: parquet bloom filter spec)."""
    try:
        if phys == 1:
            return struct.pack("<i", int(val))
        if phys == 2:
            return struct.pack("<q", int(val))
        if phys == 4:
            return struct.pack("<f", float(val))
        if phys == 5:
            return struct.pack("<d", float(val))
        if phys == 6:
            return val.encode() if isinstance(val, str) else bytes(val)
    except (ValueError, TypeError, struct.error):
        return None
    return None


def sbbf_block_check(bitset: bytes, h: int) -> bool:
    """Probe a split-block bloom bitset (32-byte blocks of 8 u32 words)."""
    num_blocks = len(bitset) // 32
    if num_blocks == 0:
        return True
    block = ((h >> 32) * num_blocks) >> 32
    x = h & 0xFFFFFFFF
    base = block * 32
    for i in range(8):
        bit = ((x * SALT[i]) & 0xFFFFFFFF) >> 27
        word = int.from_bytes(bitset[base + 4 * i:base + 4 * i + 4], "little")
        if not (word >> bit) & 1:
            return False
    return True


def bloom_maybe_contains(path: str, cc: thrift.ColumnChunkMeta, val) -> bool:
    """False only when the chunk's bloom filter PROVES val is absent
    (bloom_filter_reader.cu role)."""
    if cc.bloom_filter_offset is None:
        return True
    enc = value_plain_bytes(val, cc.type)
    if enc is None:
        return True
    with open(path, "rb") as f:
        f.seek(cc.bloom_filter_offset)
        head = f.read(64)
        try:
            hdr = thrift.BloomFilterHeader.parse(head)
        except Exception:
            return True
        f.seek(cc.bloom_filter_offset + hdr.header_len)
        bitset = f.read(hdr.num_bytes)
    return sbbf_block_check(bitset, xxhash64(enc))


def rg_bloom_passes(path: str, rg, filters) -> bool:
    """Row-group pruning via bloom filters on equality predicates."""
    if not filters:
        return True
    by_name = {}
    for cc in rg.columns:
        by_name[cc.path[-1] if cc.path else ""] = cc
    for name, op, val in filters:
        if op not in ("==", "=") or name not in by_name:
            continue
        if not bloom_maybe_contains(path, by_name[name], val):
            return False
    return True
