"""Self-contained Parquet writer (port of ``cudf_tpu/io/parquet_writer.py``):
thrift compact encode, dictionary and PLAIN pages, snappy / gzip / zstd,
v1 and v2 data pages, the page index, statistics, bloom filters and
DELTA_BINARY_PACKED.

For every frame the reference writes correctly (numeric, bool and
STRING columns) the file is byte for byte the reference's, whatever the
options, gzip aside (its header holds the time).  The per-value work
runs on the device or in ``io_host.cpp``, never as a Python loop a
value: dictionaries by ``torch.unique`` (a STRING column's rows grouped
by a 64-bit hash of their bytes, each checked against its group's row;
a DICTIONARY column through its codes), the distinct strings (at most
65536) put in byte order on the host, PLAIN string bytes by one scatter
of lengths and chars, statistics by device reductions; the greedy RLE /
bit-pack encoder, DELTA encoding, snappy and the bloom filters' hashing
in C.

Where the reference is wrong, the writer is not: a DICTIONARY column is
written as its decoded strings would be (the same bytes as the STRING
column; the reference raises ImportError), and a timestamp column carries
the TIMESTAMP logical type of its unit (UTC-adjusted when tz-aware;
seconds are written as milliseconds), a day-unit one DATE over INT32,
where the reference writes bare INT64.
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np
import torch

from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.io import _native

# thrift compact type ids
_CT_STOP, _CT_TRUE, _CT_FALSE, _CT_BYTE = 0, 1, 2, 3
_CT_I16, _CT_I32, _CT_I64 = 4, 5, 6
_CT_DOUBLE, _CT_BINARY, _CT_LIST, _CT_STRUCT = 7, 8, 9, 12


class CompactWriter:
    """Thrift compact-protocol encoder (compact_protocol_writer.cpp)."""

    def __init__(self):
        self.buf = bytearray()
        self._last_fid = [0]

    def _varint(self, v: int):
        while True:
            b = v & 0x7F
            v >>= 7
            if v:
                self.buf.append(b | 0x80)
            else:
                self.buf.append(b)
                return

    def _zigzag(self, v: int):
        self._varint((v << 1) ^ (v >> 63) if v < 0 else (v << 1))

    def field(self, fid: int, ctype: int):
        delta = fid - self._last_fid[-1]
        if 0 < delta < 16:
            self.buf.append((delta << 4) | ctype)
        else:
            self.buf.append(ctype)
            self._zigzag(fid)
        self._last_fid[-1] = fid

    def write_i(self, fid: int, v: int, ctype: int = _CT_I64):
        self.field(fid, ctype)
        self._zigzag(v)

    def write_bool(self, fid: int, v: bool):
        self.field(fid, _CT_TRUE if v else _CT_FALSE)

    def write_binary(self, fid: int, v: bytes):
        self.field(fid, _CT_BINARY)
        self._varint(len(v))
        self.buf += v

    def begin_struct(self, fid: Optional[int] = None):
        if fid is not None:
            self.field(fid, _CT_STRUCT)
        self._last_fid.append(0)

    def end_struct(self):
        self.buf.append(_CT_STOP)
        self._last_fid.pop()

    def begin_list(self, fid: int, etype: int, count: int):
        self.field(fid, _CT_LIST)
        if count < 15:
            self.buf.append((count << 4) | etype)
        else:
            self.buf.append(0xF0 | etype)
            self._varint(count)


# physical types
_PT_BOOLEAN, _PT_INT32, _PT_INT64, _PT_FLOAT, _PT_DOUBLE, _PT_BA = 0, 1, 2, 4, 5, 6
_PT_TORCH = {_PT_INT32: torch.int32, _PT_INT64: torch.int64, _PT_FLOAT: torch.float32,
             _PT_DOUBLE: torch.float64}
_PT_FMT = {_PT_INT32: "<i", _PT_INT64: "<q", _PT_FLOAT: "<f", _PT_DOUBLE: "<d"}
_TS_UNIT_FID = {"ms": 1, "us": 2, "ns": 3}

_CODECS = {"uncompressed": 0, None: 0, "none": 0, "snappy": 1, "gzip": 2, "zstd": 6}


def _compress(data: bytes, codec: int) -> bytes:
    if codec == 0:
        return data
    if codec == 1:
        return _native.snappy_compress(data)
    if codec == 2:
        import gzip

        return gzip.compress(data, compresslevel=1)
    if codec == 6:
        import zstandard

        return zstandard.ZstdCompressor().compress(data)
    raise NotImplementedError(f"codec {codec}")


class _Encoded:
    """One leaf chunk's present values, ready to encode: the physical
    type, the values on the device (fixed width) or (offsets, chars) for
    strings, their statistics, and the dictionary when one pays."""

    def __init__(self, col, want_dictionary: bool):
        if col.dtype.is_dictionary and not col.keys.dtype.is_string:
            col = col.decode_dictionary()
        valid = col.validity
        self.n_present = col.length if valid is None else int(valid.sum())
        self.mn = self.mx = None
        self.dictionary = None           # (plain dictionary bytes, int32 indices)
        if col.dtype.is_string or col.dtype.is_dictionary:
            self.pt = _PT_BA
            self._strings(col, valid, want_dictionary)
            return
        data = col.data if valid is None else col.data[valid]
        if col.dtype.is_bool:
            self.pt, self.values = _PT_BOOLEAN, data.bool()
            return
        if col.dtype.is_temporal:
            data = data.long()
            if col.dtype.id == dt.TypeId.TIMESTAMP_DAYS:
                data = data.int()
            elif col.dtype.id == dt.TypeId.TIMESTAMP_SECONDS:
                data = data * 1000
        self.ints = data                 # the values before the physical cast (DELTA)
        if data.dtype == torch.float32:
            self.pt = _PT_FLOAT
        elif data.dtype == torch.float64:
            self.pt = _PT_DOUBLE
        elif data.element_size() <= 4:   # as numpy's astype: unsigned values wrap
            self.pt = _PT_INT32
            data = data.view(torch.int32) if data.dtype == torch.uint32 else data.to(torch.int32)
        else:
            self.pt = _PT_INT64
            data = data.view(torch.int64) if data.dtype == torch.uint64 else data.to(torch.int64)
        self.values = data
        if data.numel():
            fmt = _PT_FMT[self.pt]
            lo, hi = torch.aminmax(data)
            self.mn, self.mx = struct.pack(fmt, lo.item()), struct.pack(fmt, hi.item())
        if want_dictionary:
            self._numeric_dictionary(data)

    # -- numbers --------------------------------------------------------
    def _numeric_dictionary(self, data: torch.Tensor) -> None:
        nan = torch.isnan(data) if data.is_floating_point() else None
        has_nan = nan is not None and bool(nan.any())
        base = data[~nan] if has_nan else data
        uniq, inv = torch.unique(base, sorted=True, return_inverse=True)
        n_uniq = uniq.numel() + (1 if has_nan else 0)
        if n_uniq > 65536 or n_uniq > max(data.numel() // 2, 1):
            return
        if has_nan:                      # numpy's unique: one NaN, sorted last
            idx = torch.full(data.shape, uniq.numel(), dtype=torch.int64, device=data.device)
            idx[~nan] = inv
            inv = idx
            uniq = torch.cat([uniq, uniq.new_full((1,), float("nan"))])
        self.dictionary = (uniq.cpu().numpy().tobytes(), inv.to(torch.int32))

    # -- strings --------------------------------------------------------
    def _strings(self, col, valid, want_dictionary: bool) -> None:
        from cudf_tpu_torch.ops import copying

        if col.dtype.is_dictionary:
            # the keys the rows use, in byte order (a handful: the rows are
            # never decoded), and each row's rank among them
            codes = (col.data if valid is None else col.data[valid]).long()
            used, inv = torch.unique(codes, sorted=True, return_inverse=True)
            rank, keys = sort_distinct(copying.gather(col.keys, used, bounds_check=False))
            self.present = copying.gather(keys, rank.long()[inv], bounds_check=False)
            self.distinct = keys
            self._string_stats(keys, rank.long()[inv], want_dictionary, keys_sorted=True)
            return
        present = col if valid is None else copying.gather(
            col.with_validity(None), torch.nonzero(valid).flatten(), bounds_check=False)
        self.present = present
        group, reps = distinct_strings(present)
        self.distinct = copying.gather(present, reps, bounds_check=False)
        self._string_stats(self.distinct, group, want_dictionary, keys_sorted=False)

    def _string_stats(self, keys, group, want_dictionary: bool, keys_sorted: bool) -> None:
        """Statistics and, when it pays, the dictionary (sorted keys and
        each row's index) from the distinct strings ``keys`` and each
        present row's position among them."""
        k = keys.length
        if not k:
            self.mn = self.mx = None
        dictionary = want_dictionary and not (k > 65536 or (self.n_present and
                                                            k > self.n_present // 2))
        if dictionary and not keys_sorted:
            rank, keys = sort_distinct(keys)
            group = rank.long()[group]
            keys_sorted = True
        if k and keys_sorted:
            self.mn, self.mx = (_row_bytes(keys, i) for i in (0, k - 1))
        elif k:
            self.mn, self.mx = (_row_bytes(keys, string_extreme(keys, largest))
                                for largest in (False, True))
        if dictionary:
            self.dictionary = (plain_strings(keys).cpu().numpy().tobytes(), group.to(torch.int32))

    # -- PLAIN bytes ----------------------------------------------------
    def plain(self) -> bytes:
        if self.pt == _PT_BA:
            return plain_strings(self.present).cpu().numpy().tobytes()
        if self.pt == _PT_BOOLEAN:
            return pack_bits(self.values).cpu().numpy().tobytes()
        return self.values.cpu().numpy().tobytes()


def sort_distinct(keys):
    """(rank of each key, the keys in byte order) of at most 65536
    distinct strings: sorted on the host, where a comparison of two keys
    costs what they share and not what the longest key holds."""
    from cudf_tpu_torch.ops import copying
    from cudf_tpu_torch.ops._utils import inverse_permutation

    offs = keys.offsets.cpu().tolist()
    chars = keys.data.cpu().numpy().tobytes()
    vals = [chars[a:b] for a, b in zip(offs[:-1], offs[1:])]
    perm = torch.tensor(sorted(range(keys.length), key=vals.__getitem__), dtype=torch.int64,
                        device=keys.device)
    return inverse_permutation(perm), copying.gather(keys, perm, bounds_check=False)


def _row_bytes(col, i: int) -> bytes:
    a, b = (int(x) for x in col.offsets[i:i + 2])
    return col.data[a:b].cpu().numpy().tobytes()


def _string_hashes(col) -> torch.Tensor:
    """int64[n]: a polynomial hash of each row's bytes and its length, mod
    2^64 (wrapping int64 arithmetic), from prefix sums over the bytes:
    linear in the bytes whatever the longest row."""
    dev = col.device
    offs = col.offsets - col.offsets[0]
    total = int(offs[-1])
    lens = offs[1:] - offs[:-1]
    if total == 0:
        return lens * _LEN_MULT
    data = col.data[int(col.offsets[0]):int(col.offsets[0]) + total].long()
    mult = torch.full((total,), 0x100000001B3, dtype=torch.int64, device=dev)
    inv = torch.full((total,), _INV_MULT, dtype=torch.int64, device=dev)
    mult[0] = inv[0] = 1
    powers, inv_powers = torch.cumprod(mult, 0), torch.cumprod(inv, 0)
    pre = torch.zeros(total + 1, dtype=torch.int64, device=dev)
    torch.cumsum((data + 1) * powers, 0, out=pre[1:])
    start_inv = torch.cat([inv_powers, inv_powers[-1:] * _INV_MULT])[offs[:-1]]
    return (pre[offs[1:]] - pre[offs[:-1]]) * start_inv + lens * _LEN_MULT


# 0x100000001B3's inverse mod 2^64 (an odd multiplier has one), and the
# length's multiplier, as int64
_INV_MULT = pow(0x100000001B3, -1, 1 << 64) - (1 << 64)
_LEN_MULT = 0x9E3779B97F4A7C15 - (1 << 64)


def distinct_strings(col):
    """(each row's group id int64[n], one row of each group): equal strings
    share a group, groups in no particular order.  Rows are grouped by a
    64-bit hash of their bytes, then every row is compared byte for byte
    with its group's row; a collision (never seen) falls back to a sort."""
    from cudf_tpu_torch.ops.dictionary import factorize
    from cudf_tpu_torch.ops.strings import byte_rows

    n, dev = col.length, col.device
    if n == 0:
        z = torch.zeros(0, dtype=torch.int64, device=dev)
        return z, z
    h = _string_hashes(col)
    uniq, group = torch.unique(h, return_inverse=True)
    reps = torch.full((uniq.numel(),), n, dtype=torch.int64, device=dev).scatter_reduce_(
        0, group, torch.arange(n, device=dev), "amin")
    offs = col.offsets
    lens = offs[1:] - offs[:-1]
    rep = reps[group]
    ok = bool((lens == lens[rep]).all())
    total = int(offs[-1] - offs[0])
    if ok and total:
        rows = byte_rows(offs - offs[0], total).long()
        q = torch.arange(total, device=dev)
        within = q - (offs[rows] - offs[0])
        ok = bool((col.data[offs[0] + q] == col.data[offs[rep[rows]] + within]).all())
    if not ok:
        codes, keys = factorize(col)
        reps = torch.full((keys.length,), n, dtype=torch.int64, device=dev).scatter_reduce_(
            0, codes.long(), torch.arange(n, device=dev), "amin")
        return codes.long(), reps
    return group, reps


def string_extreme(col, largest: bool) -> int:
    """The row of the least (or greatest) string in byte order: 8 bytes at
    a time over the rows still tied, then the shorter (longer) one."""
    dev = col.device
    cand = torch.arange(col.length, device=dev)
    offs = col.offsets
    lens = offs[1:] - offs[:-1]
    total_end = int(offs[-1])
    pos = 0
    while cand.numel() > 1 and pos < int(lens[cand].max()):
        word = torch.zeros(cand.numel(), dtype=torch.int64, device=dev)
        for k in range(8):
            at = offs[cand] + pos + k
            inrow = (pos + k) < lens[cand]
            b = torch.where(inrow, col.data[at.clamp(max=max(total_end - 1, 0))].long(), 0)
            word = word * 256 + b - (128 if k == 0 else 0)     # big-endian, signed order
        pick = word.max() if largest else word.min()
        cand = cand[word == pick]
        pos += 8
    if cand.numel() > 1:
        cl = lens[cand]
        cand = cand[cl == (cl.max() if largest else cl.min())]
    return int(cand[0])


def plain_strings(col) -> torch.Tensor:
    """PLAIN BYTE_ARRAY bytes of a STRING column without nulls: each row
    a 4-byte little-endian length, then its bytes; built on the device by
    one scatter of the lengths and one of the chars."""
    from cudf_tpu_torch.ops.strings import byte_rows

    n = col.length
    offs = col.offsets
    lens = offs[1:] - offs[:-1]
    total = int(offs[-1] - offs[0])
    out = torch.empty(4 * n + total, dtype=torch.uint8, device=offs.device)
    starts = 4 * torch.arange(n, device=offs.device) + (offs[:-1] - offs[0])
    for k in range(4):
        out[starts + k] = ((lens >> (8 * k)) & 0xFF).to(torch.uint8)
    if total:
        rows = byte_rows(offs - offs[0], total).long()
        dest = torch.arange(total, device=offs.device) + 4 * (rows + 1)
        out[dest] = col.data[int(offs[0]):int(offs[0]) + total]
    return out


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """uint8[ceil(n / 8)]: bools packed least significant bit first."""
    n = bits.numel()
    padded = torch.zeros((n + 7) // 8 * 8, dtype=torch.uint8, device=bits.device)
    padded[:n] = bits.to(torch.uint8)
    weights = (1 << torch.arange(8, device=bits.device)).to(torch.uint8)
    return (padded.view(-1, 8) * weights).sum(1, dtype=torch.int64).to(torch.uint8)


def _encode_levels(levels: np.ndarray, max_level: int) -> bytes:
    bw = max(int(max_level).bit_length(), 1)
    body = _native.rle_hybrid_encode(levels.astype(np.int32), bw)
    return struct.pack("<I", len(body)) + body


def _write_page_header(w: CompactWriter, n_values: int, encoding: int, usize: int, csize: int):
    w.begin_struct()
    w.write_i(1, 0, _CT_I32)              # DATA_PAGE
    w.write_i(2, usize, _CT_I32)
    w.write_i(3, csize, _CT_I32)
    w.begin_struct(5)                     # DataPageHeader
    w.write_i(1, n_values, _CT_I32)
    w.write_i(2, encoding, _CT_I32)
    w.write_i(3, 3, _CT_I32)              # def levels: RLE
    w.write_i(4, 3, _CT_I32)              # rep levels: RLE
    w.end_struct()
    w.end_struct()


def _write_page_header_v2(w: CompactWriter, n_values: int, n_nulls: int, n_rows: int,
                          encoding: int, usize: int, csize: int, def_len: int,
                          compressed: bool):
    w.begin_struct()
    w.write_i(1, 3, _CT_I32)              # DATA_PAGE_V2
    w.write_i(2, usize, _CT_I32)
    w.write_i(3, csize, _CT_I32)
    w.begin_struct(8)                     # DataPageHeaderV2
    w.write_i(1, n_values, _CT_I32)
    w.write_i(2, n_nulls, _CT_I32)
    w.write_i(3, n_rows, _CT_I32)
    w.write_i(4, encoding, _CT_I32)
    w.write_i(5, def_len, _CT_I32)
    w.write_i(6, 0, _CT_I32)
    w.write_bool(7, compressed)
    w.end_struct()
    w.end_struct()


def _write_dict_page_header(w: CompactWriter, n_values: int, usize: int, csize: int):
    w.begin_struct()
    w.write_i(1, 2, _CT_I32)              # DICTIONARY_PAGE
    w.write_i(2, usize, _CT_I32)
    w.write_i(3, csize, _CT_I32)
    w.begin_struct(7)
    w.write_i(1, n_values, _CT_I32)
    w.write_i(2, 0, _CT_I32)              # PLAIN
    w.end_struct()
    w.end_struct()


def _list_levels(col):
    """(rep_levels, def_levels, element column) of a list column in the
    3-level optional schema (dremel.cu): def 0 = null list, 1 = empty
    list, 2 = null element, 3 = element present; rep 0 starts a row."""
    n = col.length
    offs = col.offsets.cpu().numpy()
    counts = offs[1:] - offs[:-1]
    lvalid = np.ones(n, bool) if col.validity is None else col.validity.cpu().numpy()
    counts = np.where(lvalid, counts, 0)
    emit = np.maximum(counts, 1)
    tot = int(emit.sum())
    starts = np.cumsum(emit) - emit
    rep = np.ones(tot, np.int32)
    rep[starts] = 0
    has = np.repeat(counts > 0, emit)
    lv_r = np.repeat(lvalid, emit)
    child_idx = np.repeat(offs[:-1], emit) + np.arange(tot) - np.repeat(starts, emit)
    child = col.children[0]
    evalid = np.ones(child.length, bool) if child.validity is None else \
        child.validity.cpu().numpy()
    ev = evalid[np.clip(child_idx, 0, max(child.length - 1, 0))] if child.length \
        else np.zeros(tot, bool)
    defs = np.where(~lv_r, 0, np.where(~has, 1, np.where(ev, 3, 2))).astype(np.int32)
    return rep, defs, child


def _sbbf_build(enc: "_Encoded", max_ndv: int = 1 << 18) -> Optional[bytes]:
    """A split-block bloom bitset over a chunk's distinct present values,
    or None when the column's shape has none."""
    if enc.pt == _PT_BA:
        keys = enc.distinct
        ndv = keys.length
        if not ndv or ndv > max_ndv:
            return None
        offs = keys.offsets.cpu().numpy()
        hashes = _native.xxhash64_strings(keys.data.cpu().numpy(), offs - offs[0])
    elif enc.pt in _PT_TORCH:
        uniq = torch.unique(enc.values)
        if enc.values.is_floating_point() and bool(torch.isnan(uniq).any()):
            uniq = torch.cat([uniq[~torch.isnan(uniq)], uniq.new_full((1,), float("nan"))])
        ndv = uniq.numel()
        if not ndv or ndv > max_ndv:
            return None
        hashes = _native.xxhash64_fixed(uniq.cpu().numpy())
    else:
        return None
    nbytes = max(32, 1 << (int(ndv * 10.5 / 8 - 1).bit_length()))
    bitset = np.zeros(nbytes, np.uint8)
    _native.sbbf_insert(bitset, hashes)
    return bitset.tobytes()


def _write_bloom_header(w: CompactWriter, num_bytes: int):
    w.begin_struct()
    w.write_i(1, num_bytes, _CT_I32)
    for fid in (2, 3, 4):                # SBBF / xxhash / uncompressed
        w.begin_struct(fid)
        w.begin_struct(1)
        w.end_struct()
        w.end_struct()
    w.end_struct()


def _logical(dtype) -> Tuple[Optional[int], Optional[tuple]]:
    """(converted type, logical type) of a temporal column: TIMESTAMP of
    its unit (seconds written as ms), DATE for days."""
    if not dtype.is_timestamp:
        return None, None
    if dtype.id == dt.TypeId.TIMESTAMP_DAYS:
        return 6, ("date",)
    unit = "ms" if dtype.time_unit in ("s", "ms") else dtype.time_unit
    utc = dtype.tz is not None
    # the converted types TIMESTAMP_MILLIS / MICROS mean UTC-adjusted
    return ({"ms": 9, "us": 10}.get(unit) if utc else None), ("timestamp", unit, utc)


def _write_logical(w: CompactWriter, lg: tuple):
    w.begin_struct(10)                   # LogicalType (a union)
    if lg[0] == "date":
        w.begin_struct(6)
        w.end_struct()
    else:
        w.begin_struct(8)                # TimestampType
        w.write_bool(1, lg[2])
        w.begin_struct(2)                # TimeUnit
        w.begin_struct(_TS_UNIT_FID[lg[1]])
        w.end_struct()
        w.end_struct()
        w.end_struct()
    w.end_struct()


def _slice_col(col, start: int, stop: int):
    if start == 0 and stop == col.length:
        return col
    from cudf_tpu_torch.ops import copying

    return copying.slice(col, start, stop)


def _leaf_specs(name, col):
    if col.dtype.is_list:
        rep, defs, child = _list_levels(col)
        return [dict(path=(name, "list", "element"), col=child, rep=rep, defs=defs,
                     max_rep=1, max_def=3, nv=len(defs), dict_ok=False)]
    if col.dtype.is_struct:
        svalid = None if col.validity is None else col.validity.cpu().numpy()
        specs = []
        for (fname, _), child in zip(col.dtype.fields, col.children):
            cvalid = np.ones(child.length, bool) if child.validity is None else \
                child.validity.cpu().numpy()
            defs = np.where(cvalid, 2, 1) if svalid is None else \
                np.where(~svalid, 0, np.where(cvalid, 2, 1))
            both = cvalid if svalid is None else cvalid & svalid
            leaf = child.with_validity(None if both.all() else
                                       torch.from_numpy(both).to(child.device))
            specs.append(dict(path=(name, fname), col=leaf, rep=None,
                              defs=defs.astype(np.int32), max_rep=0, max_def=2,
                              nv=child.length, dict_ok=False))
        return specs
    return [dict(path=(name,), col=col, rep=None, defs=None, max_rep=0,
                 max_def=1 if col.validity is not None else 0, nv=col.length, dict_ok=True)]


def write_parquet_native(table, path: str, row_group_size: int = 1 << 20,
                         compression: str = "snappy", use_dictionary: bool = True,
                         data_page_version: int = 1, data_page_rows: int = 0,
                         write_page_index: bool = True, bloom_filter_columns=None,
                         use_delta_binary: bool = False):
    """Write a Table (flat, one-level list and struct columns) as Parquet.

    compression: uncompressed | snappy | gzip | zstd; use_dictionary:
    dictionary-encode a chunk when it pays (at most 65536 distinct values
    and at most half the present values), else PLAIN; use_delta_binary:
    int leaves that are not dictionary-encoded as DELTA_BINARY_PACKED;
    data_page_version: 1 or 2; data_page_rows: pages of this many rows (0:
    one page a chunk); write_page_index: ColumnIndex / OffsetIndex before
    the footer; bloom_filter_columns: the columns to build split-block
    bloom filters for."""
    codec = _CODECS[compression.lower() if compression else None]
    bloom_cols = set(bloom_filter_columns or ())
    names = list(table.names)
    n = table.num_rows
    with open(path, "wb") as f:
        f.write(b"PAR1")
        row_groups_meta = []
        start = 0
        while start < n or (n == 0 and start == 0):
            stop = min(start + row_group_size, n)
            cols_meta = []
            specs = []
            for name in names:
                specs.extend(_leaf_specs(name, _slice_col(table[name], start, stop)))
            for spec in specs:
                cols_meta.append(_write_chunk(f, spec, codec, use_dictionary, use_delta_binary,
                                              data_page_version, data_page_rows, bloom_cols))
            row_groups_meta.append(dict(cols=cols_meta, rows=stop - start,
                                        bytes=sum(c["total"] for c in cols_meta)))
            start = stop
            if n == 0:
                break
        _write_indexes(f, row_groups_meta, write_page_index)
        f.write(_footer(table, names, n, row_groups_meta))


def _write_chunk(f, spec, codec, use_dictionary, use_delta_binary, data_page_version,
                 data_page_rows, bloom_cols):
    col = spec["col"]
    offset = f.tell()
    nullable = col.validity is not None
    nv = spec["nv"]
    utotal = 0
    enc_all = _Encoded(col, use_dictionary and spec["dict_ok"])
    pt, mn, mx = enc_all.pt, enc_all.mn, enc_all.mx
    dict_off, encoding, indices = None, 0, None
    delta_vals = vals_all = None
    if enc_all.dictionary is None and use_delta_binary and pt in (_PT_INT32, _PT_INT64):
        ints = enc_all.ints
        delta_vals = (ints.view(torch.int64) if ints.dtype == torch.uint64
                      else ints.long()).cpu().numpy()
        vals_all = _native.delta_binary_encode(delta_vals)
        encoding = 5
    if enc_all.dictionary is not None:
        dict_vals, idx_dev = enc_all.dictionary
        indices = idx_dev.cpu().numpy()
        nuniq = max(int(indices.max()) + 1 if indices.size else 0, 1)
        cd = _compress(dict_vals, codec)
        w = CompactWriter()
        _write_dict_page_header(w, nuniq, len(dict_vals), len(cd))
        dict_off = offset
        f.write(bytes(w.buf))
        f.write(cd)
        utotal += len(w.buf) + len(dict_vals)
        bw = max(int(nuniq - 1).bit_length(), 1)
        encoding = 8
    if spec["defs"] is not None:
        dl_all = spec["defs"]
    elif nullable:
        dl_all = col.validity.cpu().numpy().astype(np.int32)
    else:
        dl_all = None
    nulls = int((dl_all < spec["max_def"]).sum()) if dl_all is not None else 0
    if data_page_rows and spec["max_rep"] == 0 and nv > data_page_rows:
        ranges = [(i, min(i + data_page_rows, nv)) for i in range(0, nv, data_page_rows)]
    else:
        ranges = [(0, nv)]
    pv = None
    if dl_all is not None:
        pv = np.zeros(nv + 1, np.int64)
        np.cumsum(dl_all == spec["max_def"], out=pv[1:])
    data_off = f.tell()
    pages_meta = []
    for r0, r1 in ranges:
        page_off = f.tell()
        dl_page = dl_all[r0:r1] if dl_all is not None else None
        lvl = b""
        if spec["max_rep"]:
            lvl += _encode_levels(spec["rep"], spec["max_rep"])
        nulls_page = 0
        if dl_page is not None:
            lvl += _encode_levels(dl_page, spec["max_def"])
            nulls_page = int((dl_page < spec["max_def"]).sum())
        if len(ranges) == 1:
            mn_p, mx_p = mn, mx
            if indices is not None:
                vals = bytes([bw]) + _native.rle_hybrid_encode(indices, bw)
            else:
                vals = vals_all if vals_all is not None else enc_all.plain()
        else:
            sub = _Encoded(_slice_col(col, r0, r1), False)
            mn_p, mx_p = sub.mn, sub.mx
            a = pv[r0] if pv is not None else r0
            b = pv[r1] if pv is not None else r1
            if indices is not None:
                vals = bytes([bw]) + _native.rle_hybrid_encode(indices[a:b], bw)
            elif delta_vals is not None:
                vals = _native.delta_binary_encode(delta_vals[a:b])
            else:
                vals = sub.plain()
        npage = r1 - r0
        w = CompactWriter()
        if data_page_version == 2 and spec["max_rep"] == 0:
            cbody = _compress(vals, codec)
            lvl2 = lvl[4:] if lvl else b""           # v2 levels: no length prefix
            _write_page_header_v2(w, npage, nulls_page, npage, encoding, len(lvl2) + len(vals),
                                  len(lvl2) + len(cbody), len(lvl2), codec != 0)
            f.write(bytes(w.buf))
            f.write(lvl2)
            f.write(cbody)
            utotal += len(w.buf) + len(lvl2) + len(vals)
        else:
            body = lvl + vals
            cbody = _compress(body, codec)
            _write_page_header(w, npage, encoding, len(body), len(cbody))
            f.write(bytes(w.buf))
            f.write(cbody)
            utotal += len(w.buf) + len(body)
        pages_meta.append(dict(off=page_off, size=f.tell() - page_off, first_row=r0,
                               mn=mn_p, mx=mx_p, nulls=nulls_page,
                               all_null=nulls_page == r1 - r0))
    bloom = _sbbf_build(enc_all) if spec["path"][0] in bloom_cols and \
        spec["max_rep"] == 0 else None
    conv, lg = _logical(col.dtype)
    return dict(path=spec["path"], type=pt, offset=offset, nv=nv, total=f.tell() - offset,
                utotal=utotal, mn=mn, mx=mx, nulls=nulls, nullable=nullable, codec=codec,
                encoding=encoding, dict_off=dict_off, data_off=data_off, pages=pages_meta,
                bloom=bloom, conv=conv, logical=lg)


def _write_indexes(f, row_groups_meta, write_page_index: bool):
    """Bloom filters and the page index, before the footer (the PageIndex
    layout): the footer's ColumnChunk fields point at them."""
    for rg in row_groups_meta:
        for c in rg["cols"]:
            if c.get("bloom"):
                c["bloom_off"] = f.tell()
                w = CompactWriter()
                _write_bloom_header(w, len(c["bloom"]))
                f.write(bytes(w.buf))
                f.write(c["bloom"])
                c["bloom_len"] = f.tell() - c["bloom_off"]
    if not write_page_index:
        return
    for rg in row_groups_meta:
        for c in rg["cols"]:
            pages = c["pages"]
            if any(p["mn"] is None and not p["all_null"] for p in pages):
                continue                  # no statistics (booleans)
            w = CompactWriter()
            w.begin_struct()              # ColumnIndex
            w.begin_list(1, _CT_TRUE, len(pages))
            for p in pages:
                w.buf.append(1 if p["all_null"] else 2)
            for fid, key in ((2, "mn"), (3, "mx")):
                w.begin_list(fid, _CT_BINARY, len(pages))
                for p in pages:
                    v = p[key] or b""
                    w._varint(len(v))
                    w.buf += v
            w.write_i(4, 0, _CT_I32)      # boundary_order UNORDERED
            w.begin_list(5, _CT_I64, len(pages))
            for p in pages:
                w._zigzag(p["nulls"])
            w.end_struct()
            c["ci_off"] = f.tell()
            f.write(bytes(w.buf))
            c["ci_len"] = f.tell() - c["ci_off"]
    for rg in row_groups_meta:
        for c in rg["cols"]:
            w = CompactWriter()
            w.begin_struct()              # OffsetIndex
            w.begin_list(1, _CT_STRUCT, len(c["pages"]))
            for p in c["pages"]:
                w.begin_struct()          # PageLocation
                w.write_i(1, p["off"], _CT_I64)
                w.write_i(2, p["size"], _CT_I32)
                w.write_i(3, p["first_row"], _CT_I64)
                w.end_struct()
            w.end_struct()
            c["oi_off"] = f.tell()
            f.write(bytes(w.buf))
            c["oi_len"] = f.tell() - c["oi_off"]


def _footer(table, names, n: int, row_groups_meta) -> bytes:
    leaves = row_groups_meta[0]["cols"] if row_groups_meta else []
    by_path = {c["path"]: c for c in leaves}
    # the schema tree in pre-order: (name, repetition, physical type or
    # None, children, converted type or None, logical type or None)
    els = []
    for name in names:
        col0 = table[name]
        if col0.dtype.is_list:
            c = by_path[(name, "list", "element")]
            els.append((name, 1, None, 1, 3, None))
            els.append(("list", 2, None, 1, None, None))
            els.append(("element", 1, c["type"], 0, 0 if c["type"] == _PT_BA else c["conv"],
                        c["logical"]))
        elif col0.dtype.is_struct:
            fields = col0.dtype.fields or ()
            els.append((name, 1 if col0.validity is not None else 0, None, len(fields), None,
                        None))
            for fname, _ in fields:
                c = by_path[(name, fname)]
                els.append((fname, 1, c["type"], 0, 0 if c["type"] == _PT_BA else c["conv"],
                            c["logical"]))
        else:
            c = by_path[(name,)]
            els.append((name, 1 if c["nullable"] else 0, c["type"], 0,
                        0 if c["type"] == _PT_BA else c["conv"], c["logical"]))
    w = CompactWriter()
    w.begin_struct()
    w.write_i(1, 2, _CT_I32)              # version
    w.begin_list(2, _CT_STRUCT, 1 + len(els))
    w.begin_struct()                      # root
    w.write_binary(4, b"schema")
    w.write_i(5, len(names), _CT_I32)
    w.end_struct()
    for nm, repn, pt, nkids, conv, lg in els:
        w.begin_struct()
        if pt is not None:
            w.write_i(1, pt, _CT_I32)
        w.write_i(3, repn, _CT_I32)
        w.write_binary(4, str(nm).encode())
        if nkids:
            w.write_i(5, nkids, _CT_I32)
        if conv is not None:
            w.write_i(6, conv, _CT_I32)
        if lg is not None:
            _write_logical(w, lg)
        w.end_struct()
    w.write_i(3, n, _CT_I64)              # num_rows
    w.begin_list(4, _CT_STRUCT, len(row_groups_meta))
    for rg in row_groups_meta:
        w.begin_struct()                  # RowGroup
        w.begin_list(1, _CT_STRUCT, len(rg["cols"]))
        for c in rg["cols"]:
            w.begin_struct()              # ColumnChunk
            w.write_i(2, c["offset"], _CT_I64)
            w.begin_struct(3)             # ColumnMetaData
            w.write_i(1, c["type"], _CT_I32)
            encs = [3, c["encoding"]] if c["encoding"] else [3, 0]
            if c["dict_off"] is not None:
                encs.append(0)
            w.begin_list(2, _CT_I32, len(encs))
            for e in encs:
                w._zigzag(e)
            w.begin_list(3, _CT_BINARY, len(c["path"]))
            for seg in c["path"]:
                nm = str(seg).encode()
                w._varint(len(nm))
                w.buf += nm
            w.write_i(4, c["codec"], _CT_I32)
            w.write_i(5, c["nv"], _CT_I64)
            w.write_i(6, c["utotal"], _CT_I64)
            w.write_i(7, c["total"], _CT_I64)
            w.write_i(9, c["data_off"], _CT_I64)
            if c["dict_off"] is not None:
                w.write_i(11, c["dict_off"], _CT_I64)
            if c["mn"] is not None:
                w.begin_struct(12)        # Statistics
                w.write_i(3, c["nulls"], _CT_I64)
                w.write_binary(5, c["mx"])
                w.write_binary(6, c["mn"])
                w.end_struct()
            if c.get("bloom_off") is not None:
                w.write_i(14, c["bloom_off"], _CT_I64)
                w.write_i(15, c["bloom_len"], _CT_I32)
            w.end_struct()                # ColumnMetaData
            if c.get("oi_off") is not None:
                w.write_i(4, c["oi_off"], _CT_I64)
                w.write_i(5, c["oi_len"], _CT_I32)
            if c.get("ci_off") is not None:
                w.write_i(6, c["ci_off"], _CT_I64)
                w.write_i(7, c["ci_len"], _CT_I32)
            w.end_struct()                # ColumnChunk
        w.write_i(2, rg["bytes"], _CT_I64)
        w.write_i(3, rg["rows"], _CT_I64)
        w.end_struct()
    w.end_struct()
    footer = bytes(w.buf)
    return footer + struct.pack("<I", len(footer)) + b"PAR1"
