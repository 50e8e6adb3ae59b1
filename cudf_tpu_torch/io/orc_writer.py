"""ORC writer (port of ``cudf_tpu/io/orc_writer.py``): protobuf metadata,
RLEv2 (DIRECT_V2) integer and length streams, bit-packed booleans under
byte RLE, PRESENT streams, and zlib or snappy chunk framing.

For numeric, bool and STRING frames the file is byte for byte the
reference's ``write_orc_native``'s.  The encoders are the reference's
greedy ones in ``io_host.cpp`` (RLEv2: fixed-step segments of at least
6 values as DELTA or SHORT_REPEAT runs, the rest DIRECT runs of <= 512;
byte RLE and RLEv1 in runs of 3..130 and literal groups of <= 128).
Each column moves to the host once; its stripes then encode and
compress on ``HOST_THREADS`` threads, a (stripe, column) a job, and are
written in order.

Where the reference is wrong, the writer is not: a DICTIONARY column is
written as its strings (the reference raises ImportError), and a
timestamp column as ORC TIMESTAMP (seconds from 2015-01-01 and the
nanoseconds with their trailing zeros folded, as ORC's C++ writer
writes them, with the GMT writer time zone; a day-unit one as DATE),
where the reference writes bare LONG ticks, and an unsigned column takes
the next wider signed kind (the reference writes uint16 as SHORT, which
pyarrow reads back wrapped).  Durations stay LONG ticks, as the
reference writes them.
"""

from __future__ import annotations

import os
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np

from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.io import _native

K_BOOL, K_BYTE, K_SHORT, K_INT, K_LONG = 0, 1, 2, 3, 4
K_FLOAT, K_DOUBLE, K_STRING, K_STRUCT = 5, 6, 7, 12
K_DATE, K_TIMESTAMP = 15, 9
STREAM_PRESENT, STREAM_DATA, STREAM_LENGTH, STREAM_SECONDARY = 0, 1, 2, 5
ENC_DIRECT, ENC_DIRECT_V2 = 0, 2
COMP_IDS = {None: 0, "none": 0, "uncompressed": 0, "zlib": 1, "snappy": 2}
BLOCK = 262144
HOST_THREADS = min(8, os.cpu_count() or 1)
ORC_EPOCH_S = 1_420_070_400


class ProtoWriter:
    """Protobuf (proto2 wire format) encoder."""

    def __init__(self):
        self.buf = bytearray()

    def varint(self, v: int):
        while v >= 0x80:
            self.buf.append((v & 0x7F) | 0x80)
            v >>= 7
        self.buf.append(v)

    def field_varint(self, fn: int, v: int):
        self.varint(fn << 3)
        self.varint(v)

    def field_bytes(self, fn: int, b: bytes):
        self.varint((fn << 3) | 2)
        self.varint(len(b))
        self.buf += b

    def field_packed(self, fn: int, vals):
        w = ProtoWriter()
        for v in vals:
            w.varint(v)
        self.field_bytes(fn, bytes(w.buf))

    def bytes(self) -> bytes:
        return bytes(self.buf)


# ----------------------------------------------------------------------
# run-length encoders (in io_host.cpp)
# ----------------------------------------------------------------------

def rle1_encode_ints(vals: np.ndarray, signed: bool) -> bytes:
    return _native.orc_rle1_encode(vals, signed)


def rle2_encode_ints(vals: np.ndarray, signed: bool) -> bytes:
    return _native.orc_rle2_encode(vals, signed)


def byte_rle_encode(vals: np.ndarray) -> bytes:
    return _native.orc_byte_rle_encode(vals)


def bool_rle_encode(bits: np.ndarray) -> bytes:
    """Booleans packed most significant bit first, then byte RLE."""
    return byte_rle_encode(np.packbits(np.asarray(bits).astype(bool)))


def compress_stream(data: bytes, compression: Optional[str], block: int = BLOCK) -> bytes:
    """ORC's chunk framing of ``block``-byte chunks: a 3-byte header
    (length << 1 | is_original) and the raw deflate (level 1) or snappy
    bytes, or the chunk itself when those are not smaller."""
    if compression in (None, "none", "uncompressed"):
        return data
    out = bytearray()
    for i in range(0, len(data), block):
        chunk = data[i:i + block]
        if compression == "zlib":
            comp = zlib.compress(chunk, 1)[2:-4]
        elif compression == "snappy":
            comp = _native.snappy_compress(chunk)
        else:
            raise NotImplementedError(f"ORC compression {compression}")
        if len(comp) < len(chunk):
            hdr, body = len(comp) << 1, comp
        else:
            hdr, body = (len(chunk) << 1) | 1, chunk
        out += bytes([hdr & 0xFF, (hdr >> 8) & 0xFF, (hdr >> 16) & 0xFF])
        out += body
    return bytes(out)


# ----------------------------------------------------------------------
# columns on the host, and one stripe of one column encoded
# ----------------------------------------------------------------------

def writable(col) -> bool:
    d = col.dtype
    return d.is_numeric or d.is_bool or d.is_string or d.is_dictionary or d.is_temporal


class _HostColumn:
    """A column's buffers on the host: data (or chars and offsets) and
    validity (None when every row is valid)."""

    def __init__(self, col):
        import torch

        if col.dtype.is_dictionary:
            col = col.decode_dictionary()
        self.dtype = col.dtype
        v = col.validity
        self.valid = None if v is None or bool(v.all()) else v.cpu().numpy()
        if col.dtype.is_string:
            self.offsets = col.offsets.cpu().numpy()
            self.chars = col.data.cpu().numpy()
        else:
            data = col.data
            if data.dtype == torch.bool:
                data = data.to(torch.uint8)
            self.data = data.cpu().numpy()


def _nanos_field(nanos: np.ndarray) -> np.ndarray:
    """ORC's SECONDARY values: trailing decimal zeros folded into the low
    3 bits (formatNano of ORC's writers); nanos keep the seconds' sign."""
    out = nanos << 3
    n = np.where(nanos % 100 == 0, nanos // 100, 0)
    tz = np.where((nanos != 0) & (nanos % 100 == 0), 1, 0)
    for _ in range(6):
        more = (tz > 0) & (tz < 7) & (n % 10 == 0)
        n = np.where(more, n // 10, n)
        tz = tz + more
    return np.where(tz > 0, (n << 3) | tz, out)


def _trunc_div(a: np.ndarray, b: int):
    q = np.abs(a) // b * np.sign(a)
    return q, a - q * b


def encode_stripe(col: _HostColumn, start: int, stop: int, compression):
    """(orc kind, [(stream kind, framed bytes)], encoding) of rows
    [start, stop) of a column."""
    streams: List[Tuple[int, bytes]] = []
    valid = None if col.valid is None else col.valid[start:stop]
    if valid is not None and valid.all():
        valid = None
    if valid is not None:
        streams.append((STREAM_PRESENT, bool_rle_encode(valid)))
    d = col.dtype
    if d.is_string:
        offs = col.offsets[start:stop + 1]
        lens = np.diff(offs)
        chars = col.chars[offs[0]:offs[-1]]
        if valid is not None:
            chars = chars[np.repeat(valid, lens)]
            lens = lens[valid]
        streams.append((STREAM_DATA, chars.tobytes()))
        streams.append((STREAM_LENGTH, rle2_encode_ints(lens, False)))
        kind, enc = K_STRING, ENC_DIRECT_V2
    else:
        data = col.data[start:stop]
        if valid is not None:
            data = data[valid]
        if d.is_bool:
            streams.append((STREAM_DATA, bool_rle_encode(data)))
            kind, enc = K_BOOL, ENC_DIRECT
        elif d.is_timestamp and d.id == dt.TypeId.TIMESTAMP_DAYS:
            streams.append((STREAM_DATA, rle2_encode_ints(data.astype(np.int64), True)))
            kind, enc = K_DATE, ENC_DIRECT_V2
        elif d.is_timestamp:
            per_s = {dt.TypeId.TIMESTAMP_SECONDS: 1, dt.TypeId.TIMESTAMP_MILLISECONDS: 1000,
                     dt.TypeId.TIMESTAMP_MICROSECONDS: 10 ** 6}.get(d.id, 10 ** 9)
            secs, rest = _trunc_div(data.astype(np.int64), per_s)
            streams.append((STREAM_DATA, rle2_encode_ints(secs - ORC_EPOCH_S, True)))
            streams.append((STREAM_SECONDARY,
                            rle2_encode_ints(_nanos_field(rest * (10 ** 9 // per_s)), False)))
            kind, enc = K_TIMESTAMP, ENC_DIRECT_V2
        elif d.is_temporal:                      # durations: LONG ticks, as the reference
            streams.append((STREAM_DATA, rle2_encode_ints(data.astype(np.int64), True)))
            kind, enc = K_LONG, ENC_DIRECT_V2
        elif data.dtype.kind in "iu":
            # an unsigned width takes the next signed kind (the reference's
            # uint16 as SHORT reads back wrapped)
            size = data.dtype.itemsize * (2 if data.dtype.kind == "u" else 1)
            kind = K_SHORT if size <= 2 else (K_INT if size == 4 else K_LONG)
            streams.append((STREAM_DATA, rle2_encode_ints(data.astype(np.int64), True)))
            enc = ENC_DIRECT_V2
        elif data.dtype == np.float32:
            streams.append((STREAM_DATA, data.astype("<f4").tobytes()))
            kind, enc = K_FLOAT, ENC_DIRECT
        else:
            streams.append((STREAM_DATA, data.astype("<f8").tobytes()))
            kind, enc = K_DOUBLE, ENC_DIRECT
    return kind, [(k, compress_stream(raw, compression)) for k, raw in streams], enc


def write_orc_native(table, path: str, stripe_size: int = 1 << 20,
                     compression: Optional[str] = None) -> None:
    """A Table as a flat-schema ORC file: stripes of ``stripe_size`` rows,
    compression None, "zlib" or "snappy"."""
    names = list(table.names)
    n = table.num_rows
    comp_id = COMP_IDS[compression]
    host = [_HostColumn(c) for c in table.columns]
    bounds = [(a, min(a + stripe_size, n)) for a in range(0, n, stripe_size)] or [(0, 0)]
    with ThreadPoolExecutor(HOST_THREADS) as pool:
        encoded = list(pool.map(lambda job: encode_stripe(host[job[1]], *job[0], compression),
                                [(b, c) for b in bounds for c in range(len(names))]))
    has_time = any(c.dtype.is_timestamp for c in host)
    stripes, kinds = [], [k for k, _, _ in encoded[:len(names)]]
    with open(path, "wb") as f:
        f.write(b"ORC")
        for s, (start, stop) in enumerate(bounds):
            offset = f.tell()
            cols = encoded[s * len(names):(s + 1) * len(names)]
            meta, data_len = [], 0
            for ci, (_, streams, _) in enumerate(cols):
                for kind, framed in streams:
                    f.write(framed)
                    meta.append((kind, ci + 1, len(framed)))
                    data_len += len(framed)
            sf = ProtoWriter()
            for kind, colid, ln in meta:
                st = ProtoWriter()
                st.field_varint(1, kind)
                st.field_varint(2, colid)
                st.field_varint(3, ln)
                sf.field_bytes(1, st.bytes())
            for e in [ENC_DIRECT] + [enc for _, _, enc in cols]:   # the root struct, then leaves
                enc = ProtoWriter()
                enc.field_varint(1, e)
                sf.field_bytes(2, enc.bytes())
            if has_time:
                sf.field_bytes(3, b"GMT")
            sf_raw = compress_stream(sf.bytes(), compression)
            f.write(sf_raw)
            stripes.append((offset, data_len, len(sf_raw), stop - start))
        ft = ProtoWriter()
        ft.field_varint(1, 3)                     # headerLength ("ORC")
        ft.field_varint(2, f.tell())
        for offset, data_len, footer_len, rows in stripes:
            st = ProtoWriter()
            for fn, v in ((1, offset), (2, 0), (3, data_len), (4, footer_len), (5, rows)):
                st.field_varint(fn, v)
            ft.field_bytes(3, st.bytes())
        root = ProtoWriter()
        root.field_varint(1, K_STRUCT)
        root.field_packed(2, list(range(1, len(names) + 1)))
        for name in names:
            root.field_bytes(3, str(name).encode())
        ft.field_bytes(4, root.bytes())
        for k in kinds:
            t = ProtoWriter()
            t.field_varint(1, k)
            ft.field_bytes(4, t.bytes())
        ft.field_varint(6, n)
        ft.field_varint(8, 0)                     # rowIndexStride: no row index
        footer_raw = compress_stream(ft.bytes(), compression)
        f.write(footer_raw)
        ps = ProtoWriter()
        ps.field_varint(1, len(footer_raw))
        ps.field_varint(2, comp_id)
        ps.field_varint(3, BLOCK)
        ps.field_packed(4, [0, 12])               # file version 0.12
        ps.field_varint(5, 0)                     # metadataLength
        ps.field_varint(6, 1)                     # writerVersion
        ps.field_bytes(8000, b"ORC")
        ps_raw = ps.bytes()
        f.write(ps_raw)
        f.write(bytes([len(ps_raw)]))
