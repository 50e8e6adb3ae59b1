"""Avro container reader (port of ``cudf_tpu/io/avro.py``; libcudf's
``cpp/src/io/avro/``, python/cudf's ``read_avro(path, columns,
skiprows, num_rows)``).

Avro rows are varint-delimited, so a block decodes in order: each
block's records become columnar buffers in ``io_host.cpp``
(``avro_decode_block``, a value at a time), the blocks on
``HOST_THREADS`` threads (decompressed first, then decoded straight into
one set of column buffers), and each column makes one host-to-device
copy.  The schema and the container's
framing are host work, as the reference's are.

Supported, as the reference: null, boolean, int, long, float, double,
bytes, string, enum (a DICTIONARY column of its symbols), fixed, unions
of two branches with null (validity), and the logical date,
timestamp-millis and timestamp-micros; the codecs null, deflate and
snappy.  Other schemas raise ``NotImplementedError`` (the reference
rejects them too).  There is no writer (the reference has none).
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.core.table import Table
from cudf_tpu_torch.io import IO_ROUTES, _native

MAGIC = b"Obj\x01"
HOST_THREADS = min(8, os.cpu_count() or 1)
# the host decoder's kind codes (io_host.cpp io_avro_decode_block)
K_BOOL, K_INT, K_LONG, K_FLOAT, K_DOUBLE = 0, 1, 2, 3, 4
K_BYTES, K_STRING, K_ENUM, K_NULL, K_FIXED = 5, 6, 7, 8, 9
PRIMITIVE = {"null": K_NULL, "boolean": K_BOOL, "int": K_INT, "long": K_LONG,
             "float": K_FLOAT, "double": K_DOUBLE, "bytes": K_BYTES, "string": K_STRING}
_TEXT = (K_BYTES, K_STRING, K_FIXED)


class Field:
    __slots__ = ("name", "kind", "null_branch", "extra", "symbols", "logical")

    def __init__(self, name, kind, null_branch=-1, extra=0, symbols=None, logical=None):
        self.name = name
        self.kind = kind
        self.null_branch = null_branch
        self.extra = extra
        self.symbols = symbols
        self.logical = logical


def _resolve(t: Any, named: Dict[str, Any]) -> Tuple[int, int, Optional[list], Optional[str]]:
    """(kind, extra, symbols, logical type) of one type that is no union."""
    if isinstance(t, str):
        if t in PRIMITIVE:
            return PRIMITIVE[t], 0, None, None
        if t in named:
            return _resolve(named[t], named)
        raise NotImplementedError(f"avro: unsupported type {t!r}")
    if isinstance(t, dict):
        base = t.get("type")
        if base == "enum":
            named[t["name"]] = t
            return K_ENUM, 0, list(t["symbols"]), None
        if base == "fixed":
            named[t["name"]] = t
            return K_FIXED, int(t["size"]), None, None
        if base in PRIMITIVE:
            return PRIMITIVE[base], 0, None, t.get("logicalType")
        raise NotImplementedError(f"avro: unsupported complex type {base!r}")
    raise NotImplementedError(f"avro: unsupported schema node {t!r}")


def parse_schema(schema_json: str) -> List[Field]:
    schema = json.loads(schema_json)
    if not isinstance(schema, dict) or schema.get("type") != "record":
        raise NotImplementedError("avro: top-level schema must be a record")
    named: Dict[str, Any] = {}
    fields = []
    for f in schema["fields"]:
        t, null_branch = f["type"], -1
        if isinstance(t, list):
            if len(t) != 2 or "null" not in t:
                raise NotImplementedError("avro: only 2-branch unions with null are supported")
            null_branch = t.index("null")
            t = t[1 - null_branch]
        kind, extra, symbols, logical = _resolve(t, named)
        fields.append(Field(f["name"], kind, null_branch, extra, symbols, logical))
    return fields


# ----------------------------------------------------------------------
# container framing
# ----------------------------------------------------------------------

class Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def zigzag(self) -> int:
        v = shift = 0
        while True:
            b = self.data[self.pos]
            self.pos += 1
            v |= (b & 0x7F) << shift
            if not b & 0x80:
                return (v >> 1) ^ -(v & 1)
            shift += 7

    def take(self, n: int):
        out = self.data[self.pos:self.pos + n]
        if len(out) != n:
            raise ValueError("avro: truncated container")
        self.pos += n
        return out


def read_header(r: Reader) -> Tuple[Dict[str, bytes], bytes]:
    if bytes(r.take(4)) != MAGIC:
        raise ValueError("avro: bad magic")
    meta: Dict[str, bytes] = {}
    while True:
        cnt = r.zigzag()
        if cnt == 0:
            break
        if cnt < 0:                    # a negative count: a byte size follows
            cnt = -cnt
            r.zigzag()
        for _ in range(cnt):
            key = bytes(r.take(r.zigzag())).decode("utf-8")
            meta[key] = bytes(r.take(r.zigzag()))
    return meta, bytes(r.take(16))


def decompress(block, codec: str):
    if codec in ("", "null"):
        return block
    if codec == "deflate":
        return zlib.decompress(block, wbits=-15)
    if codec == "snappy":
        # Avro's snappy: a raw snappy block, then the big-endian CRC32 of the plain bytes
        plain = _native.snappy_decompress(block[:-4])
        if zlib.crc32(plain) & 0xFFFFFFFF != struct.unpack(">I", bytes(block[-4:]))[0]:
            raise ValueError("avro: snappy block CRC mismatch")
        return plain
    raise NotImplementedError(f"avro: codec {codec!r}")


class _Buffers:
    """Every field's host buffers for the blocks read, which the blocks
    decode straight into on the host threads (one allocation a buffer:
    many small ones fault their pages under one lock and stop the threads
    from overlapping).  A string field's offsets hold each block's
    ``count + 1`` entries one block after another, its chars each
    block's bytes at the block's place in the decompressed stream."""

    def __init__(self, fields, counts, sizes):
        self.counts = np.asarray(counts, np.int64)
        self.rows = np.concatenate([[0], np.cumsum(self.counts)]).astype(np.int64)
        self.bytes = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        n, nb = int(self.rows[-1]), len(counts)
        self.fields = []
        for f in fields:
            valid = np.empty(n, np.uint8)
            if f.kind in _TEXT:
                self.fields.append((np.empty(n + nb, np.int64),
                                    np.empty(int(self.bytes[-1]), np.uint8), valid))
            else:
                vals = np.empty(0 if f.kind == K_NULL else n, _native.AVRO_VALUE_DTYPES[f.kind])
                self.fields.append((vals, None, valid))

    def block(self, k: int):
        """Block k's views of every field's buffers."""
        r0, r1, b0, b1 = (int(x) for x in (self.rows[k], self.rows[k + 1], self.bytes[k],
                                            self.bytes[k + 1]))
        out = []
        for vals, chars, valid in self.fields:
            if chars is not None:
                out.append((vals[r0 + k:r1 + k + 1], chars[b0:b1], valid[r0:r1]))
            else:
                out.append((vals[r0:r1] if vals.size else vals, None, valid[r0:r1]))
        return out

    def strings(self, f: int, device):
        """(chars, offsets) of string field f over every block, on ``device``
        (the offsets' prefix sum there)."""
        from cudf_tpu_torch.ops.strings import new_offsets

        offs, chars, _ = self.fields[f]
        nb = self.counts.size
        lens = torch.diff(torch.from_numpy(offs).to(device))
        keep = torch.ones(lens.shape[0], dtype=torch.bool, device=device)
        keep[torch.from_numpy(self.rows[1:-1] + np.arange(nb - 1)).to(device)] = False
        used = offs[self.rows[1:] + np.arange(nb)]               # each block's last offset
        parts = [chars[int(self.bytes[k]):int(self.bytes[k] + used[k])] for k in range(nb)]
        host = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
        return torch.from_numpy(host).to(device), new_offsets(lens[keep])


# ----------------------------------------------------------------------
# columns
# ----------------------------------------------------------------------

def make_column(f: Field, bufs: _Buffers, i: int, lo: int, hi: int, device) -> Column:
    """Field i's column over decoded rows [lo, hi)."""
    vals_np, _, valid_np = bufs.fields[i]
    valid_np = valid_np[lo:hi]
    n = hi - lo
    valid = None if valid_np.all() else torch.from_numpy(valid_np.astype(bool)).to(device)
    if f.kind in _TEXT:
        # bytes and fixed become STRING columns, as the reference's
        chars, offs = bufs.strings(i, device)
        if (lo, hi) != (0, offs.shape[0] - 1):
            offs = offs[lo:hi + 1]
            a, b = (int(x) for x in offs[[0, -1]].tolist())
            chars, offs = chars[a:b], offs - a
        return Column(dt.STRING, n, chars, valid, offs)
    if f.kind == K_NULL:
        return Column(dt.FLOAT64, n, torch.full((n,), float("nan"), dtype=torch.float64,
                                                device=device),
                      torch.zeros(n, dtype=torch.bool, device=device))
    data = torch.from_numpy(np.ascontiguousarray(vals_np[lo:hi])).to(device)
    if f.kind == K_ENUM:
        keys = Column.from_strings(list(f.symbols or []), device=device)
        return Column(dt.dictionary_dtype(dt.STRING), n, data, valid, children=(keys,))
    if f.kind == K_BOOL:
        return Column(dt.BOOL8, n, data.bool(), valid)
    if f.logical == "date" and f.kind == K_INT:
        return Column(dt.TIMESTAMP_S, n, data.long() * 86400, valid)
    if f.logical == "timestamp-millis" and f.kind == K_LONG:
        return Column(dt.TIMESTAMP_MS, n, data, valid)
    if f.logical == "timestamp-micros" and f.kind == K_LONG:
        return Column(dt.TIMESTAMP_US, n, data, valid)
    kind_dt = {K_INT: dt.INT32, K_LONG: dt.INT64, K_FLOAT: dt.FLOAT32, K_DOUBLE: dt.FLOAT64}
    return Column(kind_dt[f.kind], n, data, valid)


def read_avro(filepath_or_buffer, columns=None, skiprows: int = 0,
              num_rows: Optional[int] = None, *, device="cuda", **kw):
    """An Avro container file as a DataFrame on ``device``."""
    from cudf_tpu_torch.frame.dataframe import DataFrame
    from cudf_tpu_torch.frame.index import default_index

    if hasattr(filepath_or_buffer, "read"):
        data = filepath_or_buffer.read()
    elif isinstance(filepath_or_buffer, (bytes, bytearray)):
        data = bytes(filepath_or_buffer)
    else:
        with open(filepath_or_buffer, "rb") as fh:
            data = fh.read()
    view = memoryview(data)
    r = Reader(view)
    meta, sync = read_header(r)
    fields = parse_schema(meta["avro.schema"].decode("utf-8"))
    codec = meta.get("avro.codec", b"null").decode("utf-8")
    skip = int(skiprows or 0)
    want = None if num_rows is None or num_rows < 0 else int(num_rows)
    desc = [(f.kind, f.null_branch, f.extra) for f in fields]
    # the blocks in the window (skipped blocks unread), then the window's
    # rows [lo, hi) of the rows the blocks decode
    blocks, counts, lo, got = [], [], None, 0
    while r.pos < len(data) and (want is None or got < want):
        cnt, size = r.zigzag(), r.zigzag()
        block = r.take(size)
        if bytes(r.take(16)) != sync:
            raise ValueError("avro: sync marker mismatch")
        if skip >= cnt:
            skip -= cnt
            continue
        if lo is None:
            lo, skip = sum(counts) + skip, 0
        blocks.append(block)
        counts.append(cnt)
        got = sum(counts) - lo
    lo = lo or 0
    hi = sum(counts) if want is None else min(sum(counts), lo + want)
    with ThreadPoolExecutor(HOST_THREADS) as pool:
        plain = list(pool.map(lambda b: decompress(b, codec), blocks))
        bufs = _Buffers(fields, counts, [len(p) for p in plain])
        list(pool.map(lambda k: _native.avro_decode_block(plain[k], counts[k], desc,
                                                          into=bufs.block(k)),
                      range(len(blocks))))
    cols = {f.name: make_column(f, bufs, i, lo, hi, device) for i, f in enumerate(fields)
            if columns is None or f.name in columns}
    if columns:
        cols = {c: cols[c] for c in columns if c in cols}
    IO_ROUTES["native"] += 1
    t = Table(cols)
    return DataFrame._from(t, default_index(t.num_rows))
