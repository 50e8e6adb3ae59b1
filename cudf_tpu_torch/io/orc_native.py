"""ORC reader (port of ``cudf_tpu/io/orc_native.py``): protobuf metadata,
stream decompression and stripe decode, for flat schemas.

The split is the Parquet reader's.  The host reads the file once, walks
the protobuf footers, decompresses each stream (zlib by Python's
``zlib``, snappy by ``io_host.cpp``, zstd by ``zstandard``) and walks
only the HEADERS of its runs in ``io_host.cpp`` (byte RLE: a count and a
payload a run; RLEv2: SHORT_REPEAT, DIRECT, PATCHED_BASE and DELTA run
descriptors plus the patch list), on ``HOST_THREADS`` threads, a
(stripe, column) a job, a column's jobs ahead of the device decoding the
column before it.  The device expands every value at once from the
stream bytes, each stripe's copied to its place in one buffer a column: a DIRECT value's bits
shifted out big-endian, a DELTA run a prefix sum, the patches or-ed in,
PRESENT bits unpacked and the values scattered under them; strings are
gathered from their data or dictionary bytes.  RLEv1 integer streams
(varint literals, ORC 0.11 files) decode in C.

Covered: the compressions NONE, ZLIB, SNAPPY and ZSTD; BOOLEAN, BYTE,
SHORT, INT, LONG, FLOAT, DOUBLE, STRING/VARCHAR/CHAR/BINARY (DIRECT and
DICTIONARY, v1 and v2), DATE and TIMESTAMP (written in GMT).  Nested
and decimal columns, LZO, LZ4, TIMESTAMP_INSTANT and another writer
time zone raise ``UnsupportedOrc``, which ``read_orc`` gives to pyarrow.
Columns keep ORC's widths (SHORT int16, INT int32, FLOAT float32, DATE
days), as pyarrow reads them.
"""

from __future__ import annotations

import os
import warnings
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.core.table import Table
from cudf_tpu_torch.io import _native

HOST_THREADS = min(8, os.cpu_count() or 1)
# values a device expansion handles at once (its [n, 9] byte windows)
CHUNK = 1 << 24
ORC_EPOCH_S = 1_420_070_400         # 2015-01-01 00:00:00 UTC: TIMESTAMP's zero
_GMT = ("GMT", "UTC", "Etc/UTC", "Etc/GMT", "")


class UnsupportedOrc(NotImplementedError):
    """A shape the native reader declares unsupported (the pyarrow tier's)."""


# ----------------------------------------------------------------------
# protobuf (wire format): the footers
# ----------------------------------------------------------------------

class ProtoReader:
    def __init__(self, buf: bytes, pos: int = 0, end: Optional[int] = None):
        self.buf = buf
        self.pos = pos
        self.end = len(buf) if end is None else end

    def varint(self) -> int:
        v = s = 0
        while True:
            b = self.buf[self.pos]
            self.pos += 1
            v |= (b & 0x7F) << s
            if not b & 0x80:
                return v
            s += 7

    def fields(self):
        """(field number, wire type, value) until the end."""
        while self.pos < self.end:
            key = self.varint()
            fn, wt = key >> 3, key & 7
            if wt == 0:
                yield fn, wt, self.varint()
            elif wt == 2:
                ln = self.varint()
                yield fn, wt, bytes(self.buf[self.pos:self.pos + ln])
                self.pos += ln
            elif wt in (1, 5):
                k = 8 if wt == 1 else 4
                yield fn, wt, bytes(self.buf[self.pos:self.pos + k])
                self.pos += k
            else:
                raise ValueError(f"protobuf wire type {wt}")


def _proto_dict(buf: bytes) -> Dict[int, list]:
    out: Dict[int, list] = {}
    for fn, _, v in ProtoReader(buf).fields():
        out.setdefault(fn, []).append(v)
    return out


def _first(d: Dict[int, list], fn: int, default=0):
    return d[fn][0] if fn in d else default


def _packed(values) -> List[int]:
    """A repeated uint32: packed (one blob of varints) or one a field."""
    out = []
    for v in values:
        if isinstance(v, bytes):
            r = ProtoReader(v)
            while r.pos < r.end:
                out.append(r.varint())
        else:
            out.append(v)
    return out


@dataclass
class OrcStream:
    kind: int          # 0 PRESENT 1 DATA 2 LENGTH 3 DICTIONARY_DATA 5 SECONDARY 6 ROW_INDEX ...
    column: int
    length: int


@dataclass
class OrcStripe:
    offset: int
    index_length: int
    data_length: int
    footer_length: int
    num_rows: int
    streams: List[OrcStream] = field(default_factory=list)
    encodings: List[int] = field(default_factory=list)
    dict_sizes: List[int] = field(default_factory=list)
    timezone: str = ""


@dataclass
class OrcMeta:
    compression: int           # 0 NONE 1 ZLIB 2 SNAPPY 3 LZO 4 LZ4 5 ZSTD
    block_size: int
    num_rows: int
    types: List[dict]          # a column's {"kind", "subtypes", "names", "precision", "scale"}
    stripes: List[OrcStripe]


K = {"BOOLEAN": 0, "BYTE": 1, "SHORT": 2, "INT": 3, "LONG": 4, "FLOAT": 5, "DOUBLE": 6,
     "STRING": 7, "BINARY": 8, "TIMESTAMP": 9, "LIST": 10, "MAP": 11, "STRUCT": 12,
     "UNION": 13, "DECIMAL": 14, "DATE": 15, "VARCHAR": 16, "CHAR": 17,
     "TIMESTAMP_INSTANT": 18}
_INTS = {K["SHORT"]: dt.INT16, K["INT"]: dt.INT32, K["LONG"]: dt.INT64}
_STRINGS = (K["STRING"], K["VARCHAR"], K["CHAR"], K["BINARY"])
_SUPPORTED = {K["BOOLEAN"], K["BYTE"], K["SHORT"], K["INT"], K["LONG"], K["FLOAT"],
              K["DOUBLE"], K["TIMESTAMP"], K["DATE"], *_STRINGS}


def _tail(raw: np.ndarray):
    """(postscript, footer bytes) of the file's bytes."""
    ps_len = int(raw[-1])
    ps = _proto_dict(raw[-1 - ps_len:-1].tobytes())
    footer_len = _first(ps, 1)
    end = raw.size - 1 - ps_len
    return ps, raw[end - footer_len:end]


def parse_metadata(raw: np.ndarray) -> OrcMeta:
    ps, footer = _tail(raw)
    compression, block_size = _first(ps, 2), _first(ps, 3, 262144)
    fd = _proto_dict(decompress_stream(footer, compression, block_size).tobytes())
    types = []
    for traw in fd.get(4, []):
        td = _proto_dict(traw)
        types.append({"kind": _first(td, 1), "subtypes": _packed(td.get(2, [])),
                      "names": [n.decode() for n in td.get(3, [])],
                      "precision": _first(td, 5), "scale": _first(td, 6)})
    stripes = [OrcStripe(*(_first(sd, k) for k in (1, 2, 3, 4, 5)))
               for sd in map(_proto_dict, fd.get(3, []))]
    return OrcMeta(compression, block_size, _first(fd, 6), types, stripes)


def read_orc_metadata(path: str) -> OrcMeta:
    return parse_metadata(np.fromfile(path, np.uint8))


def decompress_stream(data, compression: int, block_size: int) -> np.ndarray:
    """A stream's bytes (uint8) under ORC's chunk framing: a 3-byte
    little-endian header a chunk, (length << 1) | is_original."""
    data = np.asarray(data, np.uint8) if not isinstance(data, np.ndarray) else data
    if compression == 0:
        return data
    if compression not in (1, 2, 5):
        raise UnsupportedOrc(f"ORC compression {compression} (LZO, LZ4)")
    out = []
    pos, n = 0, data.size
    while pos + 3 <= n:
        hdr = int(data[pos]) | (int(data[pos + 1]) << 8) | (int(data[pos + 2]) << 16)
        pos += 3
        chunk = data[pos:pos + (hdr >> 1)]
        pos += hdr >> 1
        if hdr & 1:
            out.append(chunk)
        elif compression == 1:
            out.append(np.frombuffer(zlib.decompress(chunk, -15), np.uint8))
        elif compression == 2:
            out.append(_native.snappy_decompress(chunk))
        else:
            import zstandard

            out.append(np.frombuffer(zstandard.ZstdDecompressor().decompress(
                chunk.tobytes(), max_output_size=block_size), np.uint8))
    if len(out) == 1:
        return out[0]
    return np.concatenate(out) if out else np.zeros(0, np.uint8)


def read_stripe_footer(raw: np.ndarray, stripe: OrcStripe, meta: OrcMeta) -> None:
    at = stripe.offset + stripe.index_length + stripe.data_length
    sd = _proto_dict(decompress_stream(raw[at:at + stripe.footer_length], meta.compression,
                                       meta.block_size).tobytes())
    stripe.streams = [OrcStream(*(_first(d, k) for k in (1, 2, 3)))
                      for d in map(_proto_dict, sd.get(1, []))]
    encs = [_proto_dict(e) for e in sd.get(2, [])]
    stripe.encodings = [_first(d, 1) for d in encs]
    stripe.dict_sizes = [_first(d, 2) for d in encs]
    stripe.timezone = sd[3][0].decode() if 3 in sd else ""


def column_streams(raw: np.ndarray, stripe: OrcStripe, meta: OrcMeta, col_id: int):
    """{stream kind: decompressed bytes} of one column in one stripe; the
    streams list covers the index region, then the data region, in file
    order."""
    pos, out = stripe.offset, {}
    for s in stripe.streams:
        if s.column == col_id and s.kind in (0, 1, 2, 3, 5):
            out[s.kind] = decompress_stream(raw[pos:pos + s.length], meta.compression,
                                            meta.block_size)
        pos += s.length
    return out


# ----------------------------------------------------------------------
# host stage: a (stripe, column)'s streams and their run headers
# ----------------------------------------------------------------------

@dataclass
class _Ints:
    """An integer stream staged: its bytes and RLEv2 runs, or (RLEv1) its
    values decoded on the host."""
    data: np.ndarray
    count: int
    runs: Optional[np.ndarray] = None
    patch_pos: Optional[np.ndarray] = None
    patch_val: Optional[np.ndarray] = None
    values: Optional[np.ndarray] = None


@dataclass
class _Bytes:
    """A byte RLE stream staged: its bytes and runs."""
    data: np.ndarray
    count: int
    runs: tuple


def _ints(data: Optional[np.ndarray], v2: bool, signed: bool) -> _Ints:
    data = np.zeros(0, np.uint8) if data is None else data
    if not v2:
        values = _native.orc_rle1_decode(data, -1, signed)
        return _Ints(data, values.size, values=values)
    runs, ppos, pval = _native.orc_rle2_runs(data, -1, signed)
    count = int(runs[-1, 0] + runs[-1, 1]) if runs.shape[0] else 0
    return _Ints(data, count, runs, ppos, pval)


def _bytes(data: Optional[np.ndarray]) -> _Bytes:
    data = np.zeros(0, np.uint8) if data is None else data
    runs = _native.orc_byte_rle_runs(data)
    count = int(runs[0][-1] + runs[1][-1]) if runs[0].size else 0
    return _Bytes(data, count, runs)


def stage(raw: np.ndarray, stripe: OrcStripe, meta: OrcMeta, col_id: int, kind: int) -> dict:
    """A (stripe, column) job of the host: decompress, walk headers."""
    streams = column_streams(raw, stripe, meta, col_id)
    enc = stripe.encodings[col_id]
    v2 = enc in (2, 3)
    out = {"rows": stripe.num_rows}
    if 0 in streams:
        out["present"] = _bytes(streams[0])
    if kind in _INTS or kind == K["DATE"]:
        out["data"] = _ints(streams.get(1), v2, True)
    elif kind in (K["BYTE"], K["BOOLEAN"]):
        out["data"] = _bytes(streams.get(1))
    elif kind in (K["FLOAT"], K["DOUBLE"]):
        out["data"] = streams.get(1, np.zeros(0, np.uint8))
    elif kind == K["TIMESTAMP"]:
        if stripe.timezone not in _GMT:
            raise UnsupportedOrc(f"ORC TIMESTAMP written in the time zone {stripe.timezone}")
        out["data"] = _ints(streams.get(1), v2, True)
        out["nanos"] = _ints(streams.get(5), v2, False)
    elif enc in (1, 3):                                   # DICTIONARY strings
        out["index"] = _ints(streams.get(1), v2, False)
        out["dict_lengths"] = _ints(streams.get(2), v2, False)
        out["dict_data"] = streams.get(3, np.zeros(0, np.uint8))
    else:                                                 # DIRECT strings
        out["lengths"] = _ints(streams.get(2), v2, False)
        out["chars"] = streams.get(1, np.zeros(0, np.uint8))
    return out


# ----------------------------------------------------------------------
# device stage
# ----------------------------------------------------------------------

def _upload(parts: List[np.ndarray], device):
    """(one device buffer of the parts, each part's byte offset in it):
    each part copied to its place, with no concatenation on the host."""
    sizes = [p.size for p in parts]
    starts = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    out = torch.empty(int(starts[-1]), dtype=torch.uint8, device=device)
    with warnings.catch_warnings():     # read-only parts (zlib's bytes) are only read
        warnings.simplefilter("ignore", UserWarning)
        for p, a in zip(parts, starts):
            out[int(a):int(a) + p.size].copy_(torch.from_numpy(p))
    return out, starts


def _positions(starts: torch.Tensor, lo: int, hi: int):
    """(run, position within the run) of outputs lo..hi."""
    i = torch.arange(lo, hi, device=starts.device)
    r = torch.searchsorted(starts, i, right=True) - 1
    return r, i - starts[r]


def expand_bytes(staged: List[_Bytes], device) -> torch.Tensor:
    """uint8 bytes of byte RLE streams, one after another."""
    buf, at = _upload([s.data for s in staged], device)
    cols, base = [], 0
    for s, off in zip(staged, at):
        start, length, literal, payload = s.runs
        cols.append(np.stack([start + base, length, literal.astype(np.int64),
                              np.where(literal, payload + off, payload)], 1))
        base += s.count
    if base == 0:
        return torch.zeros(0, dtype=torch.uint8, device=device)
    runs = torch.from_numpy(np.concatenate(cols)).to(device)
    out = torch.empty(base, dtype=torch.uint8, device=device)
    padded = torch.cat([buf, buf.new_zeros(1)])
    for lo in range(0, base, CHUNK):
        hi = min(base, lo + CHUNK)
        r, j = _positions(runs[:, 0].contiguous(), lo, hi)
        lit = runs[r, 2] == 1
        src = torch.where(lit, runs[r, 3] + j, buf.shape[0])
        out[lo:hi] = torch.where(lit, padded[src], runs[r, 3].to(torch.uint8))
    return out


def expand_bits(staged: List[_Bytes], counts: List[int], device) -> torch.Tensor:
    """bool values of boolean RLE streams (bits most significant first),
    ``counts[k]`` of stream k."""
    parts = []
    for s, c in zip(staged, counts):
        b = expand_bytes([s], device)
        bits = (b.unsqueeze(1) >> torch.arange(7, -1, -1, device=device, dtype=torch.uint8)) & 1
        if bits.numel() < c:
            raise ValueError("ORC boolean stream ends before its values")
        parts.append(bits.reshape(-1)[:c].bool())
    return torch.cat(parts) if parts else torch.zeros(0, dtype=torch.bool, device=device)


def _be_bits(buf: torch.Tensor, bitpos: torch.Tensor, width: torch.Tensor) -> torch.Tensor:
    """int64 (as its bits) of ``width`` (0..64) bits big-endian at each bit
    position; bytes past the buffer read as 0."""
    byte0 = (bitpos >> 3).clamp(max=buf.shape[0])
    s = bitpos & 7
    padded = torch.cat([buf, buf.new_zeros(9)])
    k = torch.arange(9, device=buf.device)
    block = padded[byte0.unsqueeze(1) + k].long()
    hi = (block[:, :8] << (56 - 8 * k[:8])).sum(1)       # wraps as uint64 bits
    x = (hi << s) | (block[:, 8] >> (8 - s))
    w = width.clamp(1, 63)
    low = (x >> (64 - w)) & ((torch.ones_like(w) << w) - 1)
    return torch.where(width == 64, x, torch.where(width == 0, torch.zeros_like(x), low))


def expand_ints(staged: List[_Ints], signed: bool, device) -> torch.Tensor:
    """int64 values of integer streams, one after another: RLEv2 runs
    expanded (SHORT_REPEAT a constant; DIRECT bits, unzigzagged when
    signed; PATCHED_BASE base + bits | patch; DELTA base plus a prefix sum
    of its steps within the run), RLEv1 values copied."""
    if staged and staged[0].runs is None:
        host = np.concatenate([s.values for s in staged])
        return torch.from_numpy(host).to(device)
    buf, at = _upload([s.data for s in staged], device)
    runs, ppos, pval, base = [], [], [], 0
    for s, off in zip(staged, at):
        r = s.runs.copy()
        r[:, 0] += base
        r[:, 4] += 8 * off
        runs.append(r)
        ppos.append(s.patch_pos + base)
        pval.append(s.patch_val)
        base += s.count
    out = torch.empty(base, dtype=torch.int64, device=device)
    if base == 0:
        return out
    runs_d = torch.from_numpy(np.concatenate(runs)).to(device)
    starts = runs_d[:, 0].contiguous()
    # a DELTA value is its run's base plus the steps from the run's start:
    # a prefix sum over every chunk (carried), less its value at the start
    carry = torch.zeros((), dtype=torch.int64, device=device)
    at_start = torch.zeros(runs_d.shape[0], dtype=torch.int64, device=device)
    for lo in range(0, base, CHUNK):
        hi = min(base, lo + CHUNK)
        r, j = _positions(starts, lo, hi)
        kind, width, bitpos = runs_d[r, 2], runs_d[r, 3], runs_d[r, 4]
        run_base, delta0 = runs_d[r, 5], runs_d[r, 6]
        is_delta = kind == 2
        at_bits = bitpos + torch.where(is_delta, (j - 2).clamp(min=0), j) * width
        bits = _be_bits(buf, at_bits, torch.where(kind == 0, 0, width))
        steps = torch.where(j == 0, 0, torch.where((j == 1) | (width == 0), delta0,
                                                   torch.where(delta0 < 0, -bits, bits)))
        prefix = torch.cumsum(torch.where(is_delta, steps, 0), 0) + carry
        carry = prefix[-1].clone()
        first = j == 0
        at_start[r[first]] = prefix[first]
        direct = ((bits >> 1) & ((1 << 63) - 1)) ^ -(bits & 1) if signed else bits
        out[lo:hi] = torch.where(kind == 0, run_base, torch.where(
            kind == 1, direct, torch.where(kind == 3, run_base + bits,
                                           run_base + prefix - at_start[r])))
    ppos = np.concatenate(ppos)
    if ppos.size:                        # PATCHED_BASE: base + (bits | patch)
        pos = torch.from_numpy(ppos).to(device)
        run_base = runs_d[torch.searchsorted(starts, pos, right=True) - 1, 5]
        patch = torch.from_numpy(np.concatenate(pval)).to(device)
        out[pos] = run_base + ((out[pos] - run_base) | patch)
    return out


def _scatter_present(values: torch.Tensor, valid: Optional[torch.Tensor], n: int,
                     what: str) -> torch.Tensor:
    """The present rows' values spread over ``n`` rows under ``valid``."""
    if valid is None:
        if values.shape[0] != n:
            raise ValueError(f"ORC column {what}: {values.shape[0]} values for {n} rows")
        return values
    full = torch.zeros(n, dtype=values.dtype, device=values.device)
    if int(valid.sum()) != values.shape[0]:
        raise ValueError(f"ORC column {what}: {values.shape[0]} values for "
                         f"{int(valid.sum())} present rows")
    return full.masked_scatter_(valid, values)


def _strings(jobs: List[dict], valid: Optional[torch.Tensor], n: int, device) -> Column:
    from cudf_tpu_torch.ops.strings import gather_ranges, new_offsets

    if "lengths" in jobs[0]:
        lens = expand_ints([j["lengths"] for j in jobs], False, device)
        chars, _ = _upload([j["chars"] for j in jobs], device)
        lens = _scatter_present(lens, valid, n, "lengths")
        offsets = new_offsets(lens)
        return Column(dt.STRING, n, chars[:int(offsets[-1])], valid, offsets)
    # DICTIONARY: each stripe's dictionary, its index offset by the
    # dictionaries before it, gathered from one concatenation
    dict_lens = expand_ints([j["dict_lengths"] for j in jobs], False, device)
    dict_chars, _ = _upload([j["dict_data"] for j in jobs], device)
    index = expand_ints([j["index"] for j in jobs], False, device)
    sizes = [j["dict_lengths"].count for j in jobs]
    counts = [j["index"].count for j in jobs]
    shift = np.repeat(np.concatenate([[0], np.cumsum(sizes)[:-1]]), counts).astype(np.int64)
    index = index + torch.from_numpy(shift).to(device)
    dict_starts = new_offsets(dict_lens)[:-1]
    lens = _scatter_present(dict_lens[index], valid, n, "dictionary index")
    starts = _scatter_present(dict_starts[index], valid, n, "dictionary index")
    offsets = new_offsets(lens)
    return Column(dt.STRING, n, gather_ranges(dict_chars, starts, offsets), valid, offsets)


def decode_column(jobs: List[dict], kind: int, device) -> Column:
    """One column from its stripes' staged jobs."""
    n = sum(j["rows"] for j in jobs)
    valid = None
    if any("present" in j for j in jobs):
        parts = []
        for j in jobs:
            if "present" in j:
                parts.append(expand_bits([j["present"]], [j["rows"]], device))
            else:
                parts.append(torch.ones(j["rows"], dtype=torch.bool, device=device))
        valid = torch.cat(parts)
        if bool(valid.all()):
            valid = None
    if kind in _STRINGS:
        return _strings(jobs, valid, n, device)
    if kind in (K["FLOAT"], K["DOUBLE"]):
        buf, _ = _upload([j["data"] for j in jobs], device)
        width = 4 if kind == K["FLOAT"] else 8
        values = buf[:buf.shape[0] // width * width].view(
            torch.float32 if width == 4 else torch.float64)
        return Column(dt.FLOAT32 if width == 4 else dt.FLOAT64, n,
                      _scatter_present(values, valid, n, "floats"), valid)
    if kind == K["BOOLEAN"]:
        counts = [j["data"].count * 8 for j in jobs]
        bits = expand_bits([j["data"] for j in jobs], counts, device)
        # each stripe's values are its present rows; the packing pads a byte
        keep = _present_counts(jobs, valid)
        bits = torch.cat([b[:k] for b, k in zip(torch.split(bits, counts), keep)])
        return Column(dt.BOOL8, n, _scatter_present(bits, valid, n, "booleans"), valid)
    if kind == K["BYTE"]:
        values = expand_bytes([j["data"] for j in jobs], device).view(torch.int8)
        return Column(dt.INT8, n, _scatter_present(values, valid, n, "bytes"), valid)
    values = expand_ints([j["data"] for j in jobs], True, device)
    if kind == K["TIMESTAMP"]:
        nraw = expand_ints([j["nanos"] for j in jobs], False, device)
        scale = nraw & 7
        mult = torch.where(scale == 0, 1, torch.pow(10, scale + 1))
        nanos = (nraw >> 3) * mult
        secs = values + ORC_EPOCH_S
        # ORC's C++ reader: a negative second with a positive nanosecond
        # part was written one second high (Java's writers)
        secs = torch.where((secs < 0) & (nanos > 999_999), secs - 1, secs)
        values = secs * 1_000_000_000 + nanos
        return Column(dt.TIMESTAMP_NS, n, _scatter_present(values, valid, n, "timestamps"),
                      valid)
    out_dt = dt.DType(dt.TypeId.TIMESTAMP_DAYS) if kind == K["DATE"] else _INTS[kind]
    values = values.to(out_dt.torch_storage)
    return Column(out_dt, n, _scatter_present(values, valid, n, "ints"), valid)


def _present_counts(jobs, valid) -> List[int]:
    if valid is None:
        return [j["rows"] for j in jobs]
    out, at = [], 0
    for j in jobs:
        out.append(int(valid[at:at + j["rows"]].sum()))
        at += j["rows"]
    return out


def read_orc_native(path: str, columns: Optional[List[str]] = None, *, device) -> Table:
    """A flat-schema ORC file's columns as a Table on ``device``."""
    raw = np.fromfile(path, np.uint8)
    meta = parse_metadata(raw)
    root = meta.types[0]
    if root["kind"] != K["STRUCT"]:
        raise UnsupportedOrc("an ORC file whose root is not a struct")
    names, child_ids = root["names"], [int(c) for c in root["subtypes"]]
    want = [n for n in names if columns is None or n in columns]
    for name, cid in zip(names, child_ids):
        if name in want and meta.types[cid]["kind"] not in _SUPPORTED:
            raise UnsupportedOrc(f"ORC column {name!r} of kind {meta.types[cid]['kind']} "
                                 "(nested, decimal or instant)")
    for stripe in meta.stripes:
        read_stripe_footer(raw, stripe, meta)
    wanted = [(name, cid, meta.types[cid]["kind"]) for name, cid in zip(names, child_ids)
              if name in want]
    cols = {}
    with ThreadPoolExecutor(HOST_THREADS) as pool:
        # every job submitted at once, a column's stripes after another's:
        # the device decodes a column while the threads stage the next
        staged = pool.map(lambda job: stage(raw, job[2], meta, job[1], job[0]),
                          [(kind, cid, st) for _, cid, kind in wanted for st in meta.stripes])
        for name, _, kind in wanted:
            jobs = [next(staged) for _ in meta.stripes]
            cols[name] = decode_column(jobs, kind, device) if jobs else \
                _empty_column(kind, device)
    if columns is not None:
        cols = {c: cols[c] for c in columns if c in cols}
    return Table(cols)


def _empty_column(kind: int, device) -> Column:
    if kind in _STRINGS:
        return Column(dt.STRING, 0, torch.zeros(0, dtype=torch.uint8, device=device), None,
                      torch.zeros(1, dtype=torch.int64, device=device))
    d = {K["BOOLEAN"]: dt.BOOL8, K["BYTE"]: dt.INT8, K["FLOAT"]: dt.FLOAT32,
         K["DOUBLE"]: dt.FLOAT64, K["TIMESTAMP"]: dt.TIMESTAMP_NS,
         K["DATE"]: dt.DType(dt.TypeId.TIMESTAMP_DAYS), **_INTS}[kind]
    return Column(d, 0, torch.zeros(0, dtype=d.torch_storage, device=device))
