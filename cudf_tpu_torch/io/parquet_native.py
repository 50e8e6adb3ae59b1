"""Self-contained Parquet reader (port of ``cudf_tpu/io/parquet_native.py``):
no pyarrow on the path.

A column chunk is read as libcudf reads it (reader_impl.cpp,
page_data.cu, rle_stream.cuh), split between host and device:

- host: the footer and page headers (``thrift.py``); the chunk's bytes
  read once; every page decompressed (``io_host.cpp`` snappy, or gzip /
  zstd) straight into one staging buffer (pinned when the target is a
  GPU), each page's values 8-byte aligned; the definition levels
  (``io_host.cpp`` RLE decode); the run headers of dictionary indices
  and the 4-byte lengths of PLAIN strings (pointer chases, in C);
- one host-to-device copy of the staging buffer a chunk;
- device: PLAIN values as views of the staged bytes, RLE / bit-packed
  dictionary indices expanded and gathered from the dictionary page,
  string chars gathered, DELTA pages unpacked, nulls spread
  (``parquet_device.py``).

Supported: INT32, INT64, FLOAT, DOUBLE, BYTE_ARRAY, BOOLEAN (PLAIN),
INT96, FIXED_LEN_BYTE_ARRAY up to 8 bytes (decimals); PLAIN, dictionary,
DELTA_BINARY_PACKED and DELTA_LENGTH_BYTE_ARRAY pages, v1 and v2; the
codecs none, snappy, gzip and zstd; one-level and deeper list / struct
schemas (``parquet_nested.py``).  Anything else raises
``UnsupportedParquet``, which ``read_parquet`` answers with the pyarrow
tier; every other error propagates.

Whole chunks are staged on the host by ``HOST_THREADS`` threads ahead of
the device decode (the C routines release the GIL).  ``PAGE_COUNTERS``
counts pages decoded and skipped (page-index pruning).  Setting
``TIMING`` to a dict makes each read add its phases' seconds to it, on
the same schedule: the reading thread's phases (footer, read,
decompress, levels, wait for a staged chunk, h2d, device) are spans of
the device's timeline that add up to the read; the staging threads'
phases (``workers_read``, ``workers_decompress``, ``workers_levels``) are
their seconds summed, which overlap those spans.  It is None otherwise.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from itertools import islice
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import Column, to_ticks
from cudf_tpu_torch.core.table import Table
from cudf_tpu_torch.io import _native, thrift
from cudf_tpu_torch.io import parquet_device as pdev
from cudf_tpu_torch.utils.config import get_option

_NP = {1: np.dtype("int32"), 2: np.dtype("int64"), 4: np.dtype("float32"),
       5: np.dtype("float64")}
_TORCH = {1: torch.int32, 2: torch.int64, 4: torch.float32, 5: torch.float64}
_CODEC_UNCOMPRESSED, _CODEC_SNAPPY, _CODEC_GZIP, _CODEC_ZSTD = 0, 1, 2, 6
_ENC_PLAIN, _ENC_RLE, _ENC_PLAIN_DICT, _ENC_RLE_DICT = 0, 3, 2, 8
_ENC_DELTA_BINARY, _ENC_DELTA_LENGTH_BA, _ENC_DELTA_BA = 5, 6, 7

PAGE_COUNTERS = {"decoded": 0, "skipped": 0}
TIMING: Optional[Dict[str, float]] = None
# threads that read, decompress and walk column chunks ahead of their
# device decode
HOST_THREADS = min(8, os.cpu_count() or 1)


class UnsupportedParquet(NotImplementedError):
    """A file shape the native tier declares unsupported (an encoding,
    codec or page type it lacks, FIXED_LEN_BYTE_ARRAY wider than 8 bytes,
    pandas extension metadata): ``read_parquet`` takes the pyarrow tier."""


class _Clock:
    """Phase timer of one read (``TIMING``).  On the reading thread a
    mark closes a span of the device's timeline (a CUDA event, recorded
    without a synchronization; the wall clock on the CPU); ``close``
    adds the spans up (one synchronization).  On a staging thread a mark
    adds that thread's seconds since its last mark to ``workers_<phase>``."""

    _lock = threading.Lock()

    def __init__(self, device):
        self.device = device
        self.on = TIMING is not None
        self.cuda = torch.device(device).type == "cuda"
        self.reader = threading.get_ident()
        self.local = threading.local()
        self.marks = [(None, self._now())] if self.on else []

    def _now(self):
        if not self.cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def begin(self) -> None:
        """A staging thread starts a chunk."""
        self.local.t = time.perf_counter()

    def mark(self, phase: str) -> None:
        if not self.on:
            return
        if threading.get_ident() == self.reader:
            self.marks.append((phase, self._now()))
            return
        now = time.perf_counter()
        with self._lock:
            key = "workers_" + phase
            TIMING[key] = TIMING.get(key, 0.0) + now - self.local.t
        self.local.t = now

    def close(self) -> None:
        if len(self.marks) < 2:
            return
        if self.cuda:
            self.marks[-1][1].synchronize()
        for (_, a), (phase, b) in zip(self.marks, self.marks[1:]):
            TIMING[phase] = TIMING.get(phase, 0.0) + (
                a.elapsed_time(b) / 1e3 if self.cuda else b - a)
        self.marks = self.marks[-1:]


# ----------------------------------------------------------------------
# host side: read, decompress, levels
# ----------------------------------------------------------------------

def _decompress_into(src, codec: int, out: np.ndarray) -> int:
    if codec == _CODEC_UNCOMPRESSED:
        a = np.frombuffer(src, np.uint8)
        out[:a.size] = a
        return a.size
    if codec == _CODEC_SNAPPY:
        return _native.snappy_decompress_into(src, out)
    if codec == _CODEC_GZIP:
        import gzip

        raw = gzip.decompress(bytes(src))
    elif codec == _CODEC_ZSTD:
        import zstandard

        raw = zstandard.ZstdDecompressor().decompress(bytes(src), max_output_size=out.size)
    else:
        raise UnsupportedParquet(f"codec {codec}")
    out[:len(raw)] = np.frombuffer(raw, np.uint8)
    return len(raw)


def _align(n: int) -> int:
    return (n + 7) & ~7


def _staging(nbytes: int, device) -> torch.Tensor:
    """A host uint8 buffer for one chunk: pinned memory when the target is
    a GPU (PyTorch caches pinned blocks; the copy out is synchronous)."""
    return torch.empty(nbytes, dtype=torch.uint8,
                       pin_memory=torch.device(device).type == "cuda")


class _Page:
    __slots__ = ("ph", "off", "body", "valid", "n_present", "reps", "defs", "walk")


def _walk_pages(raw, codec: int, num_values: int, clock, want=None):
    """Decompress every page of a chunk (or the data pages ``want`` keeps:
    indices among data pages) into one staging buffer.

    Returns (dictionary page or None, data pages, staging tensor); a
    page's ``off`` is its payload's position in the buffer."""
    heads = []
    pos, remaining = 0, num_values
    while remaining > 0 and pos < len(raw):
        ph = thrift.PageHeader.parse(raw, pos)
        pos += ph.header_len
        if ph.type not in (0, 2, 3):
            raise UnsupportedParquet(f"page type {ph.type}")
        heads.append((ph, pos))
        pos += ph.compressed_page_size
        if ph.type != 2:
            remaining -= ph.num_values
    data_i = 0
    keep = []
    for ph, p in heads:
        if ph.type != 2:
            if want is not None and data_i not in want:
                data_i += 1
                continue
            data_i += 1
        keep.append((ph, p))
    sizes = [_align(ph.uncompressed_page_size) for ph, _ in keep]
    staged = _staging(max(sum(sizes), 8), clock.device)
    buf = staged.numpy()
    raw = memoryview(raw)                # page slices without copies
    dictionary, pages, off = None, [], 0
    for (ph, p), size in zip(keep, sizes):
        page = _Page()
        page.ph, page.off = ph, off
        slot = buf[off:off + size]
        if ph.type == 3:
            lvl = ph.def_levels_byte_length + ph.rep_levels_byte_length
            slot[:lvl] = np.frombuffer(raw, np.uint8, lvl, p)
            body = raw[p + lvl:p + ph.compressed_page_size]
            if ph.v2_is_compressed:
                _decompress_into(body, codec, slot[lvl:])
            else:
                slot[lvl:lvl + len(body)] = np.frombuffer(body, np.uint8)
        else:
            _decompress_into(raw[p:p + ph.compressed_page_size], codec, slot)
        off += size
        if ph.type == 2:
            dictionary = page
        else:
            pages.append(page)
    return dictionary, pages, staged


def _levels(page: _Page, buf: np.ndarray, max_rep: int, max_def: int) -> int:
    """Decode a data page's levels on the host; the bytes they take."""
    ph = page.ph
    nv = ph.num_values
    payload = buf[page.off:page.off + ph.uncompressed_page_size]
    rbw = max(max_rep.bit_length(), 1) if max_rep else 0
    dbw = max(max_def.bit_length(), 1) if max_def else 0
    if ph.type == 3:
        rl, dl = ph.rep_levels_byte_length, ph.def_levels_byte_length
        reps = _native.rle_decode32(payload[:rl], rbw, nv) if max_rep else None
        if max_def and dl:
            defs = _native.rle_decode32(payload[rl:rl + dl], dbw, nv)
        else:
            defs = np.full(nv, max_def, np.int32) if max_def else None
        consumed = rl + dl
    else:
        consumed, reps, defs = 0, None, None
        for kind, bw, on in (("rep", rbw, max_rep), ("def", dbw, max_def)):
            if not on:
                continue
            ln = int.from_bytes(payload[consumed:consumed + 4].tobytes(), "little")
            lv = _native.rle_decode32(payload[consumed + 4:consumed + 4 + ln], bw, nv)
            consumed += 4 + ln
            if kind == "rep":
                reps = lv
            else:
                defs = lv
    page.reps, page.defs = reps, defs
    page.body = payload[consumed:]
    return consumed


# ----------------------------------------------------------------------
# device side
# ----------------------------------------------------------------------

def _view(dev: torch.Tensor, start: int, n: int, dtype: torch.dtype) -> torch.Tensor:
    size = torch.empty(0, dtype=dtype).element_size()
    seg = dev[start:start + n * size]
    if start % size:
        seg = seg.clone()
    return seg.view(dtype)


def _host_tensor(a: np.ndarray, pin: bool) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.pin_memory() if pin else t


def _host_walk(body: np.ndarray, phys: int, enc: int, n: int, base: int,
               pin: bool) -> Optional[torch.Tensor]:
    """The host side of a page's value stream, as an int64 tensor to copy
    to the device: a dictionary page's run descriptors ([3, runs]: first
    value, RLE value or bit offset in the staging buffer, packed), or
    PLAIN strings' (start in the staging buffer, length) pairs."""
    if enc in (_ENC_RLE_DICT, _ENC_PLAIN_DICT) and n:
        starts, _, packed, payload = _native.rle_runs(body[1:], int(body[0]), n)
        payload = np.where(packed, payload + 8 * (base + 1), payload)
        return _host_tensor(np.stack([starts, payload, packed.astype(np.int64)]), pin)
    if enc == _ENC_PLAIN and phys == 6:
        starts, lens, _ = _native.byte_array_walk(body, n)
        return _host_tensor(np.stack([starts + base, lens]), pin)
    return None


def _plain_values(dev: torch.Tensor, base: int, phys: int, n: int, type_length: int,
                  walk: Optional[torch.Tensor]):
    """PLAIN values of one page, present rows only: a tensor, or
    (offsets, chars) for BYTE_ARRAY (``walk``: its starts and lengths)."""
    from cudf_tpu_torch.ops.strings import gather_ranges, new_offsets

    if phys in _TORCH:
        return _view(dev, base, n, _TORCH[phys])
    if phys == 0:
        nbytes = (n + 7) // 8
        shifts = torch.arange(8, dtype=torch.uint8, device=dev.device)
        bits = (dev[base:base + nbytes].unsqueeze(1) >> shifts) & 1
        return bits.reshape(-1)[:n].bool()
    if phys == 3:                        # INT96: nanos of the day, then the julian day
        raw = dev[base:base + 12 * n].view(n, 12).long()
        nanos = sum(raw[:, k] << (8 * k) for k in range(8))
        jday = sum(raw[:, 8 + k] << (8 * k) for k in range(4))
        return (jday - 2440588) * 86_400_000_000_000 + nanos
    if phys == 7:                        # big-endian two's complement decimals
        tl = type_length
        if tl <= 0 or tl > 8:
            raise UnsupportedParquet(f"FIXED_LEN_BYTE_ARRAY of {tl} bytes")
        raw = dev[base:base + tl * n].view(n, tl).long()
        val = torch.zeros(n, dtype=torch.int64, device=dev.device)
        for j in range(tl):
            val = (val << 8) | raw[:, j]
        shift = 64 - 8 * tl
        return (val << shift) >> shift
    if phys == 6:
        pairs = walk.to(dev.device, non_blocking=True)
        offsets = new_offsets(pairs[1])
        return offsets, gather_ranges(dev, pairs[0], offsets)
    raise UnsupportedParquet(f"physical type {phys}")


def _page_values(page: _Page, dev: torch.Tensor, phys: int, type_length: int, dictionary):
    base = page.off + page.ph.uncompressed_page_size - page.body.size
    body, n, enc = page.body, page.n_present, page.ph.encoding
    if enc == _ENC_PLAIN:
        return _plain_values(dev, base, phys, n, type_length, page.walk)
    if enc == _ENC_DELTA_BINARY and phys in (1, 2):
        v, _ = pdev.device_delta_binary_decode(body, n, buf=dev, base=base)
        return v.to(_TORCH[phys])
    if enc == _ENC_DELTA_LENGTH_BA and phys == 6:
        return pdev.device_delta_length_byte_array(body, n, buf=dev, base=base)
    if enc in (_ENC_RLE_DICT, _ENC_PLAIN_DICT):
        if dictionary is None:
            raise ValueError("a dictionary-encoded page without a dictionary page")
        if n == 0:
            idx = torch.zeros(0, dtype=torch.int32, device=dev.device)
        else:
            runs = page.walk.to(dev.device, non_blocking=True)
            idx = pdev.expand(dev, runs, int(body[0]), n)
        if isinstance(dictionary, tuple):
            return pdev.device_dict_string_gather(idx, *dictionary)
        return dictionary[idx.long()]
    raise UnsupportedParquet(f"encoding {enc} of physical type {phys}")


def _join_values(parts, valid: Optional[np.ndarray], device):
    """Present values of several pages -> values over every row, nulls
    spread in (zeros under them); validity as a device tensor or None."""
    from cudf_tpu_torch.ops.strings import new_offsets

    mask = None if valid is None or valid.all() else torch.from_numpy(valid).to(device)
    if parts and isinstance(parts[0], tuple):
        lens = torch.cat([o[1:] - o[:-1] for o, _ in parts])
        chars = torch.cat([c for _, c in parts])
        if mask is not None:
            full = torch.zeros(valid.size, dtype=torch.int64, device=device)
            full[mask] = lens
            lens = full
        return (new_offsets(lens), chars), mask
    present = torch.cat(parts) if len(parts) != 1 else parts[0]
    if mask is None:
        return present, None
    full = torch.zeros(valid.size, dtype=present.dtype, device=device)
    full[mask] = present
    return full, mask


class _Staged:
    """One chunk with its host work done: pages decompressed into a
    staging tensor (pinned for a GPU), levels decoded, value streams
    walked."""
    __slots__ = ("staged", "dictionary", "pages")


def _stage_chunk(raw, meta: thrift.ColumnChunkMeta, leaf, clock, want=None) -> _Staged:
    """The host side of one chunk (thread-safe: it touches no device)."""
    st = _Staged()
    st.dictionary, st.pages, st.staged = _walk_pages(raw, meta.codec, meta.num_values, clock,
                                                     want)
    buf = st.staged.numpy()
    clock.mark("decompress")
    pin = st.staged.is_pinned()
    for page in st.pages:
        _levels(page, buf, leaf.max_rep, leaf.max_def)
        page.valid = None if page.defs is None else page.defs >= leaf.def_present
        page.n_present = (page.ph.num_values if page.valid is None
                          else int(np.count_nonzero(page.valid)))
        base = page.off + page.ph.uncompressed_page_size - page.body.size
        page.walk = _host_walk(page.body, leaf.phys, page.ph.encoding, page.n_present, base,
                               pin)
    if st.dictionary is not None:
        d = st.dictionary
        d.body = buf[d.off:d.off + d.ph.uncompressed_page_size]
        d.walk = _host_walk(d.body, leaf.phys, _ENC_PLAIN, d.ph.dict_num_values, d.off, pin)
    clock.mark("levels")
    return st


def _decode_staged(st: _Staged, leaf, clock):
    """The device side of one staged chunk: one copy of the staging
    buffer, then every page decoded there.  (present values per data
    page, the pages)."""
    dev = st.staged.to(clock.device, non_blocking=True)
    clock.mark("h2d")
    dictionary = st.dictionary
    if dictionary is not None:
        dictionary = _plain_values(dev, dictionary.off, leaf.phys, dictionary.ph.dict_num_values,
                                   leaf.type_length, dictionary.walk)
    parts = []
    for page in st.pages:
        PAGE_COUNTERS["decoded"] += 1
        parts.append(_page_values(page, dev, leaf.phys, leaf.type_length, dictionary))
    clock.mark("device")
    return parts, st.pages


def _decode_chunk(raw, meta: thrift.ColumnChunkMeta, leaf, clock, want=None):
    """(present values per data page, the pages) of one chunk, levels on
    the host, values on ``clock.device``.  ``leaf`` carries phys,
    type_length, max_rep, max_def, def_present."""
    return _decode_staged(_stage_chunk(raw, meta, leaf, clock, want), leaf, clock)


def _read_raw(f, meta: thrift.ColumnChunkMeta) -> bytes:
    f.seek(meta.dictionary_page_offset or meta.data_page_offset)
    return f.read(meta.total_compressed_size + (1 << 16))


class _Leaf:
    """A flat leaf's decode parameters."""

    def __init__(self, el: thrift.SchemaElement):
        self.el = el
        self.phys = el.type
        self.type_length = el.type_length or 0
        self.max_rep = 0
        self.max_def = self.def_present = 1 if el.repetition_type == 1 else 0


def _check_leaf(el: thrift.SchemaElement) -> None:
    if el.type == 7 and not 0 < (el.type_length or 0) <= 8:
        raise UnsupportedParquet(f"FIXED_LEN_BYTE_ARRAY of {el.type_length} bytes")


def _finish_chunk(decoded, el: thrift.SchemaElement, clock):
    parts, pages = decoded
    valid = None if el.repetition_type != 1 else (
        np.concatenate([p.valid for p in pages]) if pages else np.zeros(0, bool))
    out = _join_values(parts, valid, clock.device) if parts else (None, None)
    clock.mark("device")
    return out


def _host_jobs(path: str, jobs, clock, workers: int):
    """(job, staged chunk) for each job, (meta, leaf, ...), in order; the
    host stages (read, decompress, levels, walks) run ``workers`` at a
    time ahead of the caller's device stages."""
    def stage(job):
        meta, leaf = job[0], job[1]
        clock.begin()
        with open(path, "rb") as f:
            raw = _read_raw(f, meta)
        clock.mark("read")
        return _stage_chunk(raw, meta, leaf, clock)

    if workers <= 1 or len(jobs) <= 1:
        for job in jobs:
            yield job, stage(job)
        return
    with ThreadPoolExecutor(workers) as pool:
        it = iter(jobs)
        pending = deque((job, pool.submit(stage, job)) for job in islice(it, 2 * workers))
        while pending:
            job, fut = pending.popleft()
            nxt = next(it, None)
            if nxt is not None:
                pending.append((nxt, pool.submit(stage, nxt)))
            staged = fut.result()
            clock.mark("wait")
            yield job, staged


def read_column_chunk_pruned(f, meta, el, page_locs, intervals, rg_rows: int, clock):
    """Decode only the pages of one chunk that overlap ``intervals``
    (sorted disjoint row ranges of the group) and return exactly those
    rows: the page-skip read of libcudf's page-index filter."""
    from cudf_tpu_torch.ops import copying

    starts = [p.first_row_index for p in page_locs]
    bounds = starts[1:] + [rg_rows]
    want = [i for i in range(len(starts))
            if any(a < bounds[i] and b > starts[i] for a, b in intervals)]
    PAGE_COUNTERS["skipped"] += len(starts) - len(want)
    if not want:
        return None
    first = meta.dictionary_page_offset or page_locs[0].offset
    last = page_locs[want[-1]]
    f.seek(first)
    raw = f.read(last.offset + last.compressed_page_size - first + (1 << 12))
    clock.mark("read")
    parts, pages = _decode_chunk(raw, meta, _Leaf(el), clock, want=set(want))
    # every selected page as a column over its rows, then the interval rows
    base, pieces, col_parts = 0, [], []
    for i, part, page in zip(want, parts, pages):
        vals, mask = _join_values([part], page.valid if el.repetition_type == 1 else None,
                                  clock.device)
        col_parts.append(_finish(vals, mask, el, clock.device))
        for a, b in intervals:
            lo, hi = max(a, starts[i]), min(b, bounds[i])
            if lo < hi:
                pieces.append((base + lo - starts[i], base + hi - starts[i]))
        base += bounds[i] - starts[i]
    col = copying.concatenate(col_parts)
    out = copying.concatenate([copying.slice(col, a, b) for a, b in sorted(pieces)])
    clock.mark("device")
    return out


def _finish(values, mask, el: thrift.SchemaElement, device) -> Column:
    """A decoded leaf as a Column of its logical type (reader_impl.cpp's
    finalize: TIMESTAMP units, DATE days, INTEGER widths, decimals)."""
    lg, cv, phys = el.logical, el.converted_type, el.type
    if isinstance(values, tuple):
        offsets, chars = values
        return Column(dt.STRING, offsets.shape[0] - 1, chars.contiguous(), mask, offsets)
    n = values.shape[0]
    if phys == 3:
        return Column(dt.TIMESTAMP_NS, n, values, mask)
    if phys == 7 and (cv == 5 or (lg and lg[0] == "decimal")):
        scale = el.scale or (lg[1] if lg and lg[0] == "decimal" else 0)
        return Column(dt.decimal_dtype(-scale), n, values, mask)
    if (lg and lg[0] == "timestamp") or cv in (9, 10):
        unit = lg[1] if lg else ("ms" if cv == 9 else "us")
        return Column(dt.dtype(f"datetime64[{unit}]"), n, values.long(), mask)
    if (lg and lg[0] == "date") or cv == 6:
        return Column(dt.DType(dt.TypeId.TIMESTAMP_DAYS), n, values.int(), mask)
    if (lg and lg[0] == "int") or (cv is not None and 11 <= cv <= 18):
        bits, signed = (lg[1], lg[2]) if lg else (8 << ((cv - 11) & 3), cv >= 15)
        target = dt.dtype(np.dtype(f"{'i' if signed else 'u'}{bits // 8}"))
        ts = target.torch_storage
        if ts.itemsize == values.element_size():
            values = values.view(ts)
        else:
            values = values.to(ts)
        return Column(target, n, values, mask)
    return Column(dt.from_torch(values.dtype), n, values.contiguous(), mask)


def _empty(el: thrift.SchemaElement, device) -> Column:
    if el.type == 6:
        vals = (torch.zeros(1, dtype=torch.int64, device=device),
                torch.zeros(0, dtype=torch.uint8, device=device))
    elif el.type == 0:
        vals = torch.zeros(0, dtype=torch.bool, device=device)
    elif el.type in (3, 7):
        vals = torch.zeros(0, dtype=torch.int64, device=device)
    else:
        vals = torch.zeros(0, dtype=_TORCH[el.type], device=device)
    return _finish(vals, None, el, device)


# ----------------------------------------------------------------------
# row-group pruning
# ----------------------------------------------------------------------

def _filter_value(val, el: Optional[thrift.SchemaElement]):
    """A predicate literal in the column's stored terms: temporal literals
    as ticks of a TIMESTAMP column's unit (or days of a DATE)."""
    if el is None or isinstance(val, (str, bytes, bool, int, float)):
        return val
    lg, cv = el.logical, el.converted_type
    if (lg and lg[0] == "timestamp") or cv in (9, 10) or el.type == 3:
        unit = lg[1] if lg else ("ms" if cv == 9 else "us" if cv == 10 else "ns")
        return to_ticks(val, dt.dtype(f"datetime64[{unit}]"))
    if (lg and lg[0] == "date") or cv == 6:
        return to_ticks(val, dt.dtype("datetime64[s]")) // 86_400
    return val


def normalize_filters(filters, leaves: Dict[str, thrift.SchemaElement]):
    return [(name, op, _filter_value(val, leaves.get(name))) for name, op, val in filters]


def _rg_passes_filters(rg, filters) -> bool:
    """Row-group min/max pruning (predicate_pushdown.cpp): False only when
    the statistics prove no row can match the AND-list of (column, op,
    value)."""
    if not filters:
        return True
    stats = {}
    for cc in rg.columns:
        if cc.statistics is not None:
            stats[cc.path[-1] if cc.path else ""] = cc.statistics.decode(cc.type)
    for name, op, val in filters:
        if name not in stats:
            continue
        mn, mx = stats[name]
        if mn is None or mx is None:
            continue
        if isinstance(val, str) and isinstance(mn, (bytes, bytearray)):
            val = val.encode()
        try:
            if op in ("==", "=") and (val < mn or val > mx):
                return False
            if (op == "<" and mn >= val) or (op == "<=" and mn > val) or \
                    (op == ">" and mx <= val) or (op == ">=" and mx < val):
                return False
        except TypeError:
            continue
    return True


def prune_row_groups(path: str, filters) -> Tuple[int, int]:
    """(kept, total) row groups for the given filters."""
    md = thrift.read_file_metadata(path)
    leaves = {s.name: s for s in md.schema[1:] if s.num_children == 0}
    filters = normalize_filters(filters, leaves)
    return sum(1 for rg in md.row_groups if _rg_passes_filters(rg, filters)), \
        len(md.row_groups)


def _page_intervals_for_rg(path, rg, filters, wanted):
    """Kept row intervals of one group from its page index; None when the
    index is missing on a wanted or filter column; [] when the group is
    provably empty."""
    from cudf_tpu_torch.io import parquet_pushdown as ppd

    by_name = {(cc.path[-1] if cc.path else ""): cc for cc in rg.columns}
    for n in set(wanted) | {f[0] for f in filters if f[0] in by_name}:
        cc = by_name.get(n)
        if cc is None or cc.offset_index_offset is None:
            return None
    per_col: Dict[str, List] = {}
    for name, op, val in filters:
        if name in by_name:
            per_col.setdefault(name, []).append((op, val))
    intervals = [(0, rg.num_rows)]
    any_pruned = False
    for name, col_filters in per_col.items():
        cc = by_name[name]
        ci, oi = ppd.read_page_index(path, cc)
        if ci is None or not ci.min_values:
            continue
        keep = ppd.page_keep_intervals(ci, oi, rg.num_rows, col_filters, cc.type)
        intervals = ppd.intervals_intersect(intervals, keep)
        any_pruned = True
    return intervals if any_pruned else None


_CMP = {"==": torch.eq, "=": torch.eq, "!=": torch.ne, "<": torch.lt, "<=": torch.le,
        ">": torch.gt, ">=": torch.ge}


def _hybrid_exact_intervals(f, path, rg, filters, intervals, leaves, clock):
    """The filter columns first (libcudf's experimental/hybrid_scan.cpp):
    decode them over the kept intervals, evaluate the predicates exactly,
    and return the matching rows as intervals (gaps of <= 512 rows
    bridged; the residual filter trims them), so payload columns decode
    only pages holding matches.  None: not applicable."""
    from cudf_tpu_torch.io import parquet_pushdown as ppd

    by_name = {(cc.path[-1] if cc.path else ""): cc for cc in rg.columns}
    per_col: Dict[str, List] = {}
    for name, op, val in filters:
        if name not in by_name or op not in _CMP or by_name[name].type not in _NP:
            return None
        per_col.setdefault(name, []).append((op, val))
    if not per_col:
        return None
    rows = np.concatenate([np.arange(a, b) for a, b in intervals]) \
        if intervals else np.zeros(0, np.int64)
    mask = torch.ones(rows.shape[0], dtype=torch.bool, device=clock.device)
    for name, col_filters in per_col.items():
        cc = by_name[name]
        oi = ppd.read_offset_index(path, cc)
        col = read_column_chunk_pruned(f, cc, leaves[name], oi.page_locations, intervals,
                                       rg.num_rows, clock)
        for op, val in col_filters:
            if not isinstance(val, (int, float, np.integer, np.floating)) or \
                    isinstance(val, bool):
                return None
            mask &= _CMP[op](col.data, val)
        if col.validity is not None:
            mask &= col.validity
    hit = rows[mask.cpu().numpy()]
    if hit.size == 0:
        return []
    brk = np.nonzero(np.diff(hit) > 512)[0]
    starts = np.concatenate([[0], brk + 1])
    stops = np.concatenate([brk, [hit.size - 1]])
    return [(int(hit[a]), int(hit[b]) + 1) for a, b in zip(starts, stops)]


# ----------------------------------------------------------------------
# whole files
# ----------------------------------------------------------------------

def _every_page_kept(path: str, rg, wanted, intervals) -> bool:
    """Whether the kept row intervals overlap every page of every wanted
    column of the group: then the pruned read skips nothing, and the group
    reads whole (its rows outside the intervals go to the caller's exact
    predicate, as the rows of any page kept do)."""
    from cudf_tpu_torch.io import parquet_pushdown as ppd

    for cc in rg.columns:
        if (cc.path[-1] if cc.path else "") not in wanted:
            continue
        starts = [p.first_row_index for p in ppd.read_offset_index(path, cc).page_locations]
        bounds = starts[1:] + [rg.num_rows]
        if not all(any(a < b1 and b > a1 for a, b in intervals)
                   for a1, b1 in zip(starts, bounds)):
            return False
    return True


def read_footer(path: str) -> thrift.FileMetaData:
    return thrift.read_file_metadata(path)


def read_parquet_native(path: str, columns: Optional[List[str]] = None, filters=None,
                        row_groups: Optional[List[int]] = None, *, device) -> Table:
    """A file's columns as a Table on ``device``.

    filters: AND-list of (column, op, value): row groups pruned by their
    statistics and bloom filters, pages by the page index where the file
    has one (pruned groups and pages are never read), then the filter
    columns read first over what is left (libcudf's hybrid scan).
    Rows the metadata cannot rule out stay: the caller applies the exact
    predicate.  row_groups: an explicit subset (chunked reads)."""
    from cudf_tpu_torch.io import parquet_pushdown as ppd
    from cudf_tpu_torch.ops import copying

    clock = _Clock(device)
    md = read_footer(path)
    clock.mark("footer")
    if any(s.num_children for s in md.schema[1:]):
        from cudf_tpu_torch.io.parquet_nested import read_parquet_nested

        t = read_parquet_nested(path, md, columns, row_groups, clock,
                                normalize_filters(filters, {}) if filters else None)
        clock.close()
        return t
    leaves = {s.name: s for s in md.schema[1:]}
    for el in leaves.values():
        _check_leaf(el)
    wanted = list(columns) if columns else list(leaves)
    for n in wanted:
        if n not in leaves:
            raise KeyError(n)
    groups = md.row_groups
    if row_groups is not None:
        groups = [groups[i] for i in row_groups]
    if filters:
        filters = normalize_filters(filters, leaves)
        groups = [rg for rg in groups
                  if _rg_passes_filters(rg, filters) and ppd.rg_bloom_passes(path, rg, filters)]
    parts: Dict[str, List[Tuple[int, Column]]] = {n: [] for n in wanted}
    jobs = []                            # whole chunks: their host stages run ahead
    with open(path, "rb") as f:
        for g, rg in enumerate(groups):
            intervals = _page_intervals_for_rg(path, rg, filters, wanted) if filters else None
            if intervals == []:
                continue
            if intervals is not None and get_option("io.parquet.hybrid_scan"):
                exact = _hybrid_exact_intervals(f, path, rg, filters, intervals, leaves, clock)
                if exact == []:
                    continue
                if exact is not None:
                    intervals = exact
            if intervals is not None and _every_page_kept(path, rg, wanted, intervals):
                intervals = None         # no page to skip: whole chunks, staged ahead
            for cc in rg.columns:
                name = cc.path[-1] if cc.path else ""
                if name not in parts:
                    continue
                if intervals is None:
                    jobs.append((cc, _Leaf(leaves[name]), g, name))
                    continue
                oi = ppd.read_offset_index(path, cc)
                col = read_column_chunk_pruned(f, cc, leaves[name], oi.page_locations,
                                               intervals, rg.num_rows, clock)
                if col is not None:
                    parts[name].append((g, col))
    for (cc, leaf, g, name), st in _host_jobs(path, jobs, clock, HOST_THREADS):
        vals, mask = _finish_chunk(_decode_staged(st, leaf, clock), leaf.el, clock)
        if vals is not None:
            parts[name].append((g, _finish(vals, mask, leaf.el, device)))
    cols = {n: copying.concatenate([c for _, c in sorted(p, key=lambda gc: gc[0])])
            if p else _empty(leaves[n], device) for n, p in parts.items()}
    clock.mark("device")
    clock.close()
    return Table(cols)


def read_parquet_native_chunked(path: str, columns: Optional[List[str]] = None,
                                memory_budget: int = 1 << 30, filters=None, *, device):
    """Tables of row groups batched so that each pass's uncompressed size
    fits ``memory_budget`` (reader_impl_chunking.cu's pass governance,
    row-group granular)."""
    md = thrift.read_file_metadata(path)
    batch: List[int] = []
    used = 0
    for i, rg in enumerate(md.row_groups):
        sz = sum(cc.total_uncompressed_size for cc in rg.columns)
        if batch and used + sz > memory_budget:
            yield read_parquet_native(path, columns, filters, batch, device=device)
            batch, used = [], 0
        batch.append(i)
        used += sz
    if batch:
        yield read_parquet_native(path, columns, filters, batch, device=device)
