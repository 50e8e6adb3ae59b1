"""The host library of the readers and writers (port of
``cudf_tpu/native.py``, and of the sequential walks of the ORC and Avro
readers).

``cudf_tpu_torch/csrc/host/io_host.cpp`` has a plain C interface.  It is
compiled with ``g++ -O3 -shared -fPIC`` at first use, from the package's
own source only, into ``build/cudf_tpu_torch/`` beside the package, and
loaded with ``ctypes``; the library's file name carries a hash of the
source and flags, so a changed source is rebuilt and a stale library is
never loaded.  A failed build raises: there is no silent fallback.

The ``*_plain`` functions are the numpy versions of the reference's
loader, kept as the plain versions the tests hold the library to; the
readers and writers never call them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Tuple

import numpy as np

_PACKAGE = Path(__file__).resolve().parent.parent
SOURCE = _PACKAGE / "csrc" / "host" / "io_host.cpp"
BUILD_DIR = _PACKAGE.parent / "build" / "cudf_tpu_torch"
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int32
_SIGNATURES = {
    "io_snappy_max_compressed": (_I64, [_I64]),
    "io_snappy_compress": (_I64, [_P, _I64, _P]),
    "io_snappy_uncompressed_length": (_I64, [_P, _I64]),
    "io_snappy_decompress": (_I64, [_P, _I64, _P, _I64]),
    "io_bitunpack32": (_I64, [_P, _I64, _I32, _I64, _P]),
    "io_rle_decode32": (_I64, [_P, _I64, _I32, _I64, _P]),
    "io_rle_runs": (_I64, [_P, _I64, _I32, _I64, _P, _P, _P, _P, _I64]),
    "io_rle_hybrid_encode": (_I64, [_P, _I64, _I32, _P]),
    "io_byte_array_walk": (_I64, [_P, _I64, _I64, _P, _P]),
    "io_delta_binary_decode": (_I64, [_P, _I64, _I64, _P, _P]),
    "io_delta_binary_encode": (_I64, [_P, _I64, _P]),
    "io_xxhash64_fixed": (None, [_P, _I64, _I32, _P]),
    "io_xxhash64_var": (None, [_P, _P, _I64, _P]),
    "io_sbbf_insert": (None, [_P, _I64, _P, _I64]),
    "io_multibyte_split": (_I64, [_P, _I64, _P, _I64, _P]),
    "io_avro_decode_block": (_I64, [_P, _I64, _I64, _P, _I32, _P]),
    "io_orc_byte_rle_runs": (_I64, [_P, _I64, _I64, _P, _P, _P, _P, _I64]),
    "io_orc_rle2_runs": (_I64, [_P, _I64, _I64, _I32, _P, _I64, _P, _P, _I64, _P]),
    "io_orc_rle1_decode": (_I64, [_P, _I64, _I64, _I32, _P]),
    "io_orc_rle2_encode": (_I64, [_P, _I64, _I32, _P]),
    "io_orc_rle1_encode": (_I64, [_P, _I64, _I32, _P]),
    "io_orc_byte_rle_encode": (_I64, [_P, _I64, _P]),
}

_lib = None
_LOCK = threading.Lock()          # one build and load, whatever thread asks first
# seconds the last build took (0.0: the library was already built)
BUILD_SECONDS = 0.0


def library_path() -> Path:
    h = hashlib.sha256(" ".join((CXX,) + CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libio_host_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile io_host.cpp unless a build of the same source exists; its
    path.  Raises RuntimeError with the compiler's output on failure."""
    global BUILD_SECONDS
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([CXX, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                              capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"building {SOURCE.name} failed: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE.name} failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)          # atomic: a concurrent loader never sees half a file
    BUILD_SECONDS = time.perf_counter() - t0
    return out


def lib():
    """The loaded library (built at the first call)."""
    global _lib
    if _lib is None:
        with _LOCK:
            if _lib is None:
                cdll = ctypes.CDLL(str(build()))
                for name, (res, args) in _SIGNATURES.items():
                    fn = getattr(cdll, name)
                    fn.restype = res
                    fn.argtypes = args
                _lib = cdll
    return _lib


def _u8(data) -> np.ndarray:
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data.view(np.uint8).reshape(-1))
    return np.frombuffer(memoryview(data), dtype=np.uint8)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_P)


# ----------------------------------------------------------------------
# snappy
# ----------------------------------------------------------------------

def snappy_compress(data) -> bytes:
    src = _u8(data)
    out = np.empty(lib().io_snappy_max_compressed(src.size), np.uint8)
    n = lib().io_snappy_compress(_ptr(src), src.size, _ptr(out))
    return out[:n].tobytes()


def snappy_uncompressed_length(data) -> int:
    src = _u8(data)
    n = lib().io_snappy_uncompressed_length(_ptr(src), src.size)
    if n < 0:
        raise ValueError("snappy: bad length preamble")
    return n


def snappy_decompress_into(data, out: np.ndarray) -> int:
    """Decompress into the uint8 array ``out``; the bytes written."""
    src = _u8(data)
    n = lib().io_snappy_decompress(_ptr(src), src.size, _ptr(out), out.size)
    if n < 0:
        raise ValueError({-1: "snappy: block overruns its input",
                          -2: "snappy: bad copy offset",
                          -3: "snappy: output buffer too small"}[n])
    return n


def snappy_decompress(data) -> np.ndarray:
    out = np.empty(snappy_uncompressed_length(data), np.uint8)
    n = snappy_decompress_into(data, out)
    return out[:n]


# ----------------------------------------------------------------------
# RLE / bit-packed hybrid
# ----------------------------------------------------------------------

def bitunpack32(data, bit_width: int, count: int) -> np.ndarray:
    src = _u8(data)
    out = np.empty(count, np.int32)
    if lib().io_bitunpack32(_ptr(src), src.size, bit_width, count, _ptr(out)) < 0:
        raise ValueError("bit_width must be in [0, 32]")
    return out


def rle_decode32(data, bit_width: int, count: int) -> np.ndarray:
    src = _u8(data)
    out = np.empty(count, np.int32)
    if lib().io_rle_decode32(_ptr(src), src.size, bit_width, count, _ptr(out)) < 0:
        raise ValueError("bit_width must be in [0, 32]")
    return out


def rle_runs(data, bit_width: int, count: int):
    """(starts, lengths, packed, payload) of the hybrid stream's runs (the
    reference ``parquet_device.parse_rle_runs``'s contract, walked in C):
    run r makes values [starts[r], starts[r] + lengths[r]), an RLE run
    repeating payload[r], a packed run reading from bit payload[r]."""
    src = _u8(data)
    cap = max(src.size, 1)
    starts, lengths, payload = (np.empty(cap, np.int64) for _ in range(3))
    packed = np.empty(cap, np.uint8)
    r = lib().io_rle_runs(_ptr(src), src.size, bit_width, count, _ptr(starts),
                          _ptr(lengths), _ptr(payload), _ptr(packed), cap)
    if r < 0:
        raise ValueError("RLE stream has more runs than bytes")
    return starts[:r], lengths[:r], packed[:r].astype(bool), payload[:r]


def rle_hybrid_encode(values: np.ndarray, bit_width: int) -> bytes:
    v = np.ascontiguousarray(values, dtype=np.int32)
    out = np.empty(5 * v.size + 64, np.uint8)
    n = lib().io_rle_hybrid_encode(_ptr(v), v.size, bit_width, _ptr(out))
    return out[:n].tobytes()


# ----------------------------------------------------------------------
# BYTE_ARRAY, DELTA_BINARY_PACKED
# ----------------------------------------------------------------------

def byte_array_walk(data, count: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """(starts, lengths, consumed) of ``count`` PLAIN BYTE_ARRAY values."""
    src = _u8(data)
    starts = np.empty(count, np.int64)
    lens = np.empty(count, np.int64)
    used = lib().io_byte_array_walk(_ptr(src), src.size, count, _ptr(starts), _ptr(lens))
    if used < 0:
        raise ValueError("BYTE_ARRAY value overruns its page")
    return starts, lens, used


def delta_binary_decode(data, count: int = -1) -> Tuple[np.ndarray, int]:
    """(int64 values, consumed bytes) of a DELTA_BINARY_PACKED stream."""
    src = _u8(data)
    total = int(_uvarints(src, 3)[2])
    n = total if count < 0 else min(count, total)
    out = np.empty(max(n, 1), np.int64)
    consumed = ctypes.c_int64(0)
    got = lib().io_delta_binary_decode(_ptr(src), src.size, n, _ptr(out),
                                       ctypes.byref(consumed))
    if got < 0:
        raise ValueError("truncated DELTA_BINARY_PACKED stream")
    return out[:got], consumed.value


def delta_binary_encode(values: np.ndarray) -> bytes:
    v = np.ascontiguousarray(values, dtype=np.int64)
    out = np.empty(64 + ((v.size + 127) // 128 + 1) * 1040, np.uint8)
    n = lib().io_delta_binary_encode(_ptr(v), v.size, _ptr(out))
    return out[:n].tobytes()


def _uvarints(buf: np.ndarray, k: int):
    vals, pos = [], 0
    for _ in range(k):
        v = s = 0
        while True:
            b = int(buf[pos])
            pos += 1
            v |= (b & 0x7F) << s
            if not b & 0x80:
                break
            s += 7
        vals.append(v)
    return vals


# ----------------------------------------------------------------------
# bloom filters
# ----------------------------------------------------------------------

def xxhash64_fixed(values: np.ndarray) -> np.ndarray:
    """XXH64 of each fixed-width value's little-endian bytes."""
    v = np.ascontiguousarray(values)
    out = np.empty(v.size, np.uint64)
    lib().io_xxhash64_fixed(_ptr(v), v.size, v.dtype.itemsize, _ptr(out))
    return out


def xxhash64_strings(chars: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    c = np.ascontiguousarray(chars, dtype=np.uint8)
    o = np.ascontiguousarray(offsets, dtype=np.int64)
    out = np.empty(o.size - 1, np.uint64)
    lib().io_xxhash64_var(_ptr(c), _ptr(o), o.size - 1, _ptr(out))
    return out


def sbbf_insert(bitset: np.ndarray, hashes: np.ndarray) -> None:
    h = np.ascontiguousarray(hashes, dtype=np.uint64)
    lib().io_sbbf_insert(_ptr(bitset), bitset.size, _ptr(h), h.size)


# ----------------------------------------------------------------------
# text, Avro, ORC
# ----------------------------------------------------------------------

def multibyte_split(data, delimiter: bytes = b"\n") -> np.ndarray:
    """int64 record start offsets of ``data`` split at ``delimiter``: 0,
    the position after each delimiter, and len(data) when the last record
    has none (cudf::io::text::multibyte_split's offsets)."""
    src = _u8(data)
    d = np.frombuffer(bytes(delimiter), np.uint8)
    n = lib().io_multibyte_split(_ptr(src), src.size, _ptr(d), d.size, None)
    out = np.empty(n, np.int64)
    lib().io_multibyte_split(_ptr(src), src.size, _ptr(d), d.size, _ptr(out))
    return out


AVRO_STRING_KINDS = (5, 6, 9)
AVRO_VALUE_DTYPES = {0: np.uint8, 1: np.int32, 2: np.int64, 3: np.float32, 4: np.float64,
                     7: np.int32, 8: np.uint8}


def avro_decode_block(data, count: int, desc, into=None):
    """One decompressed Avro block of ``count`` records; ``desc`` the
    (kind, null_branch, extra) of each field.  A field gives (values,
    valid) or, for bytes, string and fixed, (offsets, chars, valid).
    ``into``: a field's (values or offsets, chars or None, valid)
    contiguous arrays to decode into (chars of at least the block's
    size), instead of new ones."""
    src = _u8(data)
    d = np.ascontiguousarray(np.asarray(desc, np.int32).reshape(-1, 3))
    outs, keep = [], []
    for f, (kind, _, _) in enumerate(d):
        if into is not None:
            bufs = into[f]
        elif kind in AVRO_STRING_KINDS:
            bufs = (np.empty(count + 1, np.int64), np.empty(src.size, np.uint8),
                    np.empty(count, np.uint8))
        else:
            bufs = (np.empty(0 if kind == 8 else count, AVRO_VALUE_DTYPES[int(kind)]), None,
                    np.empty(count, np.uint8))
        keep.append(bufs)
        outs += [None if b is None else b.ctypes.data for b in bufs]
    ptrs = (ctypes.c_void_p * len(outs))(*outs)
    if lib().io_avro_decode_block(_ptr(src), src.size, count, _ptr(d), d.shape[0], ptrs) < 0:
        raise ValueError("avro: malformed block data")
    res = []
    for (kind, _, _), (vals, chars, valid) in zip(d, keep):
        res.append((vals, chars[:vals[-1]], valid) if kind in AVRO_STRING_KINDS
                   else (vals, valid))
    return res


def _check_walk(r: int, what: str) -> int:
    if r == -2:
        raise ValueError(f"ORC {what} stream ends before its values")
    if r < 0:
        raise ValueError(f"ORC {what} stream overruns its bytes")
    return r


def orc_byte_rle_runs(data, count: int = -1):
    """(start, length, literal, payload) of the runs of an ORC byte RLE
    stream of ``count`` bytes (-1: the whole stream): a literal run copies
    from input byte payload, a repeat run repeats the byte payload."""
    src = _u8(data)
    cap = src.size // 2 + 1 if count < 0 else max(min(src.size, count), 1)
    start, length, payload = (np.empty(cap, np.int64) for _ in range(3))
    literal = np.empty(cap, np.uint8)
    r = _check_walk(lib().io_orc_byte_rle_runs(_ptr(src), src.size, count, _ptr(start),
                                               _ptr(length), _ptr(literal), _ptr(payload),
                                               cap), "byte RLE")
    return start[:r], length[:r], literal[:r].astype(bool), payload[:r]


def orc_rle2_runs(data, count: int, signed: bool):
    """(runs int64[R, 7], patch positions, patch bits) of an ORC RLEv2
    stream of ``count`` values (-1: the whole stream); a run's row is
    (start, n, kind, width, bitpos, base, delta0) with kind 0
    SHORT_REPEAT, 1 DIRECT, 2 DELTA, 3 PATCHED_BASE (``io_host.cpp``)."""
    src = _u8(data)
    cap = src.size // 2 + 1 if count < 0 else max(min(count, src.size // 2 + 1), 1)
    runs = np.empty((cap, 7), np.int64)
    pcap = 4 * src.size + 1 if count < 0 else max(min(count, 4 * src.size), 1)
    ppos, pval = np.empty(pcap, np.int64), np.empty(pcap, np.int64)
    npatch = ctypes.c_int64(0)
    r = _check_walk(lib().io_orc_rle2_runs(_ptr(src), src.size, count, int(signed), _ptr(runs),
                                           cap, _ptr(ppos), _ptr(pval), pcap,
                                           ctypes.byref(npatch)), "RLEv2")
    return runs[:r], ppos[:npatch.value], pval[:npatch.value]


def orc_rle1_decode(data, count: int, signed: bool) -> np.ndarray:
    """``count`` values of an ORC RLEv1 stream (-1: all of them)."""
    src = _u8(data)
    if count < 0:
        count = _check_walk(lib().io_orc_rle1_decode(_ptr(src), src.size, -1, int(signed), None),
                            "RLEv1")
    out = np.empty(count, np.int64)
    w = lib().io_orc_rle1_decode(_ptr(src), src.size, count, int(signed), _ptr(out))
    _check_walk(-1 if w < 0 else (-2 if w < count else w), "RLEv1")
    return out


def _encoder(fn, values, signed: bool) -> bytes:
    v = np.ascontiguousarray(values, dtype=np.int64)
    out = np.empty(11 * v.size + 64, np.uint8)
    n = fn(_ptr(v), v.size, int(signed), _ptr(out))
    return out[:n].tobytes()


def orc_rle2_encode(values, signed: bool) -> bytes:
    return _encoder(lib().io_orc_rle2_encode, values, signed)


def orc_rle1_encode(values, signed: bool) -> bytes:
    return _encoder(lib().io_orc_rle1_encode, values, signed)


def orc_byte_rle_encode(values) -> bytes:
    v = np.ascontiguousarray(values, dtype=np.uint8)
    out = np.empty(v.size + v.size // 128 + 16, np.uint8)
    n = lib().io_orc_byte_rle_encode(_ptr(v), v.size, _ptr(out))
    return out[:n].tobytes()


# ----------------------------------------------------------------------
# plain versions (the reference loader's numpy code), for the tests
# ----------------------------------------------------------------------

def bitunpack32_plain(data: bytes, bit_width: int, count: int) -> np.ndarray:
    out = np.zeros(count, np.int32)
    acc = nbits = pos = 0
    mask = (1 << bit_width) - 1 if bit_width < 32 else 0xFFFFFFFF
    for i in range(count):
        while nbits < bit_width:
            acc |= (data[pos] if pos < len(data) else 0) << nbits
            nbits += 8
            pos += 1
        out[i] = np.int64(acc & mask).astype(np.int32) if bit_width == 32 else acc & mask
        acc >>= bit_width
        nbits -= bit_width
    return out


def rle_decode32_plain(data: bytes, bit_width: int, count: int) -> np.ndarray:
    out = []
    pos = 0
    byte_width = (bit_width + 7) // 8
    while len(out) < count and pos < len(data):
        header = shift = 0
        while pos < len(data):
            b = data[pos]
            pos += 1
            header |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        if header & 1:
            nvals = (header >> 1) * 8
            nbytes = (nvals * bit_width + 7) // 8
            out.extend(bitunpack32_plain(data[pos:pos + nbytes], bit_width, nvals).tolist())
            pos += nbytes
        else:
            v = int.from_bytes(data[pos:pos + byte_width], "little") if byte_width else 0
            pos += byte_width
            out.extend([v] * (header >> 1))
    return np.asarray(out[:count] + [0] * max(0, count - len(out)), np.int32)


def snappy_compress_plain(data: bytes) -> bytes:
    """One literal element: a valid, incompressible snappy block."""
    out = bytearray()
    v = len(data)
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    if data:
        n = len(data) - 1
        if n < 60:
            out.append(n << 2)
        else:
            nb = (n.bit_length() + 7) // 8
            out.append((59 + nb) << 2)
            out += n.to_bytes(nb, "little")
        out += data
    return bytes(out)


def snappy_decompress_plain(data: bytes) -> bytes:
    pos = ulen = shift = 0
    while pos < len(data):
        b = data[pos]
        pos += 1
        ulen |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    out = bytearray()
    while pos < len(data) and len(out) < ulen:
        tag = data[pos]
        pos += 1
        t = tag & 3
        if t == 0:
            ln = (tag >> 2) + 1
            if ln > 60:
                nb = ln - 60
                ln = int.from_bytes(data[pos:pos + nb], "little") + 1
                pos += nb
            out += data[pos:pos + ln]
            pos += ln
            continue
        if t == 1:
            ln = ((tag >> 2) & 7) + 4
            off = ((tag >> 5) << 8) | data[pos]
            pos += 1
        elif t == 2:
            ln = (tag >> 2) + 1
            off = int.from_bytes(data[pos:pos + 2], "little")
            pos += 2
        else:
            ln = (tag >> 2) + 1
            off = int.from_bytes(data[pos:pos + 4], "little")
            pos += 4
        src = len(out) - off
        for i in range(ln):
            out.append(out[src + i])
    return bytes(out)


def multibyte_split_plain(data: bytes, delimiter: bytes = b"\n") -> np.ndarray:
    arr = np.frombuffer(data, dtype=np.uint8)
    if len(delimiter) == 1:
        hits = np.nonzero(arr == delimiter[0])[0] + 1
    else:
        hits, i = [], 0
        while True:
            i = data.find(delimiter, i)
            if i < 0:
                break
            i += len(delimiter)
            hits.append(i)
    offs = np.concatenate([[0], np.asarray(hits, np.int64)])
    if offs[-1] != len(arr):
        offs = np.concatenate([offs, [len(arr)]])
    return offs.astype(np.int64)


def avro_decode_block_plain(data: bytes, count: int, desc):
    """The reference's pure-Python ``_decode_block_py`` over (kind,
    null_branch, extra) triples, in ``avro_decode_block``'s layout."""
    import struct

    pos = 0

    def zigzag():
        nonlocal pos
        v = shift = 0
        while True:
            b = data[pos]
            pos += 1
            v |= (b & 0x7F) << shift
            if not b & 0x80:
                return (v >> 1) ^ -(v & 1)
            shift += 7

    def take(k):
        nonlocal pos
        out = data[pos:pos + k]
        if len(out) != k:
            raise ValueError("avro: malformed block data")
        pos += k
        return out

    outs = [([0], bytearray(), []) if k in AVRO_STRING_KINDS else ([], [])
            for k, _, _ in desc]
    for _ in range(count):
        for (kind, nb, extra), o in zip(desc, outs):
            isnull = kind == 8
            if nb >= 0 and zigzag() == nb:
                isnull = True
            o[-1].append(0 if isnull else 1)
            if kind in AVRO_STRING_KINDS:
                if not isnull:
                    o[1].extend(take(extra if kind == 9 else zigzag()))
                o[0].append(len(o[1]))
            elif kind == 8:
                pass
            elif isnull:
                o[0].append(0)
            elif kind == 0:
                o[0].append(take(1)[0])
            elif kind in (1, 2, 7):
                o[0].append(zigzag())
            else:
                o[0].append(struct.unpack("<f" if kind == 3 else "<d", take(4 if kind == 3 else 8))[0])
    res = []
    for (kind, _, _), o in zip(desc, outs):
        valid = np.asarray(o[-1], np.uint8)
        if kind in AVRO_STRING_KINDS:
            res.append((np.asarray(o[0], np.int64), np.frombuffer(bytes(o[1]), np.uint8), valid))
        else:
            res.append((np.asarray(o[0], AVRO_VALUE_DTYPES[kind]), valid))
    return res


def orc_byte_rle_decode_plain(data: bytes, count: int) -> np.ndarray:
    """The reference's ``decode_byte_rle``."""
    out = np.empty(count, np.uint8)
    pos = w = 0
    while w < count and pos < len(data):
        h = data[pos]
        pos += 1
        if h < 128:
            n = min(h + 3, count - w)
            out[w:w + n] = data[pos]
            pos += 1
        else:
            n = min(256 - h, count - w)
            out[w:w + n] = np.frombuffer(data, np.uint8, count=n, offset=pos)
            pos += 256 - h
        w += n
    return out


def orc_bool_rle_decode_plain(data: bytes, count: int) -> np.ndarray:
    """The reference's ``decode_bool_rle``: byte RLE of bytes packed most
    significant bit first."""
    packed = orc_byte_rle_decode_plain(data, (count + 7) // 8)
    return np.unpackbits(packed, bitorder="big")[:count].astype(bool)


def orc_rle1_decode_plain(data: bytes, count: int, signed: bool) -> np.ndarray:
    """The reference's ``decode_int_rle1``."""
    out = np.empty(count, np.int64)
    pos = w = 0

    def vulong():
        nonlocal pos
        v = s = 0
        while True:
            b = data[pos]
            pos += 1
            v |= (b & 0x7F) << s
            if not b & 0x80:
                return (v >> 1) ^ -(v & 1) if signed else v
            s += 7

    while w < count and pos < len(data):
        h = data[pos]
        pos += 1
        if h < 128:
            n = min(h + 3, count - w)
            step = data[pos] - 256 if data[pos] > 127 else data[pos]
            pos += 1
            v = vulong()
            out[w:w + n] = v + step * np.arange(n)
        else:
            n = min(256 - h, count - w)
            for i in range(n):
                out[w + i] = vulong()
        w += n
    return out[:w]


_W5 = list(range(1, 25)) + [26, 28, 30, 32, 40, 48, 56, 64]


def _be_bits_plain(data: bytes, bitpos: int, width: int, count: int) -> np.ndarray:
    acc = int.from_bytes(data, "big")
    total = len(data) * 8
    mask = (1 << width) - 1
    out = np.empty(count, np.uint64)
    for i in range(count):
        end = bitpos + (i + 1) * width
        out[i] = (acc >> (total - end)) & mask if end <= total else 0
    return out.view(np.int64)


def orc_rle2_decode_plain(data: bytes, count: int, signed: bool) -> np.ndarray:
    """The reference's ``decode_int_rle2`` (SHORT_REPEAT, DIRECT,
    PATCHED_BASE and DELTA runs, a value at a time), with the patch list
    at the closest fixed width, as ORC's readers and writers pad it."""
    out = np.empty(count, np.int64)
    pos = w = 0

    def vulong():
        nonlocal pos
        v = s = 0
        while True:
            b = data[pos]
            pos += 1
            v |= (b & 0x7F) << s
            if not b & 0x80:
                return v
            s += 7

    def unzz(u):
        return (u >> 1) ^ -(u & 1)

    while w < count and pos < len(data):
        b0 = data[pos]
        mode = b0 >> 6
        if mode == 0:
            width = ((b0 >> 3) & 7) + 1
            n = (b0 & 7) + 3
            v = int.from_bytes(data[pos + 1:pos + 1 + width], "big")
            pos += 1 + width
            vals = np.full(n, unzz(v) if signed else v, np.int64)
        else:
            n = (((b0 & 1) << 8) | data[pos + 1]) + 1
            code = (b0 >> 1) & 0x1F
            if mode == 1:
                width = _W5[code]
                pos += 2
                u = _be_bits_plain(data, pos * 8, width, n).view(np.uint64)
                pos += (n * width + 7) // 8
                vals = ((u >> np.uint64(1)) ^ (np.uint64(0) - (u & np.uint64(1)))).view(
                    np.int64) if signed else u.view(np.int64)
            elif mode == 3:
                width = 0 if code == 0 else _W5[code]
                pos += 2
                base = unzz(vulong()) if signed else vulong()
                delta0 = unzz(vulong())
                vals = [base, base + delta0][:n]
                if n > 2:
                    if width:
                        deltas = [int(d) for d in _be_bits_plain(data, pos * 8, width, n - 2)
                                  .view(np.uint64)]
                        pos += ((n - 2) * width + 7) // 8
                    else:
                        deltas = [abs(delta0)] * (n - 2)
                    sign = 1 if delta0 >= 0 else -1
                    for d in deltas:
                        vals.append(vals[-1] + sign * d)
                vals = np.asarray([(v + 2 ** 63) % 2 ** 64 - 2 ** 63 for v in vals], np.int64)
            else:
                width = _W5[code]
                b2, b3 = data[pos + 2], data[pos + 3]
                bw = ((b2 >> 5) & 7) + 1
                pw = _W5[b2 & 0x1F]
                gapbits = ((b3 >> 5) & 7) + 1
                pll = b3 & 0x1F
                pos += 4
                base = int.from_bytes(data[pos:pos + bw], "big")
                if base & (1 << (bw * 8 - 1)):
                    base = -(base & ((1 << (bw * 8 - 1)) - 1))
                pos += bw
                vals = [int(x) for x in _be_bits_plain(data, pos * 8, width, n).view(np.uint64)]
                pos += (n * width + 7) // 8
                eb = next(x for x in _W5 if x >= gapbits + pw)
                idx = 0
                for e in _be_bits_plain(data, pos * 8, eb, pll).view(np.uint64):
                    idx += int(e) >> pw
                    if idx < n:
                        vals[idx] |= (int(e) & ((1 << pw) - 1)) << width
                pos += (pll * eb + 7) // 8
                vals = np.asarray([(base + v + 2 ** 63) % 2 ** 64 - 2 ** 63 for v in vals],
                                  np.int64)
        m = min(n, count - w)
        out[w:w + m] = vals[:m]
        w += m
    return out[:w]


def _vulong_plain(out: bytearray, v: int):
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def _vslong_plain(out: bytearray, v: int):
    _vulong_plain(out, (v << 1) ^ (v >> 63) if v < 0 else (v << 1))


def _greedy_runs_plain(vals, emit_run, emit_literal) -> bytes:
    out = bytearray()
    lit = []

    def flush():
        for j in range(0, len(lit), 128):
            grp = lit[j:j + 128]
            out.append(256 - len(grp))
            for v in grp:
                emit_literal(out, v)
        lit.clear()

    n, i = len(vals), 0
    while i < n:
        j = i + 1
        while j < n and j - i < 130 and vals[j] == vals[i]:
            j += 1
        if j - i >= 3:
            flush()
            emit_run(out, j - i, int(vals[i]))
        else:
            lit.extend(int(x) for x in vals[i:j])
            if len(lit) >= 128:
                flush()
        i = j
    flush()
    return bytes(out)


def orc_byte_rle_encode_plain(vals) -> bytes:
    """The reference's ``byte_rle_encode``."""
    def run(out, k, v):
        out += bytes([k - 3, v])
    return _greedy_runs_plain(np.asarray(vals, np.uint8), run, lambda out, v: out.append(v))


def orc_rle1_encode_plain(vals, signed: bool) -> bytes:
    """The reference's ``rle1_encode_ints``."""
    put = _vslong_plain if signed else _vulong_plain

    def run(out, k, v):
        out += bytes([k - 3, 0])
        put(out, v)
    return _greedy_runs_plain(np.asarray(vals, np.int64), run, put)


def orc_rle2_encode_plain(vals, signed: bool) -> bytes:
    """The reference's ``rle2_encode_ints``."""
    vals = np.ascontiguousarray(vals, np.int64)
    n = len(vals)
    out = bytearray()
    if n == 0:
        return b""
    v64 = vals.astype(np.int64)
    uz = ((v64.view(np.uint64) << np.uint64(1)) ^ (v64 >> np.int64(63)).view(np.uint64)) \
        if signed else vals.view(np.uint64)

    def pack(chunk, width):
        shifts = np.arange(width - 1, -1, -1, dtype=np.uint64)
        bits = ((chunk[:, None] >> shifts[None, :]) & np.uint64(1)).astype(np.uint8)
        return np.packbits(bits.ravel()).tobytes()

    def emit_direct(lo, hi):
        while lo < hi:
            m = min(512, hi - lo)
            if hi - lo - m == 1:
                m -= 1
            chunk = uz[lo:lo + m]
            bits = max(int(chunk.max()).bit_length(), 1)
            width = next(w for w in _W5 if w >= bits)
            hdr = (1 << 14) | (_W5.index(width) << 9) | (m - 1)
            out.extend([hdr >> 8, hdr & 0xFF])
            out.extend(pack(chunk, width))
            lo += m

    def emit_run(lo, hi):
        d = int(vals[lo + 1]) - int(vals[lo])
        if d == 0 and 3 <= hi - lo <= 10:
            u = int(uz[lo])
            nb = max((u.bit_length() + 7) // 8, 1)
            out.append(((nb - 1) << 3) | (hi - lo - 3))
            out.extend(u.to_bytes(nb, "big"))
            return
        while lo < hi:
            m = min(512, hi - lo)
            if hi - lo - m == 1:
                m -= 1
            if m < 2:
                emit_direct(lo, hi)
                return
            hdr = (3 << 14) | (m - 1)
            out.extend([hdr >> 8, hdr & 0xFF])
            (_vslong_plain if signed else _vulong_plain)(out, int(vals[lo]))
            _vslong_plain(out, d)
            lo += m

    if n == 1:
        emit_direct(0, 1)
        return bytes(out)
    diffs = np.diff(vals)
    change = np.flatnonzero(diffs[1:] != diffs[:-1]) + 1
    seg_start = np.concatenate([[0], change])
    seg_end = np.concatenate([change, [n - 1]])
    nvals = seg_end - seg_start + 1
    cursor = 0
    for s, e in zip(seg_start[nvals >= 6], seg_end[nvals >= 6]):
        rs = max(int(s), cursor)
        if int(e) + 1 - rs < 6:
            continue
        if rs > cursor:
            emit_direct(cursor, rs)
        emit_run(rs, int(e) + 1)
        cursor = int(e) + 1
    if cursor < n:
        emit_direct(cursor, n)
    return bytes(out)
