"""The host library of the readers and writers (port of
``cudf_tpu/native.py`` for the routines Parquet needs).

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
}

_lib = None
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
