"""Parquet page decode on the frame's device (port of
``cudf_tpu/io/parquet_device.py``).

The split is the reference's: the host walks only the HEADERS of a
stream (a varint and a kind a run, a min delta and widths a miniblock:
O(runs)), in ``io_host.cpp`` where the walk is a pointer chase; the
device expands every value at once.  One ``searchsorted`` maps output
positions to their runs; an RLE position takes its run's value, a
bit-packed one shifts its bits out of the page's bytes, which are
already on the device.  The page bytes are the only host-to-device
copy; indices and deltas never exist on the host.

Functions take the page bytes as a uint8 tensor on the device plus the
byte position of the stream in it (``base``), and the same bytes on the
host for the header walk.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from cudf_tpu_torch.io import _native

__all__ = ["device_bitunpack", "device_rle_decode", "expand",
           "device_delta_binary_decode", "device_delta_length_byte_array",
           "device_dict_string_gather"]


def _window(buf: torch.Tensor, byte0: torch.Tensor, nbytes: int) -> torch.Tensor:
    """int64 little-endian words of ``nbytes`` (<= 8) bytes from each
    position (bytes past the buffer read as 0): one gather of an
    [n, nbytes] block from the buffer padded with zeros."""
    nb = buf.shape[0]
    padded = torch.cat([buf, buf.new_zeros(8)])
    k = torch.arange(nbytes, device=buf.device)
    block = padded[(byte0.clamp(max=nb).unsqueeze(1) + k)].long()
    return (block << (8 * k)).sum(1)


def _unpack_at(buf: torch.Tensor, bitpos: torch.Tensor, bit_width: int) -> torch.Tensor:
    """int64 values of ``bit_width`` <= 32 bits at each bit position."""
    if bit_width == 0:
        return torch.zeros_like(bitpos)
    word = _window(buf, bitpos >> 3, 5)
    return (word >> (bitpos & 7)) & ((1 << bit_width) - 1)


def device_bitunpack(buf: torch.Tensor, bit_width: int, count: int,
                     bit_offset: int = 0) -> torch.Tensor:
    """int32[count]: little-endian ``bit_width``-bit ints (<= 32) from a
    uint8 tensor, starting ``bit_offset`` bits in (Parquet's packing)."""
    if bit_width > 32:
        raise ValueError("device_bitunpack supports bit_width <= 32")
    pos = bit_offset + torch.arange(count, dtype=torch.int64, device=buf.device) * bit_width
    return _unpack_at(buf, pos, bit_width).to(torch.int32)


def expand(buf: torch.Tensor, runs: torch.Tensor, bit_width: int, count: int) -> torch.Tensor:
    """int32[count] values of run descriptors on the device ([3, runs]:
    first value, RLE value or bit offset into ``buf``, packed): one
    searchsorted, masked gathers."""
    dev = buf.device
    if count == 0:
        return torch.zeros(0, dtype=torch.int32, device=dev)
    if runs.shape[1] == 0:
        return torch.zeros(count, dtype=torch.int32, device=dev)
    st, pay, is_p = runs[0], runs[1], runs[2].bool()
    pos = torch.arange(count, dtype=torch.int64, device=dev)
    run = torch.searchsorted(st, pos, right=True) - 1
    within = pos - st[run]
    p = pay[run]
    packed_lane = is_p[run]
    bitpos = torch.where(packed_lane, p + within * bit_width, 0)
    unpacked = _unpack_at(buf, bitpos, bit_width)
    return torch.where(packed_lane, unpacked, p).to(torch.int32)


def device_rle_decode(data, bit_width: int, count: int, device="cpu",
                      buf: torch.Tensor = None, base: int = 0) -> torch.Tensor:
    """int32[count] values of a hybrid stream.  ``data`` is the stream on
    the host; ``buf`` (default: a copy of it on ``device``) holds it on the
    device at byte ``base``."""
    starts, _, packed, payload = _native.rle_runs(data, bit_width, count)
    if buf is None:
        buf = torch.from_numpy(np.frombuffer(memoryview(data), np.uint8).copy()).to(device)
    payload = np.where(packed, payload + 8 * base, payload)
    runs = torch.from_numpy(np.stack([starts, payload, packed.astype(np.int64)]))
    return expand(buf, runs.to(buf.device), bit_width, count)


# ----------------------------------------------------------------------
# DELTA encodings: the host walks block headers, the device unpacks every
# delta at once and a cumsum rebuilds the values
# ----------------------------------------------------------------------

def _read_uvarint(data, i: int):
    v = s = 0
    while True:
        b = int(data[i])
        i += 1
        v |= (b & 0x7F) << s
        if not b & 0x80:
            return v, i
        s += 7


def _read_zigzag(data, i: int):
    u, i = _read_uvarint(data, i)
    return (u >> 1) ^ -(u & 1), i


def parse_delta_header(data):
    """(block_size, miniblocks_per_block, total_count, first_value, pos)."""
    bs, i = _read_uvarint(data, 0)
    mb, i = _read_uvarint(data, i)
    total, i = _read_uvarint(data, i)
    first, i = _read_zigzag(data, i)
    return bs, mb, total, first, i


def parse_delta_miniblocks(data):
    """Host block walk: (starts, widths, bit_offsets, min_deltas,
    first_value, total_count, consumed) of every miniblock."""
    bs, mbs, total, first, i = parse_delta_header(data)
    vpm = bs // mbs
    ndeltas = max(total - 1, 0)
    starts, widths, bitoffs, mins = [], [], [], []
    done = 0
    while done < ndeltas:
        min_delta, i = _read_zigzag(data, i)
        bws = data[i:i + mbs]
        i += mbs
        for m in range(mbs):
            if done >= ndeltas:
                break
            w = int(bws[m])
            starts.append(done)
            widths.append(w)
            bitoffs.append(i * 8)
            mins.append(min_delta)
            i += (vpm * w + 7) // 8          # a miniblock is always vpm values wide
            done += min(vpm, ndeltas - done)
    return (np.asarray(starts, np.int64), np.asarray(widths, np.int64),
            np.asarray(bitoffs, np.int64), np.asarray(mins, np.int64), first, total, i)


def _wrap64(v: int) -> int:
    return (v + (1 << 63)) % (1 << 64) - (1 << 63)


def device_delta_binary_decode(data, count: int = -1, device="cpu",
                               buf: torch.Tensor = None, base: int = 0):
    """(int64 values on the device, consumed bytes) of a
    DELTA_BINARY_PACKED stream.  Deltas wider than 32 bits decode in
    ``io_host.cpp`` instead (full-range int64 jumps are rare in files)."""
    starts, widths, bitoffs, mins, first, total, consumed = parse_delta_miniblocks(data)
    n = total if count < 0 else min(count, total)
    if len(widths) and int(widths.max()) > 32:
        vals, consumed = _native.delta_binary_decode(data, n)
        return torch.from_numpy(vals).to(device if buf is None else buf.device), consumed
    if buf is None:
        buf = torch.from_numpy(np.frombuffer(memoryview(data), np.uint8).copy()).to(device)
    dev = buf.device
    if n <= 0:
        return torch.zeros(0, dtype=torch.int64, device=dev), consumed
    if n == 1:
        return torch.full((1,), _wrap64(first), dtype=torch.int64, device=dev), consumed
    meta = torch.from_numpy(np.stack([starts, widths, bitoffs + 8 * base, mins])).to(dev)
    pos = torch.arange(n - 1, dtype=torch.int64, device=dev)
    mb = torch.searchsorted(meta[0], pos, right=True) - 1
    w = meta[1][mb]
    bitpos = meta[2][mb] + (pos - meta[0][mb]) * w
    word = _window(buf, bitpos >> 3, 5)
    delta = (word >> (bitpos & 7)) & ((torch.ones_like(w) << w) - 1)
    delta = delta + meta[3][mb]
    out = torch.empty(n, dtype=torch.int64, device=dev)
    out[0] = _wrap64(first)
    out[1:] = delta
    return torch.cumsum(out, 0), consumed


def device_delta_length_byte_array(data, count: int, device="cpu",
                                   buf: torch.Tensor = None, base: int = 0):
    """(offsets int64[count + 1], chars uint8) of a DELTA_LENGTH_BYTE_ARRAY
    stream: the lengths delta-packed, then the chars."""
    if buf is None:
        buf = torch.from_numpy(np.frombuffer(memoryview(data), np.uint8).copy()).to(device)
        base = 0
    lengths, consumed = device_delta_binary_decode(data, count, buf=buf, base=base)
    offsets = torch.zeros(lengths.shape[0] + 1, dtype=torch.int64, device=buf.device)
    torch.cumsum(lengths, 0, out=offsets[1:])
    total = int(offsets[-1])
    return offsets, buf[base + consumed:base + consumed + total]


def device_dict_string_gather(indices: torch.Tensor, dict_offsets: torch.Tensor,
                              dict_chars: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dictionary-encoded strings expanded on the device: (offsets,
    chars), each row's bytes gathered from its dictionary entry."""
    from cudf_tpu_torch.ops.strings import gather_ranges, new_offsets

    idx = indices.long()
    offsets = new_offsets((dict_offsets[1:] - dict_offsets[:-1])[idx])
    return offsets, gather_ranges(dict_chars, dict_offsets[:-1][idx], offsets)
