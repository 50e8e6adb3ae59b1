"""The port's host IO library (``cudf_tpu_torch/io/_native.py`` over
``csrc/host/io_host.cpp``) and its device page decode
(``io/parquet_device.py``) against the reference's (``cudf_tpu/native.py``,
``cudf_tpu/io/parquet_device.py``, ``parquet_writer.py``'s encoders,
``parquet_pushdown.py``'s hashes) and against the numpy plain versions
the port keeps for its tests.  Inputs from seeded numpy; every result
exact (bits, bytes, values).
"""

import struct

import numpy as np
import pytest
import torch

from cudf_tpu import native as ref_native
from cudf_tpu.io import parquet_device as ref_dev
from cudf_tpu.io import parquet_pushdown as ref_ppd
from cudf_tpu.io import parquet_writer as ref_writer
from cudf_tpu_torch.io import _native
from cudf_tpu_torch.io import parquet_device as pdev

RNG = np.random.default_rng(18)


def _hybrid(bw, n=3000):
    vals = RNG.integers(0, 2 ** min(bw, 31), n).astype(np.int32)
    vals[200:700] = vals[200]                 # an RLE run
    vals[1000:1003] = 1                       # a short run inside literals
    return vals


@pytest.mark.parametrize("n", [0, 7, 100, 70_000, 300_001])
def test_snappy_compress_is_the_reference_bytes_and_round_trips(n):
    data = RNG.integers(0, 5, n).astype(np.uint8).tobytes()
    comp = _native.snappy_compress(data)
    assert comp == ref_native.snappy_compress(data)
    assert _native.snappy_decompress(comp).tobytes() == data
    assert _native.snappy_decompress_plain(comp) == data
    assert _native.snappy_decompress(_native.snappy_compress_plain(data)).tobytes() == data


def test_snappy_rejects_a_bad_block():
    with pytest.raises(ValueError):
        _native.snappy_decompress(b"\x0a\x09\x05\x00")        # copy before any output


@pytest.mark.parametrize("bw", [1, 2, 5, 8, 13, 20, 31, 32])
def test_hybrid_encode_decode_against_the_reference(bw):
    vals = _hybrid(bw)
    enc = _native.rle_hybrid_encode(vals, bw)
    assert enc == ref_writer._rle_hybrid_encode(vals, bw)
    np.testing.assert_array_equal(_native.rle_decode32(enc, bw, vals.size), vals)
    np.testing.assert_array_equal(_native.rle_decode32_plain(enc, bw, vals.size), vals)
    np.testing.assert_array_equal(ref_native.rle_decode32(enc, bw, vals.size), vals)
    got = _native.rle_runs(enc, bw, vals.size)
    exp = ref_dev.parse_rle_runs(enc, bw, vals.size)
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(g, e)


@pytest.mark.parametrize("bw", [1, 7, 17, 32])
def test_bitunpack_against_the_reference(bw):
    data = RNG.integers(0, 256, 1000).astype(np.uint8).tobytes()
    count = 1000 * 8 // bw
    np.testing.assert_array_equal(_native.bitunpack32(data, bw, count),
                                  ref_native.bitunpack32(data, bw, count))
    np.testing.assert_array_equal(_native.bitunpack32(data, bw, count),
                                  _native.bitunpack32_plain(data, bw, count))
    if bw <= 24:
        buf = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
        inside = (8 * len(data) - 3) // bw         # values wholly inside the buffer
        np.testing.assert_array_equal(pdev.device_bitunpack(buf, bw, inside, 3).numpy(),
                                      np.asarray(ref_dev.device_bitunpack(
                                          np.frombuffer(data, np.uint8), bw, inside, 3)))


@pytest.mark.parametrize("bw", [1, 4, 12, 24, 32])
def test_device_rle_decode_against_the_reference(bw):
    vals = _hybrid(bw, 5000)
    enc = _native.rle_hybrid_encode(vals, bw)
    got = pdev.device_rle_decode(enc, bw, vals.size)
    np.testing.assert_array_equal(got.numpy(), vals)
    if bw <= 24:
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(ref_dev.device_rle_decode(enc, bw, vals.size)))
    # a stream at an offset inside a larger buffer, as the reader stages it
    buf = torch.cat([torch.full((13,), 7, dtype=torch.uint8),
                     torch.from_numpy(np.frombuffer(enc, np.uint8).copy())])
    np.testing.assert_array_equal(
        pdev.device_rle_decode(enc, bw, vals.size, buf=buf, base=13).numpy(), vals)


_DELTAS = {
    "empty": np.zeros(0, np.int64), "one": np.array([-5]), "small": RNG.integers(-9, 9, 777),
    "wide": RNG.integers(-2 ** 62, 2 ** 62, 300),
    "extremes": np.array([-2 ** 63, 2 ** 63 - 1, 0, 7, -1]),
    "sorted": np.cumsum(RNG.integers(0, 1000, 5000)),
}


@pytest.mark.parametrize("name", list(_DELTAS))
def test_delta_binary_against_the_reference(name):
    vals = np.asarray(_DELTAS[name], np.int64)
    enc = _native.delta_binary_encode(vals)
    assert enc == ref_writer._delta_binary_encode(vals)
    if vals.size:
        dec, used = _native.delta_binary_decode(enc)
        np.testing.assert_array_equal(dec, vals)
        assert used == len(enc)
        got, used2 = pdev.device_delta_binary_decode(enc, vals.size)
        np.testing.assert_array_equal(got.numpy(), vals)
        ref_vals, ref_used = ref_dev.device_delta_binary_decode(enc, vals.size)
        np.testing.assert_array_equal(np.asarray(ref_vals), vals)
        assert used2 == ref_used


def test_delta_length_byte_array_against_the_reference():
    words = [b"", b"a", b"hello", b"x" * 300, b"tail"]
    lens = np.array([len(w) for w in words], np.int64)
    enc = _native.delta_binary_encode(lens) + b"".join(words)
    offs, chars = pdev.device_delta_length_byte_array(enc, len(words))
    ref_offs, ref_chars = ref_dev.device_delta_length_byte_array(enc, len(words))
    np.testing.assert_array_equal(offs.numpy(), np.asarray(ref_offs))
    assert chars.numpy().tobytes() == b"".join(words) == np.asarray(ref_chars).tobytes()


def test_dictionary_string_gather_against_the_reference():
    dict_offs = np.array([0, 0, 3, 4, 10], np.int64)
    dict_chars = np.frombuffer(b"abcdefghij", np.uint8)
    idx = RNG.integers(0, 4, 500).astype(np.int32)
    offs, chars = pdev.device_dict_string_gather(torch.from_numpy(idx),
                                                 torch.from_numpy(dict_offs),
                                                 torch.from_numpy(dict_chars.copy()))
    ref_offs, ref_chars = ref_dev.device_dict_string_gather(idx, dict_offs, dict_chars)
    np.testing.assert_array_equal(offs.numpy(), np.asarray(ref_offs))
    np.testing.assert_array_equal(chars.numpy(), np.asarray(ref_chars))


def test_byte_array_walk_reads_lengths_and_overruns():
    words = [b"", b"abc", b"z" * 70_000]
    page = b"".join(struct.pack("<I", len(w)) + w for w in words)
    starts, lens, used = _native.byte_array_walk(page, 3)
    assert list(lens) == [0, 3, 70_000] and used == len(page)
    assert [page[s:s + n] for s, n in zip(starts, lens)] == words
    with pytest.raises(ValueError):
        _native.byte_array_walk(page[:-1], 3)


def test_xxhash_and_bloom_bits_against_the_reference():
    ints = RNG.integers(-10 ** 9, 10 ** 9, 200)
    hashes = _native.xxhash64_fixed(ints.astype(np.int64))
    assert [int(h) for h in hashes] == [ref_ppd.xxhash64(struct.pack("<q", int(v)))
                                        for v in ints]
    words = [b"", b"a", b"abcdefgh" * 5, b"y" * 33]
    offs = np.cumsum([0] + [len(w) for w in words])
    got = _native.xxhash64_strings(np.frombuffer(b"".join(words), np.uint8), offs)
    assert [int(h) for h in got] == [ref_ppd.xxhash64(w) for w in words]
    bits = np.zeros(1024, np.uint8)
    _native.sbbf_insert(bits, hashes)
    ref_bits = bytearray(1024)
    ref_ppd.sbbf_insert_hashes(ref_bits, [int(h) for h in hashes])
    assert bits.tobytes() == bytes(ref_bits)
    assert all(ref_ppd.sbbf_block_check(bits.tobytes(), int(h)) for h in hashes)
