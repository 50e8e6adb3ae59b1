"""The port's Avro reader (``io/avro.py``: blocks decoded in
``io_host.cpp``'s ``avro_decode_block``, a value at a time, on host
threads; one copy a column to the device) against the reference's
``read_avro`` and its pure-Python block decoder.

Containers come from a spec encoder (``tests/test_avro.py``'s, Avro
1.11) for each codec (null, deflate, snappy) and block size, and from
``models/io_formats.py``'s numpy G1 encoder.  Values are compared as
the reference gives them (equal lists, nulls as nulls, floats exact).
"""

import json

import numpy as np
import pytest
import torch

from cudf_tpu.io import avro as ref_avro
from test_avro import ROWS, SCHEMA, make_avro

import cudf_tpu_torch as ct
from cudf_tpu_torch.io import IO_ROUTES, _native
from cudf_tpu_torch.io import avro as pa_avro
from cudf_tpu_torch.models import io_formats, io_paths

CPU = torch.device("cpu")


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        r = dict(ROWS[i % len(ROWS)])
        r["l"] = None if i % 5 == 0 else int(rng.integers(-2 ** 62, 2 ** 62))
        r["d"] = None if i % 7 == 0 else float(rng.normal())
        r["s"] = None if i % 11 == 0 else "x" * int(rng.integers(0, 40)) + str(i)
        out.append(r)
    return out


def _listed(pdf):
    return {c: pdf[c].astype(object).where(pdf[c].notna(), None).tolist() for c in pdf.columns}


@pytest.mark.parametrize("codec", ["null", "deflate", "snappy"])
@pytest.mark.parametrize("block_rows", [None, 7, 64])
def test_read_avro_equals_the_reference(codec, block_rows):
    data = make_avro(SCHEMA, _rows(300, 1), codec=codec, block_rows=block_rows)
    before = IO_ROUTES["native"]
    got = ct.read_avro(data, device=CPU)
    assert IO_ROUTES["native"] == before + 1
    assert _listed(got.to_pandas()) == _listed(ref_avro.read_avro(data).to_pandas())
    assert got._table["e"].dtype.is_dictionary


@pytest.mark.parametrize("kw", [dict(columns=["l", "s", "e"], skiprows=3, num_rows=9),
                                dict(skiprows=70), dict(num_rows=0), dict(skiprows=299),
                                dict(columns=["s"], num_rows=150)])
def test_columns_skiprows_and_num_rows_as_the_reference(kw):
    data = make_avro(SCHEMA, _rows(300, 2), codec="deflate", block_rows=64)
    got = ct.read_avro(data, device=CPU, **kw).to_pandas()
    exp = ref_avro.read_avro(data, **kw).to_pandas()
    assert list(got.columns) == list(exp.columns) and _listed(got) == _listed(exp)


def test_the_host_decoder_equals_its_plain_version_and_the_references():
    fields = ref_avro._parse_schema(json.dumps(SCHEMA))
    desc = [(f.kind, f.null_branch, f.extra) for f in fields]
    rows = _rows(500, 3)
    data = make_avro(SCHEMA, rows)
    r = ref_avro._Reader(data)
    ref_avro._read_header(r)
    count, size = r.zigzag(), r.zigzag()
    block = r.take(size)
    mine = _native.avro_decode_block(block, count, desc)
    plain = _native.avro_decode_block_plain(block, count, desc)
    theirs = ref_avro._decode_block_py(block, count, fields)
    for a, b, c in zip(mine, plain, theirs):
        for x, y, z in zip(a, b, c):
            assert x.dtype == y.dtype == z.dtype and np.array_equal(x, y) and np.array_equal(x, z)
    with pytest.raises(ValueError):
        _native.avro_decode_block(block[:-3], count, desc)


def test_fixed_bytes_and_logical_types():
    schema = {"type": "record", "name": "r", "fields": [
        {"name": "x", "type": {"type": "fixed", "name": "f4", "size": 4}},
        {"name": "y", "type": ["null", "bytes"]},
        {"name": "dte", "type": {"type": "int", "logicalType": "date"}},
        {"name": "ts", "type": {"type": "long", "logicalType": "timestamp-millis"}},
        {"name": "tu", "type": {"type": "long", "logicalType": "timestamp-micros"}},
        {"name": "n", "type": "null"}]}
    rows = [{"x": b"abcd", "y": b"zz", "dte": 19000, "ts": 1_600_000_000_123,
             "tu": 1_600_000_000_123_456, "n": None},
            {"x": b"wxyz", "y": None, "dte": -3, "ts": -5, "tu": 7, "n": None}]
    data = make_avro(schema, rows, codec="snappy")
    got = ct.read_avro(data, device=CPU).to_pandas()
    exp = ref_avro.read_avro(data).to_pandas()
    assert _listed(got) == _listed(exp)


@pytest.mark.parametrize("t", [{"type": "array", "items": "int"},
                               {"type": "map", "values": "int"},
                               {"type": "record", "name": "in", "fields": []},
                               ["null", "int", "string"], "no_such_type"])
def test_unsupported_schemas_raise_as_the_reference(t):
    schema = json.dumps({"type": "record", "name": "r", "fields": [{"name": "a", "type": t}]})
    with pytest.raises(NotImplementedError):
        ref_avro._parse_schema(schema)
    with pytest.raises(NotImplementedError):
        pa_avro.parse_schema(schema)


@pytest.mark.parametrize("codec", ["null", "deflate"])
def test_the_g1_container_reads_back_in_both_packages(codec):
    g = io_paths.g1_frame(3000, seed=5, device=CPU)
    data = io_formats.g1_avro(g, codec, block_rows=1000)
    got = ct.read_avro(data, device=CPU)
    assert io_formats.g1_equal(got, g, "G1 from Avro", ulps=0) == 0.0
    exp = ref_avro.read_avro(data).to_pandas()
    assert _listed(got.to_pandas()) == _listed(exp)


def test_zigzag_varints_are_avros():
    v = np.array([0, -1, 1, -64, 64, 2 ** 31, -2 ** 63, 2 ** 63 - 1], np.int64)
    mat, nb = io_formats.zigzag_varints(v)
    from test_avro import _zz

    assert [mat[i, :nb[i]].tobytes() for i in range(v.size)] == [_zz(int(x)) for x in v]
