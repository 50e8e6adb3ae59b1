"""The port's Arrow C data interface (``cudf_tpu_torch/arrow_cdata.py``)
against pyarrow and the reference's (``cudf_tpu/arrow_cdata.py``): the
port's capsules read by pyarrow and by the reference, pyarrow's and the
reference's capsules read by the port, and the stream round trip with
capsules only (no pyarrow object on the path).  Every value exact;
nulls, empty strings, lists, structs, dictionaries, timestamps with a
zone, dates, decimals and sliced arrays included.
"""

import decimal

import numpy as np
import pyarrow as pa
import pytest
import torch

import cudf_tpu as ref
from cudf_tpu import arrow_cdata as ref_cdata

import cudf_tpu_torch as ct
from cudf_tpu_torch import arrow_cdata

CPU = torch.device("cpu")


def _table():
    return pa.table({
        "i": pa.array([1, None, 3, -4], pa.int64()),
        "u8": pa.array([1, 2, 255, 0], pa.uint8()),
        "f": pa.array([0.5, float("nan"), None, -2.0]),
        "b": pa.array([True, None, False, True]),
        "s": pa.array(["x", "", None, "zz" * 40]),
        "l": pa.array([[1, 2], [], None, [3]], pa.list_(pa.int64())),
        "st": pa.array([{"a": 1, "b": "p"}, None, {"a": 3, "b": None}, {"a": 4, "b": "q"}],
                       pa.struct([("a", pa.int64()), ("b", pa.string())])),
        "d": pa.array(["u", "v", None, "u"]).dictionary_encode(),
        "t": pa.array([0, 10 ** 18, None, 5], pa.timestamp("ns", tz="UTC")),
        "day": pa.array([0, 19000, None, 1], pa.date32()),
        "dec": pa.array([decimal.Decimal("1.25"), None, decimal.Decimal("-3.50"),
                         decimal.Decimal("0.01")], pa.decimal128(10, 2)),
    })


def _nan(v):
    return "NaN" if isinstance(v, float) and v != v else v


def _plain(tbl):
    """Arrow values as Python (NaN as a marker, so that it equals itself)."""
    return {n: [_nan(v) for v in tbl.column(n).to_pylist()] for n in tbl.column_names}


def test_pyarrow_into_the_port_and_back():
    tbl = _table()
    df = ct.from_arrow(tbl, device=CPU)
    back = pa.table(df)                             # the port's capsules into pyarrow
    assert _plain(back) == _plain(tbl)
    stream_back = pa.RecordBatchReader.from_stream(df).read_all()
    assert _plain(stream_back) == _plain(tbl)


def test_capsules_alone_round_trip():
    tbl = _table()
    df = ct.from_arrow(tbl, device=CPU)

    class StreamOnly:                               # no pyarrow object on the path
        def __init__(self, obj):
            self.obj = obj

        def __arrow_c_stream__(self, requested_schema=None):
            return self.obj.__arrow_c_stream__(requested_schema)

    again = ct.DataFrame.from_arrow(StreamOnly(df), device=CPU)
    assert _plain(pa.table(again)) == _plain(tbl)
    col = arrow_cdata.from_c_array(df["s"], device=CPU)
    assert col.to_pylist() == tbl.column("s").to_pylist()


@pytest.mark.parametrize("name", ["i", "f", "b", "s", "l", "st", "d", "day"])
def test_the_reference_reads_the_port_and_the_port_reads_the_reference(name):
    tbl = _table()
    port_col = ct.from_arrow(tbl, device=CPU)[name]
    exp = [_nan(v) for v in tbl.column(name).to_pylist()]
    ref_col = ref_cdata.from_c_array(port_col)             # port capsules -> reference
    assert [_nan(v) for v in ref_col.to_arrow().to_pylist()] == exp
    back = arrow_cdata.from_c_array(ref_col, device=CPU)   # reference capsules -> port
    assert [_nan(v) for v in pa.array(back).to_pylist()] == exp


def test_sliced_and_chunked_arrays():
    arr = pa.array([f"v{i}" if i % 3 else None for i in range(50)]).slice(7, 20)
    got = arrow_cdata.from_c_array(arr, device=CPU)
    assert got.to_pylist() == arr.to_pylist()
    lst = pa.array([[i, i + 1] for i in range(30)], pa.large_list(pa.int32())).slice(5, 9)
    assert arrow_cdata.from_c_array(lst, device=CPU).to_pylist() == lst.to_pylist()
    chunked = pa.chunked_array([pa.array([1, 2]), pa.array([3])])
    assert ct.from_arrow(chunked, device=CPU).to_pandas().tolist() == [1, 2, 3]


def test_interop_dlpack_and_table_arrow():
    t = torch.arange(6, dtype=torch.float64)
    s = ct.from_dlpack(t)
    assert s.to_pandas().tolist() == t.tolist()
    cap = ct.to_dlpack(s)
    assert torch.equal(torch.from_dlpack(cap), t)
    two = ct.from_dlpack(torch.arange(6).reshape(3, 2))
    assert two.to_pandas().values.tolist() == [[0, 1], [2, 3], [4, 5]]
    small = pa.table({n: _table().column(n) for n in ("i", "s", "f")})
    assert _plain(ct.from_arrow(small, device=CPU).to_arrow()) == \
        _plain(ref.DataFrame.from_arrow(small).to_arrow()) == _plain(small)
    assert np.array_equal(ct.Table.from_arrow(_table(), device=CPU)["i"].data.numpy()[[0, 2]],
                          [1, 3])
