"""The port's Parquet writer against the reference's: byte for byte the
same file for numeric, bool and STRING frames (nulls, empty strings, a
value longer than 2^16 bytes, NaN) over every option but gzip, whose
header holds the time: codecs, v1 / v2 pages, dictionary or PLAIN, pages
split by rows, row groups, the page index, bloom filters and
DELTA_BINARY_PACKED.

Where the reference writes wrongly the port is held to pyarrow's read of
its file (ROADMAP.md §3): a DICTIONARY column (the reference raises
ImportError at ``cudf_tpu/io/parquet_writer.py:135``) must read back as
its strings, the same bytes as the STRING column; a timestamp column
(the reference writes bare INT64) must read back as a timestamp of its
unit.  Nested columns go through both packages' readers.
"""

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import torch_jax_cache  # noqa: F401  (the run's shared JAX compile cache)
import cudf_tpu as ref
from cudf_tpu.io.parquet_writer import write_parquet_native as ref_write

import cudf_tpu_torch as ct
from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.io import IO_ROUTES
from cudf_tpu_torch.io.parquet_writer import write_parquet_native

CPU = torch.device("cpu")


def _pandas_frame(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    f64 = rng.normal(size=n)
    f64[::17] = np.nan
    words = np.array([f"v{k}" for k in rng.integers(0, 40, n)], dtype=object)
    words[::11] = None
    words[::7] = ""
    words[5] = "z" * 70_000
    wide = np.array([f"row{k:07d}" for k in rng.integers(0, 10 ** 6, n)], dtype=object)
    return pd.DataFrame({
        "i32": rng.integers(-100, 100, n).astype(np.int32),
        "i64": rng.integers(-10 ** 15, 10 ** 15, n),
        "i8": rng.integers(-100, 100, n).astype(np.int8),
        "u32": rng.integers(0, 2 ** 32, n).astype(np.uint32),
        "lowcard": rng.integers(0, 9, n),
        "f32": rng.normal(size=n).astype(np.float32),
        "f64": f64,
        "b": rng.random(n) < 0.4,
        "s": words,
        "wide": wide,
    })


@pytest.fixture(scope="module")
def frames():
    pdf = _pandas_frame()
    return ct.DataFrame.from_pandas(pdf, device=CPU), ref.DataFrame.from_pandas(pdf)


_OPTIONS = {
    "default": dict(),
    "uncompressed": dict(compression="uncompressed"),
    "zstd": dict(compression="zstd"),
    "v2": dict(data_page_version=2),
    "plain": dict(use_dictionary=False),
    "row_groups_and_pages": dict(row_group_size=1000, data_page_rows=300),
    "v2_pages_zstd": dict(data_page_version=2, data_page_rows=700, compression="zstd"),
    "bloom": dict(bloom_filter_columns=["i64", "s", "f64", "wide"]),
    "delta": dict(use_delta_binary=True, use_dictionary=False),
    "no_page_index": dict(write_page_index=False),
}


@pytest.mark.parametrize("name", list(_OPTIONS))
def test_bytes_equal_the_reference(tmp_path, frames, name):
    port_df, ref_df = frames
    a, b = tmp_path / "port.parquet", tmp_path / "ref.parquet"
    write_parquet_native(port_df._table, str(a), **_OPTIONS[name])
    ref_write(ref_df, str(b), **_OPTIONS[name])
    assert a.read_bytes() == b.read_bytes()


def test_gzip_reads_back(tmp_path, frames):
    port_df, _ = frames
    path = str(tmp_path / "g.parquet")
    port_df.to_parquet(path, compression="gzip")
    back = pq.read_table(path).to_pandas()
    exp = port_df.to_pandas()
    pd.testing.assert_frame_equal(back[["i64", "f64", "b"]], exp[["i64", "f64", "b"]])
    assert back["s"].tolist() == [None if v is None else v for v in exp["s"].tolist()]


def test_to_parquet_takes_the_native_writer_for_supported_frames(tmp_path, frames):
    port_df, ref_df = frames
    before = dict(IO_ROUTES)
    port_df.to_parquet(tmp_path / "a.parquet", row_group_size=700)
    ref_df.to_parquet(str(tmp_path / "b.parquet"), row_group_size=700)
    assert IO_ROUTES["native"] == before["native"] + 1 and IO_ROUTES["pyarrow"] == \
        before["pyarrow"]
    assert (tmp_path / "a.parquet").read_bytes() == (tmp_path / "b.parquet").read_bytes()
    indexed = port_df.iloc[5:10]                 # a non-default index: the pyarrow tier
    indexed.to_parquet(tmp_path / "c.parquet")
    assert IO_ROUTES["pyarrow"] == before["pyarrow"] + 1
    assert pq.read_table(tmp_path / "c.parquet").num_rows == 5


def test_dictionary_column_is_written_as_its_strings(tmp_path):
    """Reference fault: writing a DICTIONARY column raises ImportError
    (``cudf_tpu/io/parquet_writer.py:135``); the port writes the bytes the
    STRING column gives, which pyarrow reads back as strings."""
    rng = np.random.default_rng(3)
    keys = ["MAIL", "SHIP", "AIR", "RAIL", "TRUCK", "FOB", "REG AIR", "unused"]
    codes = rng.integers(0, 7, 2000).astype(np.int32)
    valid = rng.random(2000) > 0.1
    dcol = Column.from_dictionary(torch.from_numpy(codes),
                                  Column.from_strings(sorted(keys), device=CPU),
                                  torch.from_numpy(valid))
    scol = dcol.decode_dictionary()
    a, b = tmp_path / "d.parquet", tmp_path / "s.parquet"
    write_parquet_native(ct.DataFrame({"m": dcol})._table, str(a))
    write_parquet_native(ct.DataFrame({"m": scol})._table, str(b))
    assert a.read_bytes() == b.read_bytes()
    got = pq.read_table(a).column("m").to_pylist()
    assert got == [sorted(keys)[c] if v else None for c, v in zip(codes, valid)]
    with pytest.raises(ImportError):
        ref.DataFrame.from_pandas(pd.DataFrame({"m": pd.Categorical(["a", "b"])})).to_parquet(
            str(tmp_path / "r.parquet"))


@pytest.mark.parametrize("unit", ["s", "ms", "us", "ns", "D"])
def test_timestamps_carry_their_logical_type(tmp_path, unit):
    """Reference fault: timestamps are written as bare INT64 and read back
    as int64; the port writes TIMESTAMP of the unit (seconds as ms), a
    day-unit column DATE."""
    rng = np.random.default_rng(4)
    vals = rng.integers(0, 20_000 if unit == "D" else 10 ** 9, 500).astype(
        f"datetime64[{unit}]")
    vals[::9] = np.datetime64("NaT")
    df = ct.DataFrame({"t": vals}, device=CPU)
    path = str(tmp_path / "t.parquet")
    df.to_parquet(path)
    typ = pq.read_table(path).schema.field("t").type
    if unit == "D":
        assert typ == pa.date32()
    else:
        assert typ == pa.timestamp("ms" if unit == "s" else unit)
    back = pq.read_table(path).column("t").to_pandas()
    np.testing.assert_array_equal(back.to_numpy().astype("datetime64[ns]"),
                                  vals.astype("datetime64[ns]"))
    got = ct.read_parquet(path, device=CPU).to_pandas()["t"]
    np.testing.assert_array_equal(got.to_numpy().astype("datetime64[ns]"),
                                  vals.astype("datetime64[ns]"))
    tz = ct.DataFrame({"t": df._table["t"]._as(dt.DType(df._table["t"].dtype.id, tz="UTC"))
                       if unit != "D" else df._table["t"]})
    if unit != "D":
        tz.to_parquet(path)
        assert pq.read_table(path).schema.field("t").type.tz == "UTC"


def test_nested_columns_through_both_readers(tmp_path):
    lists = [[1, 2], None, [], [3, None, 5]] * 50
    structs = [{"a": i, "b": None if i % 3 else float(i)} if i % 7 else None
               for i in range(200)]
    tbl = pa.table({"l": pa.array(lists, pa.list_(pa.int32())),
                    "st": pa.array(structs, pa.struct([("a", pa.int64()), ("b", pa.float64())])),
                    "x": pa.array(np.arange(200))})
    src = str(tmp_path / "src.parquet")
    pq.write_table(tbl, src)
    df = ct.read_parquet(src, device=CPU)
    assert df._table["l"].to_pylist() == ref.read_parquet(src)._table["l"].to_pylist() == lists
    out = str(tmp_path / "port.parquet")
    df.to_parquet(out)
    back = pq.read_table(out)
    assert back.column("l").to_pylist() == lists
    assert back.column("st").to_pylist() == structs
    assert ref.read_parquet(out)._table["l"].to_pylist() == lists
    deeper = pa.table({"ll": pa.array([[[1, 2], [3]], None, [[], None, [4]]],
                                      pa.list_(pa.list_(pa.int64())))})
    pq.write_table(deeper, src)
    assert ct.read_parquet(src, device=CPU)._table["ll"].to_pylist() == \
        deeper.column("ll").to_pylist()
