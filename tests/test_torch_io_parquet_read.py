"""The port's ``read_parquet`` against the reference's on files pyarrow
writes (dictionary and PLAIN pages, v1 and v2, snappy / gzip / zstd /
none, nulls, empty and long strings, booleans, INT96, FLBA decimals,
logical int widths, timestamps, dates, the page index), and on files the
reference's writer writes (bloom filters, DELTA_BINARY_PACKED, pages
split by rows): the same ``to_pandas()``, the same tier taken (counted in
``io.IO_ROUTES``), and for the same filters the same rows and the same
``PAGE_COUNTERS``.  Inputs from seeded numpy; values exact, floats
compared bit for bit (NaN as NaN).
"""

import datetime

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import torch_jax_cache  # noqa: F401  (the run's shared JAX compile cache)
from cudf_tpu.io import parquet as ref_parquet
from cudf_tpu.io import parquet_native as ref_native
from cudf_tpu.io.parquet_writer import write_parquet_native as ref_write
import cudf_tpu as ref

import cudf_tpu_torch as ct
from cudf_tpu_torch.io import IO_ROUTES
from cudf_tpu_torch.io import parquet_native as pn

CPU = torch.device("cpu")
N = 2_000


def _arrow_table(seed=0):
    rng = np.random.default_rng(seed)
    nulls = rng.random(N) < 0.1
    words = [None if i % 13 == 0 else ("" if i % 9 == 0 else f"w{i % 41}") for i in range(N)]
    words[3] = "L" * 70_000
    return pa.table({
        "i64": pa.array(rng.integers(-10 ** 12, 10 ** 12, N), mask=nulls),
        "i32": pa.array(rng.integers(-100, 100, N).astype(np.int32)),
        "i8": pa.array(rng.integers(-100, 100, N).astype(np.int8)),
        "u16": pa.array(rng.integers(0, 60000, N).astype(np.uint16)),
        "u32": pa.array(rng.integers(0, 2 ** 32, N).astype(np.uint32)),
        "f32": pa.array(rng.normal(size=N).astype(np.float32)),
        "f64": pa.array(np.where(rng.random(N) < 0.05, np.nan, rng.normal(size=N)), mask=nulls),
        "s": pa.array(words),
        "lowcard": pa.array(rng.choice(["CSH", "CRD", "DIS"], N)),
        "ts_ms": pa.array(rng.integers(0, 10 ** 12, N), pa.timestamp("ms")),
        "ts_us": pa.array(rng.integers(0, 10 ** 15, N), pa.timestamp("us"), mask=nulls),
        "ts_ns": pa.array(rng.integers(0, 10 ** 18, N), pa.timestamp("ns")),
        "date": pa.array(rng.integers(0, 20000, N).astype(np.int32), pa.date32()),
        "dec": pa.array([None if m else __import__("decimal").Decimal(int(v)).scaleb(-2)
                         for v, m in zip(rng.integers(-10 ** 8, 10 ** 8, N), nulls)],
                        pa.decimal128(10, 2)),
    })


def _norm(pdf: pd.DataFrame) -> pd.DataFrame:
    out = pdf.reset_index(drop=True).copy()
    for c in out.columns:
        col = out[c]
        if col.dtype.kind in "fc":
            out[c] = col.astype("float64")
        elif col.dtype.kind in "iub":
            out[c] = col.astype("float64" if col.dtype.kind != "b" else object)
        elif col.dtype.kind == "M" or any(isinstance(v, datetime.date) for v in col[:5]):
            ns = pd.to_datetime(col).astype("datetime64[ns]")
            out[c] = ns.astype("int64").where(ns.notna(), -1)
        else:
            out[c] = [None if v is None or (isinstance(v, float) and v != v) else str(v)
                      for v in col]
    return out


def _same(got: pd.DataFrame, exp: pd.DataFrame):
    got, exp = _norm(got), _norm(exp)
    assert list(got.columns) == list(exp.columns)
    for c in exp.columns:
        g, e = got[c].to_numpy(), exp[c].to_numpy()
        if g.dtype.kind == "f" and e.dtype.kind == "f":
            np.testing.assert_array_equal(g, e, err_msg=c)
        else:
            assert list(g) == list(e), c


@pytest.fixture(scope="module")
def arrow_table():
    return _arrow_table()


_PYARROW_OPTS = {
    "dict_v1_snappy": dict(),
    "plain_v1_none": dict(use_dictionary=False, compression="none"),
    "dict_v2_gzip": dict(data_page_version="2.0", compression="gzip"),
    "plain_v2_zstd": dict(data_page_version="2.0", use_dictionary=False, compression="zstd"),
    "small_pages_index": dict(data_page_size=2048, write_page_index=True, row_group_size=700),
    "int96": dict(use_deprecated_int96_timestamps=True),
}


@pytest.mark.parametrize("name", list(_PYARROW_OPTS))
def test_pyarrow_files_read_as_the_reference_reads_them(tmp_path, arrow_table, name):
    path = str(tmp_path / f"{name}.parquet")
    pq.write_table(arrow_table, path, **_PYARROW_OPTS[name])
    before = dict(IO_ROUTES)
    got = ct.read_parquet(path, device=CPU)
    assert IO_ROUTES["native"] == before["native"] + 1
    assert IO_ROUTES["pyarrow"] == before["pyarrow"]
    _same(got.to_pandas(), ref.read_parquet(path).to_pandas())
    cols = ["s", "i32", "ts_ns"]
    _same(ct.read_parquet(path, columns=cols, device=CPU).to_pandas(),
          ref.read_parquet(path, columns=cols).to_pandas())


def test_declared_shapes_take_the_pyarrow_tier(tmp_path):
    """v2 booleans are RLE-encoded (encoding 3) and a FIXED_LEN_BYTE_ARRAY
    of 16 bytes exceeds 8: the native tier declares both unsupported and
    gives them to pyarrow, as the reference's reader falls back."""
    rng = np.random.default_rng(1)
    cases = {
        "rle_bool": (pa.table({"b": pa.array(rng.random(500) < 0.5)}),
                     dict(data_page_version="2.0")),
        "flba16": (pa.table({"d": pa.array([__import__("decimal").Decimal(i) for i in
                                            range(50)], pa.decimal128(30, 0))}), dict()),
    }
    for name, (tbl, opts) in cases.items():
        path = str(tmp_path / f"{name}.parquet")
        pq.write_table(tbl, path, **opts)
        with pytest.raises(NotImplementedError):
            ref_native.read_parquet_native(path)
        with pytest.raises(pn.UnsupportedParquet):
            pn.read_parquet_native(path, device=CPU)
        before = IO_ROUTES["pyarrow"]
        got = ct.read_parquet(path, device=CPU)
        assert IO_ROUTES["pyarrow"] == before + 1
        _same(got.to_pandas(), ref.read_parquet(path).to_pandas())


def _written(tmp_path, name, **opts):
    rng = np.random.default_rng(2)
    pdf = pd.DataFrame({"a": rng.integers(-50, 50, 6000).astype(np.int32),
                        "b": rng.integers(0, 10 ** 9, 6000),
                        "c": np.round(rng.uniform(0, 100, 6000), 2),
                        "s": [f"k{v}" for v in rng.integers(0, 30, 6000)]})
    pdf = pdf.sort_values("a", kind="stable").reset_index(drop=True)
    path = str(tmp_path / f"{name}.parquet")
    ref_write(ref.DataFrame.from_pandas(pdf), path, **opts)
    return path


_FILTERS = {"lt": [("a", "<", -20)], "range": [("a", ">=", 10), ("a", "<", 12)],
            "eq_string": [("s", "==", "k7")], "two_columns": [("b", ">", 5 * 10 ** 8),
                                                              ("a", "==", 3)],
            "none_match": [("a", ">", 1000)]}


@pytest.mark.parametrize("flt", list(_FILTERS))
def test_filters_prune_pages_as_the_reference_does(tmp_path, flt):
    path = _written(tmp_path, "pages", row_group_size=1500, data_page_rows=400,
                    bloom_filter_columns=["s", "b"])
    pn.PAGE_COUNTERS.update(decoded=0, skipped=0)
    ref_native.PAGE_COUNTERS.update(decoded=0, skipped=0)
    got = ct.read_parquet(path, filters=_FILTERS[flt], device=CPU).to_pandas()
    exp = ref.read_parquet(path, filters=_FILTERS[flt]).to_pandas()
    _same(got, exp)
    assert pn.PAGE_COUNTERS == ref_native.PAGE_COUNTERS
    assert pn.prune_row_groups(path, _FILTERS[flt]) == \
        ref_native.prune_row_groups(path, _FILTERS[flt])


@pytest.mark.parametrize("opts", [dict(use_delta_binary=True, use_dictionary=False),
                                  dict(data_page_version=2, compression="zstd"),
                                  dict(write_page_index=False, row_group_size=1000)])
def test_reference_written_files(tmp_path, opts):
    path = _written(tmp_path, "ref", **opts)
    _same(ct.read_parquet(path, device=CPU).to_pandas(), ref.read_parquet(path).to_pandas())
    row_groups = [0, 2] if "row_group_size" in opts else [0]
    _same(ct.read_parquet(path, row_groups=row_groups, device=CPU).to_pandas(),
          ref.read_parquet(path, row_groups=row_groups).to_pandas())


def test_chunked_reader_and_metadata(tmp_path):
    path = _written(tmp_path, "chunks", row_group_size=1000)
    reader = ct.io.parquet.ParquetReader(path, chunk_read_limit=1, device=CPU)
    parts = [c.to_pandas() for c in reader]
    assert len(parts) == reader.num_row_groups == 6
    _same(pd.concat(parts), ref.read_parquet(path).to_pandas())
    md = ct.io.parquet.read_parquet_metadata(path)
    assert md.num_rows == pq.ParquetFile(path).metadata.num_rows == 6000
    assert len(md.row_groups) == 6
    chunks = list(pn.read_parquet_native_chunked(path, memory_budget=30_000, device=CPU))
    assert sum(t.num_rows for t in chunks) == 6000
    out = str(tmp_path / "chunked_write.parquet")
    with ct.io.parquet.ParquetWriter(out) as writer:
        for part in ct.io.parquet.ParquetReader(path, chunk_read_limit=1, device=CPU):
            writer.write_table(part)
    _same(pq.read_table(out).to_pandas(), ref.read_parquet(path).to_pandas())


def test_pandas_metadata_takes_the_pyarrow_tier(tmp_path):
    pdf = pd.DataFrame({"c": pd.Categorical(["a", "b", "a"]), "x": [1, 2, 3]})
    path = str(tmp_path / "cat.parquet")
    pdf.to_parquet(path)
    before = IO_ROUTES["pyarrow"]
    got = ct.read_parquet(path, device=CPU).to_pandas()
    assert IO_ROUTES["pyarrow"] == before + 1
    assert str(got["c"].dtype) == "category" and got["c"].tolist() == ["a", "b", "a"]
    assert ref_parquet._has_pandas_ext_metadata(path)


_DNF = {"two_conjunctions": [[("a", "<", 1.0)], [("b", ">", 4)]],
        "ne_over_nulls_and_nan": [("a", "!=", 1.0)],
        "string_ne_or_eq": [[("s", "!=", "x")], [("b", "==", 2)]],
        "not_in_keeps_nulls": [[("s", "not in", ["x"])]],
        "in": [("b", "in", [2, 4])],
        "and_or": [[("a", ">", 2.0), ("b", "<", 5)], [("s", "==", "x")]]}


@pytest.mark.parametrize("flt", list(_DNF))
def test_dnf_filters_and_nulls_as_pyarrow_filters_them(tmp_path, flt):
    """A DNF of several conjunctions keeps a row any conjunction keeps;
    a null passes no comparison, a NaN is a value (pyarrow's filter).  The
    reference reads such a DNF unfiltered (ROADMAP.md §3)."""
    path = str(tmp_path / "dnf.parquet")
    pq.write_table(pa.table({"a": pa.array([0.5, None, float("nan"), 3.0, 1.0, 2.0] * 50),
                             "b": pa.array([1, 2, None, 4, 5, 6] * 50),
                             "s": pa.array(["x", None, "y", "z", "x", ""] * 50)}),
                   path, row_group_size=64)
    before = dict(IO_ROUTES)
    got = ct.read_parquet(path, filters=_DNF[flt], device=CPU).to_pandas()
    assert IO_ROUTES["native"] == before["native"] + 1
    assert IO_ROUTES["pyarrow"] == before["pyarrow"]
    exp = pq.read_table(path, filters=_DNF[flt]).to_pandas()
    assert len(got) == len(exp) and len(exp) > 0
    _same(got, exp)


def test_an_expression_filter_takes_the_pyarrow_tier(tmp_path):
    import pyarrow.dataset as ds

    path = _written(tmp_path, "expr")
    expr = (ds.field("a") < -20) | (ds.field("s") == "k7")
    before = IO_ROUTES["pyarrow"]
    got = ct.read_parquet(path, filters=expr, device=CPU).to_pandas()
    assert IO_ROUTES["pyarrow"] == before + 1
    _same(got, pq.read_table(path, filters=expr).to_pandas())


def test_timing_splits_the_threaded_read_it_times(tmp_path, monkeypatch):
    """``TIMING`` splits the read on its own schedule (staging threads
    ahead of the reading thread): the reading thread's spans add up to
    no more than the read, the staging threads' seconds come apart, and
    the rows are the untimed read's."""
    import time

    monkeypatch.setattr(pn, "HOST_THREADS", 4)
    path = _written(tmp_path, "timed", row_group_size=500)
    plain = ct.read_parquet(path, device=CPU).to_pandas()
    pn.TIMING = {}
    try:
        t0 = time.perf_counter()
        got = ct.read_parquet(path, device=CPU).to_pandas()
        wall = time.perf_counter() - t0
        split = dict(pn.TIMING)
    finally:
        pn.TIMING = None
    _same(got, plain)
    spans = {k: v for k, v in split.items() if not k.startswith("workers_")}
    assert {"footer", "wait", "h2d", "device"} <= set(spans)
    assert {"workers_read", "workers_decompress", "workers_levels"} <= set(split)
    assert 0 < sum(spans.values()) <= wall
