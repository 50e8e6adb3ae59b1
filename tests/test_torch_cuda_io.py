"""The Parquet reader and writer, the CSV tokenizer and the Arrow C data
import on the card, each against the same call on the CPU.

Marked ``cuda``: without a CUDA device every test here skips (decided in
the fixture, never at import).  On a machine with a card run
``python -m pytest tests/test_torch_cuda_io.py -q --noconftest``.  The
decode outputs are allocated over junk (the caching allocator is filled
with 0xFF bytes first), and every column is held to the CPU's bit for
bit; written files byte for byte.
"""

import os

import numpy as np
import pytest
import torch

import cudf_tpu_torch as ct
from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.io import IO_ROUTES
from cudf_tpu_torch.io.parquet_writer import write_parquet_native
from cudf_tpu_torch.models import io_paths, tpch

pytestmark = pytest.mark.cuda

N = 30_000


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _junk(dev):
    """Fill the caching allocator's free blocks with 0xFF bytes."""
    blocks = [torch.full((1 << 24,), 255, dtype=torch.uint8, device=dev) for _ in range(8)]
    torch.cuda.synchronize()
    del blocks


def _frame(device, seed=0):
    rng = np.random.default_rng(seed)
    words = [None if i % 11 == 0 else ("" if i % 7 == 0 else f"w{i % 97}") for i in range(N)]
    words[5] = "x" * 70_000                       # a value longer than 2^16 bytes
    valid = rng.random(N) > 0.1
    f64 = rng.normal(size=N)
    df = ct.DataFrame({
        "i32": torch.from_numpy(rng.integers(-50, 50, N).astype(np.int32)).to(device),
        "i64": torch.from_numpy(rng.integers(-10 ** 15, 10 ** 15, N)).to(device),
        "f64": Column(dt.FLOAT64, N, torch.from_numpy(f64).to(device),
                      torch.from_numpy(valid).to(device)),
        "b": torch.from_numpy(rng.random(N) < 0.3).to(device),
        "t": Column(dt.TIMESTAMP_NS, N, torch.from_numpy(
            rng.integers(0, 10 ** 18, N)).to(device)),
        "s": Column.from_strings(words, device=device),
        "d": io_paths.fixed_strings(("CSH", "CRD", "DIS"),
                                    torch.from_numpy(rng.integers(0, 3, N)).to(device)),
    })
    df["cat"] = Column.from_dictionary(
        torch.from_numpy(rng.integers(0, 4, N).astype(np.int32)).to(device),
        Column.from_strings(["a", "bb", "ccc", "dddd"], device=device))
    return df


def _same_frames(got, exp):
    for n in exp._table.names:
        g, e = got._table[n], exp._table[n]
        io_paths.same_bits(_to_cpu(g), e, n)


def _to_cpu(col):
    t = lambda x: None if x is None else x.cpu()    # noqa: E731
    return Column(col.dtype, col.length, t(col.data), t(col.validity), t(col.offsets),
                  [_to_cpu(c) for c in col.children])


@pytest.mark.parametrize("opts", [dict(), dict(compression="uncompressed"),
                                  dict(data_page_version=2, data_page_rows=7_000),
                                  dict(use_dictionary=False, use_delta_binary=True),
                                  dict(row_group_size=10_000, bloom_filter_columns=["i64"])])
def test_parquet_write_and_read_on_the_card(dev, tmp_path, opts):
    cpu_df, gpu_df = _frame("cpu"), _frame(dev)
    a, b = tmp_path / "cpu.parquet", tmp_path / "gpu.parquet"
    write_parquet_native(cpu_df._table, str(a), **opts)
    write_parquet_native(gpu_df._table, str(b), **opts)
    assert a.read_bytes() == b.read_bytes()
    before = IO_ROUTES["pyarrow"]
    _junk(dev)
    got = ct.read_parquet(str(b), device=dev)
    exp = ct.read_parquet(str(a), device="cpu")
    assert IO_ROUTES["pyarrow"] == before
    assert all(c.device.type == "cuda" for c in got._table.columns)
    _same_frames(got, exp)
    flt = [("i32", ">=", 10), ("i64", "<", 0)]
    _same_frames(ct.read_parquet(str(b), filters=flt, device=dev),
                 ct.read_parquet(str(a), filters=flt, device="cpu"))


def test_nested_parquet_on_the_card(dev, tmp_path):
    g1 = io_paths.g1_frame(20_000, device=dev)
    lists, structs = io_paths.nested_frame(g1)
    for name, df in (("l", lists), ("s", structs)):
        df.to_parquet(tmp_path / f"{name}.parquet")
        _junk(dev)
        got = ct.read_parquet(tmp_path / f"{name}.parquet", device=dev)
        io_paths.same_frame(got, df, "nested on the card")
        _same_frames(got, ct.read_parquet(tmp_path / f"{name}.parquet", device="cpu"))


def test_read_csv_on_the_card(dev, tmp_path):
    text = (b'a,b,c,d\n"x,1",2,,True\n"he said ""hi""",,3.5,false\n,5,6.25,TRUE\n' +
            b"".join(b"w%d,%d,%d.125,True\n" % (i, i, i) for i in range(5000)))
    path = tmp_path / "t.csv"
    path.write_bytes(text)
    _junk(dev)
    got = ct.read_csv(str(path), device=dev)
    exp = ct.read_csv(str(path), device="cpu")
    _same_frames(got, exp)
    g1 = io_paths.g1_frame(50_000, device=dev)
    io_paths.write_bytes(str(tmp_path / "g1.csv"), io_paths.g1_csv(g1))
    back = ct.read_csv(str(tmp_path / "g1.csv"), dtype=io_paths.G1_CSV_DTYPES, device=dev)
    frames = {"g1": g1}
    assert io_paths.PLAIN["g1_read_csv"](frames, back) <= 1.0


def test_arrow_stream_import_on_the_card(dev):
    gpu = _frame(dev)
    _junk(dev)
    got = ct.DataFrame.from_arrow(gpu, device=dev)
    assert all(c.device.type == "cuda" for c in got._table.columns)
    _same_frames(got, _frame("cpu"))


def test_tpch_from_parquet_on_the_card(dev, tmp_path):
    for device in ("cpu", dev):
        t = tpch.generate_device(0.005, seed=5, device=device)
        frames = {"dir": str(tmp_path), "device": device,
                  "tpch": dict(t, lineitem=t["lineitem"].sort_values("l_shipdate")
                               .reset_index(drop=True))}
        io_paths.REQUESTS["tpch_write"](frames)
        for q in ("q1", "q6", "q12", "q14"):           # raises unless within rtol 1e-9
            res = io_paths.REQUESTS[f"tpch_{q}_file"](frames)
            io_paths.PLAIN[f"tpch_{q}_file"](frames, res)
        for name in ("lineitem", "orders", "part"):
            os.remove(tmp_path / f"{name}.parquet")
