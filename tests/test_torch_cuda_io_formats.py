"""The JSON, ORC, Avro, tpudf and text readers and writers on the card,
each against the same call on the CPU.

Marked ``cuda``: without a CUDA device every test here skips (decided in
the fixture, never at import).  On a machine with a card run
``python -m pytest tests/test_torch_cuda_io_formats.py -q --noconftest``.
The caching allocator is filled with 0xFF bytes before each read, so a
decode that leaves a byte unwritten shows; every column is held to the
CPU's bit for bit, every written file byte for byte.
"""

import numpy as np
import pytest
import torch

import cudf_tpu_torch as ct
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.io import IO_ROUTES
from cudf_tpu_torch.models import io_formats, io_paths

pytestmark = pytest.mark.cuda

N = 30_000


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _junk(dev):
    blocks = [torch.full((1 << 24,), 255, dtype=torch.uint8, device=dev) for _ in range(8)]
    torch.cuda.synchronize()
    del blocks


def _moved(col, device):
    t = lambda x: None if x is None else x.to(device)    # noqa: E731
    return Column(col.dtype, col.length, t(col.data), t(col.validity), t(col.offsets),
                  [_moved(c, device) for c in col.children])


def _cpu(col):
    return _moved(col, "cpu")


def _on(df, device):
    """The CPU frame's columns copied to ``device`` (the same values: the
    card's generator draws other numbers)."""
    return ct.DataFrame({n: _moved(c, device) for n, c in df._table.items()})


def _same(got, exp):
    assert list(got._table.names) == list(exp._table.names)
    for n in exp._table.names:
        io_paths.same_bits(_cpu(got._table[n]), _cpu(exp._table[n]), n)


def _frame(seed=0):
    rng = np.random.default_rng(seed)
    g = io_paths.g1_frame(N, seed=seed, device="cpu")
    words = [None if i % 11 == 0 else ["", "é\"/\\", "\U0001F600", f"w{i % 97}"][i % 4]
             for i in range(N)]
    g["s"] = Column.from_strings(words, device="cpu")
    g["f"] = torch.from_numpy(rng.normal(size=N) * 10.0 ** rng.integers(-20, 20, N))
    g["b"] = torch.from_numpy(rng.random(N) < 0.4)
    g["t"] = io_paths.taxi_frame(N, device="cpu")._table["pickup_datetime"]
    return g


@pytest.mark.parametrize("lines", [True, False])
def test_json_write_and_read_on_the_card_equal_the_cpu(dev, tmp_path, lines):
    c = _frame()
    g = _on(c, dev)
    text = g.to_json(lines=lines)
    assert text == c.to_json(lines=lines)
    path = str(tmp_path / "x.json")
    with open(path, "w") as f:
        f.write(text)
    _junk(dev)
    _same(ct.read_json(path, lines=lines, device=dev), ct.read_json(path, lines=lines,
                                                                      device="cpu"))


@pytest.mark.parametrize("comp", [None, "zlib", "snappy"])
def test_orc_write_and_read_on_the_card_equal_the_cpu(dev, tmp_path, comp):
    c = _frame(1)
    g = _on(c, dev)
    a, b = str(tmp_path / "a.orc"), str(tmp_path / "b.orc")
    g.to_orc(a, compression=comp, stripe_size=7000)
    c.to_orc(b, compression=comp, stripe_size=7000)
    assert open(a, "rb").read() == open(b, "rb").read()
    _junk(dev)
    _same(ct.read_orc(a, device=dev), ct.read_orc(a, device="cpu"))


def test_avro_tpudf_and_text_on_the_card_equal_the_cpu(dev, tmp_path):
    c = io_paths.g1_frame(N, seed=2, device="cpu")
    for codec in ("null", "deflate"):
        path = str(tmp_path / f"{codec}.avro")
        with open(path, "wb") as f:
            f.write(io_formats.g1_avro(c, codec, block_rows=4096))
        _junk(dev)
        _same(ct.read_avro(path, device=dev), ct.read_avro(path, device="cpu"))
    path = str(tmp_path / "x.tpudf")
    _on(c, dev).to_tpudf(path)
    _same(ct.read_tpudf(path, device=dev), c)
    c.to_json(str(tmp_path / "x.ndjson"), lines=True)
    a = ct.read_text(str(tmp_path / "x.ndjson"), device=dev)._column
    b = ct.read_text(str(tmp_path / "x.ndjson"), device="cpu")._column
    io_paths.same_bits(_cpu(a), b, "read_text")
    assert IO_ROUTES["pyarrow"] == 0 and IO_ROUTES["pandas"] == 0
