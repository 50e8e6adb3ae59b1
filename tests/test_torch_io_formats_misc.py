"""Feather, the tpudf file, text and the stream consumer of the port
(``io/feather.py``, ``tpudf_file.py``, ``text.py``, ``streaming.py``)
against the reference's, and ``models/io_formats.py``'s requests (the
card's JSON, ORC, Avro, tpudf, text and stream paths) at a small size,
each equal to its plain check on the native routes.

Files cross between the packages: a tpudf file is byte for byte the
reference's and each package reads the other's.  ``multibyte_split``
(``io_host.cpp``) equals its plain version and the reference's.
"""

import io

import numpy as np
import pandas as pd
import pytest
import torch

import torch_jax_cache  # noqa: F401  (the run's shared JAX compile cache)
import cudf_tpu as ref
from cudf_tpu import native as ref_native
from cudf_tpu.io import streaming as ref_streaming
from cudf_tpu.io import text as ref_text
from cudf_tpu.io import tpudf_file as ref_tpudf

import cudf_tpu_torch as ct
from cudf_tpu_torch.io import IO_ROUTES, _native
from cudf_tpu_torch.io import streaming
from cudf_tpu_torch.models import io_formats, io_paths

CPU = torch.device("cpu")


def _pdf(n=400, seed=0):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "i": rng.integers(-10 ** 9, 10 ** 9, n), "f": rng.normal(size=n),
        "fn": np.where(rng.random(n) < 0.2, np.nan, rng.random(n)),
        "b": rng.random(n) < 0.5, "s": [f"w{i % 37}" * (i % 4) for i in range(n)],
        "c": pd.Categorical(rng.choice(["x", "yy", "zzz"], n))})


def _listed(pdf):
    return {c: pdf[c].astype(object).where(pdf[c].notna(), None).tolist() for c in pdf.columns}


def test_feather_round_trip_on_the_counted_pyarrow_route(tmp_path):
    pdf = _pdf()
    before = IO_ROUTES["pyarrow"]
    ct.DataFrame.from_pandas(pdf, device=CPU).to_feather(tmp_path / "x.feather")
    got = ct.read_feather(tmp_path / "x.feather", columns=["i", "s"], device=CPU)
    assert IO_ROUTES["pyarrow"] == before + 2
    assert _listed(got.to_pandas()) == _listed(pdf[["i", "s"]])
    theirs = ref.read_feather(str(tmp_path / "x.feather")).to_pandas()
    assert _listed(ct.read_feather(tmp_path / "x.feather", device=CPU).to_pandas()) == \
        _listed(theirs)


def test_tpudf_files_are_the_references_byte_for_byte(tmp_path):
    pdf = _pdf(seed=1)
    mine, theirs = tmp_path / "port.tpudf", tmp_path / "ref.tpudf"
    ct.DataFrame.from_pandas(pdf, device=CPU).to_tpudf(mine)
    ref_tpudf.write_tpudf(ref.DataFrame.from_pandas(pdf), str(theirs))
    assert mine.read_bytes() == theirs.read_bytes()
    for path in (mine, theirs):
        assert _listed(ct.read_tpudf(path, device=CPU).to_pandas()) == _listed(pdf)
        assert _listed(ref_tpudf.read_tpudf(str(path)).to_pandas()) == _listed(pdf)
    (tmp_path / "bad").write_bytes(b"NOPE")
    with pytest.raises(ValueError):
        ct.read_tpudf(tmp_path / "bad", device=CPU)


@pytest.mark.parametrize("delim", ["\n", "||", "\r\n"])
@pytest.mark.parametrize("strip", [True, False])
def test_read_text_equals_the_reference(tmp_path, delim, strip):
    body = delim.join(["", "a", "bb", "ccc" + delim[0] + "x", "", "ñ"]) + "tail"
    path = tmp_path / "t.txt"
    path.write_bytes(body.encode())
    got = ct.read_text(str(path), delimiter=delim, strip_delimiters=strip, device=CPU)
    exp = ref_text.read_text(str(path), delimiter=delim, strip_delimiters=strip)
    assert got.to_pandas().tolist() == exp.to_pandas().tolist()


@pytest.mark.parametrize("data", [b"", b"a", b"a\n", b"\n\n", b"ab\ncd\n\nef",
                                  b"x||y|||z||", bytes(range(256)) * 3])
@pytest.mark.parametrize("delim", [b"\n", b"||", b"\x00\x01"])
def test_multibyte_split_equals_its_plain_version_and_the_references(data, delim):
    got = _native.multibyte_split(data, delim)
    assert np.array_equal(got, _native.multibyte_split_plain(data, delim))
    assert np.array_equal(got, ref_native.multibyte_split(data, delim))


class _Growing(streaming.LogSource, ref_streaming.LogSource):
    def __init__(self):
        self.data = b""

    def end_offset(self):
        return len(self.data)

    def read_range(self, start, end):
        return self.data[start:end]


def _polls(consumer, source, text, cuts):
    polls, at = [], 0
    for cut in cuts:
        source.data += text[at:cut]
        at = cut
        polls.append(consumer.poll())
    return polls


def test_the_stream_consumer_polls_complete_records_as_the_references(monkeypatch):
    """The same appends (cut mid-record) through both consumers: the
    reference's polls hand its reader the same byte ranges (its reader
    stubbed: its device tokenizer compiles for seconds a shape), and each
    of the port's polls is pandas' reading of that range."""
    pdf = _pdf(120, 2)[["i", "f", "s"]]
    text = pdf.to_json(orient="records", lines=True).encode()
    cuts = [5, 6, len(text) // 3 + 1, len(text) // 2, len(text) - 1, len(text)]
    monkeypatch.setattr(ref_streaming.StreamConsumer, "_parse", lambda self, chunk: chunk)
    source = _Growing()
    ranges = _polls(ref_streaming.StreamConsumer(source), source, text, cuts)
    source = _Growing()
    mine = _polls(streaming.StreamConsumer(source, device=CPU), source, text, cuts)
    for got, chunk in zip(mine, ranges):
        assert (got is None) == (chunk is None)
        if got is not None:
            exp = pd.read_json(io.BytesIO(chunk), lines=True)
            assert got["i"].tolist() == exp["i"].tolist() and got["s"].tolist() == \
                exp["s"].tolist()
            assert np.allclose(got["f"].to_numpy(), exp["f"].to_numpy(), rtol=1e-15)
    got = pd.concat([p.to_pandas() for p in mine if p is not None], ignore_index=True)
    assert got["i"].tolist() == pdf["i"].tolist()


def test_a_consumer_seeks_and_caps_its_bytes(tmp_path):
    path = tmp_path / "log.ndjson"
    path.write_bytes(b'{"a": 1}\n{"a": 2}\n{"a": 3}\n')
    c = streaming.StreamConsumer(streaming.FileLogSource(str(path)), device=CPU)
    assert c.poll(max_bytes=12)["a"].tolist() == [1]
    c.seek(0)
    assert c.poll()["a"].tolist() == [1, 2, 3] and c.poll() is None
    with pytest.raises(ValueError):
        streaming.StreamConsumer(streaming.FileLogSource(str(path)), fmt="xml")


def test_the_card_requests_equal_their_plain_checks(tmp_path, monkeypatch):
    """Every ``models/io_formats.py`` request at 3000 rows, in order, on
    the native routes."""
    monkeypatch.setattr(io_formats, "RECORDS_ROWS", 500)
    g = io_paths.g1_frame(3000, seed=3, device=CPU)
    frames = io_formats.prepare(g, io_paths.taxi_frame(2000, device=CPU), str(tmp_path), CPU)
    before = dict(IO_ROUTES)
    for group, names in io_formats.GROUPS.items():
        for name in names:
            res = io_formats.REQUESTS[name](frames)
            if name in io_formats.KEEP:
                frames[io_formats.KEEP[name]] = res
            assert io_formats.PLAIN[name](frames, res) <= 1.0, name
    assert set(io_formats.REQUESTS) == set(io_formats.PLAIN) == set(io_formats.NEEDS)
    assert set(io_formats.ROUTE.values()) == {"native"}
    assert IO_ROUTES["pyarrow"] == before["pyarrow"] and IO_ROUTES["pandas"] == before["pandas"]
    assert IO_ROUTES["native"] > before["native"]
