"""The port's ORC reader (``io/orc_native.py``: run headers walked in
``io_host.cpp``, values expanded on the device) and writer
(``io/orc_writer.py``) against pyarrow 25.0.0's and the reference's.

Files written by pyarrow hold each RLEv2 sub-encoding (SHORT_REPEAT,
DIRECT, PATCHED_BASE from columns with outliers, DELTA from sorted and
stepped columns, negative steps included); the test asserts all four
appear.  Every column reads back as pyarrow reads it, bit for bit.

The writer's bytes equal the reference's ``write_orc_native`` called
directly for numeric, bool and STRING frames.  Where the reference is
wrong the port is held to pyarrow: it reads a PATCHED_BASE run's patch
list at the closest ALIGNED width (``orc_native.py:421-422``) where
ORC's writers pad it to the closest FIXED width, so pyarrow's files with
outliers decode wrong or fail (``test_the_reference_misreads_patched_base``);
it writes a DICTIONARY column not at all (ImportError, ``orc_writer.py:309``),
a timestamp as bare LONG ticks and uint16 as SHORT (read back wrapped).
"""

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.orc as po
import pytest
import torch

import torch_jax_cache  # noqa: F401  (the run's shared JAX compile cache)
from cudf_tpu.io import orc_native as ref_native
from cudf_tpu.io import orc_writer as ref_writer

import cudf_tpu_torch as ct
from cudf_tpu_torch.io import IO_ROUTES, _native
from cudf_tpu_torch.io import orc_native as on
from cudf_tpu_torch.io import orc_writer as ow

CPU = torch.device("cpu")
N = 6000


def _table(n=N, seed=0, nulls=True):
    rng = np.random.default_rng(seed)

    def maybe(a, p=0.1):
        return pa.array(np.where(rng.random(n) < p, None, a) if nulls else a)

    return pa.table({
        "i8": pa.array(rng.integers(-100, 100, n).astype(np.int8)),
        "i16": pa.array(rng.integers(-30000, 30000, n).astype(np.int16)),
        "outliers": pa.array(np.where(rng.random(n) < 0.01, 10 ** 9,
                                      rng.integers(0, 100, n)).astype(np.int32)),
        "steps": pa.array(np.cumsum(rng.integers(-5, 3, n))),
        "sorted": pa.array(np.sort(rng.integers(-10 ** 12, 10 ** 12, n))),
        "const": pa.array(np.full(n, 7, np.int64)),
        "desc": pa.array(np.arange(n, 0, -1) * -3),
        "f32": pa.array(rng.random(n).astype(np.float32)),
        "f64": maybe(rng.normal(size=n)),
        "b": maybe(rng.random(n) < 0.5),
        "s": maybe(np.array([f"w{i % 50}" for i in range(n)], object)),
        "u": pa.array([f"uniq{i}-{i * 7}" for i in range(n)]),
        "t": pa.array(rng.integers(-2 * 10 ** 18, 2 * 10 ** 18, n).astype("datetime64[ns]")),
        "d": pa.array(rng.integers(-20000, 20000, n).astype(np.int32), pa.date32()),
    })


def _equal_to_arrow(got, exp: pa.Table):
    assert list(got.columns) == exp.column_names
    for name in exp.column_names:
        a = got._table[name].to_arrow()
        e = exp.column(name).combine_chunks()
        if pa.types.is_date32(e.type):
            e = e.cast(pa.int32())
            a = pa.array(got._table[name].data.numpy().astype(np.int32),
                         mask=None if got._table[name].validity is None
                         else ~got._table[name].validity.numpy())
        assert a.to_pylist() == e.cast(a.type).to_pylist() if a.type != e.type else \
            a.equals(e), name


@pytest.fixture(scope="module")
def pyarrow_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("orc")
    t = _table()
    out = {}
    for comp in ("uncompressed", "zlib", "snappy", "zstd"):
        path = str(d / f"{comp}.orc")
        # strings DIRECT in the uncompressed file, DICTIONARY in the others
        po.write_table(t, path, compression=comp, stripe_size=64 * 1024,
                       dictionary_key_size_threshold=0.0 if comp == "uncompressed" else 1.0)
        out[comp] = path
    return t, out


@pytest.mark.parametrize("comp", ["uncompressed", "zlib", "snappy", "zstd"])
def test_read_orc_equals_pyarrow(pyarrow_files, comp):
    t, paths = pyarrow_files
    before = dict(IO_ROUTES)
    got = ct.read_orc(paths[comp], device=CPU)
    assert IO_ROUTES["native"] == before["native"] + 1 and IO_ROUTES["pyarrow"] == before["pyarrow"]
    assert comp != "uncompressed" or len(on.read_orc_metadata(paths[comp]).stripes) > 1
    _equal_to_arrow(got, po.read_table(paths[comp]))
    assert got._table["i16"].dtype == ct.Series(np.zeros(1, np.int16), device=CPU).dtype
    sub = ct.read_orc(paths[comp], columns=["s", "i8"], device=CPU)
    assert list(sub.columns) == ["s", "i8"]


def test_orc_0_11_files_read_as_pyarrow_reads_them(tmp_path):
    """RLEv1 integer streams and v1 DICTIONARY strings (ORC 0.11)."""
    t = _table(3000, seed=5)
    t = t.append_column("few", pa.array([["aa", "b", "ccc"][i % 3] for i in range(3000)]))
    path = str(tmp_path / "v11.orc")
    po.write_table(t, path, file_version="0.11", dictionary_key_size_threshold=1.0)
    enc = set()
    for streams, st in _streams(path, t.num_columns):
        enc |= set(st.encodings)
    assert 1 in enc                                    # DICTIONARY, v1
    _equal_to_arrow(ct.read_orc(path, device=CPU), po.read_table(path))


def _streams(path, col):
    raw = np.fromfile(path, np.uint8)
    meta = on.parse_metadata(raw)
    for st in meta.stripes:
        on.read_stripe_footer(raw, st, meta)
        yield on.column_streams(raw, st, meta, col), st


def test_every_rlev2_sub_encoding_expands_as_its_plain_decoder(pyarrow_files):
    """The C header walk plus the device expansion against the plain
    value-at-a-time decoder, stream by stream; all four run kinds seen."""
    t, paths = pyarrow_files
    kinds = set()
    for col in range(1, t.num_columns + 1):
        for streams, _ in _streams(paths["uncompressed"], col):
            for k, data in streams.items():
                if k == 0 or t.schema.field(col - 1).type in (pa.float32(), pa.float64()) \
                        or (k == 1 and t.schema.field(col - 1).type in (pa.bool_(), pa.int8(),
                                                                       pa.string())):
                    continue
                signed = k == 1
                runs, _, _ = _native.orc_rle2_runs(data, -1, signed)
                kinds |= set(runs[:, 2].tolist())
                got = on.expand_ints([on._ints(data, True, signed)], signed, CPU).numpy()
                exp = _native.orc_rle2_decode_plain(data.tobytes(), got.size, signed)
                assert np.array_equal(got, exp), (col, k)
    assert kinds == {0, 1, 2, 3}


def test_byte_and_boolean_rle_expand_as_their_plain_decoders(pyarrow_files):
    t, paths = pyarrow_files
    for name in ("b", "i8", "f64"):
        col = t.column_names.index(name) + 1
        for streams, st in _streams(paths["uncompressed"], col):
            if 0 in streams:
                got = on.expand_bits([on._bytes(streams[0])], [st.num_rows], CPU).numpy()
                assert np.array_equal(got, _native.orc_bool_rle_decode_plain(
                    streams[0].tobytes(), st.num_rows))
            if name == "i8":
                got = on.expand_bytes([on._bytes(streams[1])], CPU).numpy()
                assert np.array_equal(got, _native.orc_byte_rle_decode_plain(
                    streams[1].tobytes(), got.size))


def _ints(kind, n, rng):
    return {"random": rng.integers(-1000, 1000, n),
            "runs": np.repeat(rng.integers(-5, 5, n // 7 + 1), 7)[:n],
            "steps": np.cumsum(rng.integers(0, 3, n)),
            "wide": rng.integers(-2 ** 62, 2 ** 62, n),
            "arith": np.arange(n) * 3 - 100,
            "tiny": np.full(min(n, 2), 5)}[kind].astype(np.int64)


@pytest.mark.parametrize("kind", ["random", "runs", "steps", "wide", "arith", "tiny"])
@pytest.mark.parametrize("signed", [True, False])
def test_encoders_give_the_reference_bytes(kind, signed):
    v = _ints(kind, 2500, np.random.default_rng(len(kind)))
    v = v if signed else np.abs(v)
    for mine, plain, ref in ((ow.rle2_encode_ints, _native.orc_rle2_encode_plain,
                              ref_writer.rle2_encode_ints),
                             (ow.rle1_encode_ints, _native.orc_rle1_encode_plain,
                              ref_writer.rle1_encode_ints)):
        assert mine(v, signed) == plain(v, signed) == ref(v, signed)
    b = (v % 7).astype(np.uint8)
    assert ow.byte_rle_encode(b) == _native.orc_byte_rle_encode_plain(b) == \
        ref_writer.byte_rle_encode(b)
    enc1 = ref_writer.rle1_encode_ints(v, signed)
    assert np.array_equal(_native.orc_rle1_decode(enc1, v.size, signed), v)
    assert np.array_equal(_native.orc_rle1_decode_plain(enc1, v.size, signed), v)
    enc2 = ref_writer.rle2_encode_ints(v, signed)
    got = on.expand_ints([on._ints(np.frombuffer(enc2, np.uint8), True, signed)], signed, CPU)
    assert np.array_equal(got.numpy(), v)


def test_the_reference_misreads_patched_base(tmp_path):
    n = 4000
    rng = np.random.default_rng(3)
    v = np.where(rng.random(n) < 0.01, 10 ** 9, rng.integers(0, 100, n)).astype(np.int32)
    path = str(tmp_path / "p.orc")
    po.write_table(pa.table({"x": v}), path)
    runs = [_native.orc_rle2_runs(s[1], -1, True)[0] for s, _ in _streams(path, 1)]
    assert any((r[:, 2] == 3).any() for r in runs)
    try:
        ref_vals = ref_native.read_orc_native(path).to_pandas()["x"].to_numpy()
    except Exception:                       # the walk runs off its runs
        ref_vals = None
    assert ref_vals is None or not np.array_equal(ref_vals, v)
    assert np.array_equal(ct.read_orc(path, device=CPU)["x"].to_numpy(), v)


def _frame(n=3000, seed=1):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "i8": rng.integers(-100, 100, n).astype(np.int8),
        "i32": np.where(rng.random(n) < 0.01, 10 ** 9, rng.integers(0, 100, n)).astype(np.int32),
        "i64": np.cumsum(rng.integers(-5, 3, n)),
        "f32": rng.random(n).astype(np.float32),
        "f64": rng.random(n),
        "fn": np.where(rng.random(n) < 0.1, np.nan, rng.random(n)),
        "b": rng.random(n) < 0.5,
        "s": [f"w{i % 50}" for i in range(n)],
        "sn": pd.array([None if i % 13 == 0 else f"x{i}" for i in range(n)], dtype=object),
    })


@pytest.mark.parametrize("comp", [None, "zlib", "snappy"])
@pytest.mark.parametrize("stripe_size", [700, 1 << 20])
def test_write_orc_gives_the_reference_bytes(tmp_path, comp, stripe_size):
    import cudf_tpu as ref

    pdf = _frame()
    ref_writer.write_orc_native(ref.DataFrame.from_pandas(pdf), str(tmp_path / "r.orc"),
                                stripe_size=stripe_size, compression=comp)
    before = IO_ROUTES["native"]
    ct.DataFrame.from_pandas(pdf, device=CPU).to_orc(str(tmp_path / "p.orc"), compression=comp,
                                                     stripe_size=stripe_size)
    assert IO_ROUTES["native"] == before + 1
    assert (tmp_path / "p.orc").read_bytes() == (tmp_path / "r.orc").read_bytes()
    back = po.read_table(str(tmp_path / "p.orc")).to_pandas()
    for c in pdf.columns:
        assert back[c].astype(object).where(back[c].notna(), None).tolist() == \
            pdf[c].astype(object).where(pdf[c].notna(), None).tolist(), c


def test_dictionary_timestamp_and_unsigned_columns_read_back_in_pyarrow(tmp_path):
    """What the reference writes wrong or not at all, held to pyarrow."""
    rng = np.random.default_rng(2)
    n = 3000
    pdf = pd.DataFrame({
        "c": pd.Categorical(rng.choice(["aa", "b", "ccc"], n)),
        "t": pd.to_datetime(rng.integers(-2 * 10 ** 18, 2 * 10 ** 18, n)),
        "tms": pd.to_datetime(rng.integers(-10 ** 12, 10 ** 12, n), unit="ms"),
        "u16": rng.integers(0, 60000, n).astype(np.uint16),
        "u32": rng.integers(0, 2 ** 32, n).astype(np.uint32)})
    path = str(tmp_path / "x.orc")
    ct.DataFrame.from_pandas(pdf, device=CPU).to_orc(path, compression="snappy", stripe_size=900)
    back = po.read_table(path).to_pandas()
    assert back["c"].tolist() == pdf["c"].astype(str).tolist()
    assert (back["t"].to_numpy() == pdf["t"].to_numpy()).all()
    assert (back["tms"].to_numpy().astype("datetime64[ms]") == pdf["tms"].to_numpy()).all()
    assert back["u16"].tolist() == pdf["u16"].tolist() and back["u32"].tolist() == \
        pdf["u32"].tolist()
    mine = ct.read_orc(path, device=CPU)
    assert (mine["t"].to_numpy() == pdf["t"].to_numpy()).all()
    with pytest.raises(ImportError):
        import cudf_tpu as ref

        ref_writer.write_orc_native(ref.DataFrame.from_pandas(pdf[["c"]]), str(tmp_path / "r.orc"))


def test_files_cross_between_the_packages(tmp_path):
    import cudf_tpu as ref

    pdf = _frame(2000, 4)
    mine, theirs = str(tmp_path / "port.orc"), str(tmp_path / "ref.orc")
    ct.DataFrame.from_pandas(pdf, device=CPU).to_orc(mine, compression="zlib")
    ref_writer.write_orc_native(ref.DataFrame.from_pandas(pdf), theirs, compression="snappy")
    for path in (mine, theirs):
        a = ct.read_orc(path, device=CPU).to_pandas()
        b = ref_native.read_orc_native(path).to_pandas()
        for c in pdf.columns:
            e = pdf[c].astype(object).where(pdf[c].notna(), None).tolist()
            assert a[c].astype(object).where(a[c].notna(), None).tolist() == e, c
            assert b[c].astype(object).where(b[c].notna(), None).tolist() == e, c


def test_declared_shapes_take_the_counted_pyarrow_route(tmp_path):
    path = str(tmp_path / "nested.orc")
    po.write_table(pa.table({"l": pa.array([[1, 2], [3]]), "x": [1, 2]}), path)
    before = IO_ROUTES["pyarrow"]
    got = ct.read_orc(path, device=CPU)
    assert IO_ROUTES["pyarrow"] == before + 1 and got._table["l"].dtype.is_list
    with pytest.raises(on.UnsupportedOrc):
        on.read_orc_native(path, device=CPU)
    flat = str(tmp_path / "flat.orc")
    po.write_table(pa.table({"x": list(range(10))}), flat, stripe_size=64 * 1024)
    assert ct.read_orc(flat, stripes=[0], device=CPU)["x"].tolist() == list(range(10))
    assert IO_ROUTES["pyarrow"] == before + 2
    ct.DataFrame({"x": torch.arange(5)}).to_orc(str(tmp_path / "z.orc"), compression="zstd")
    assert IO_ROUTES["pyarrow"] == before + 3
    assert po.read_table(str(tmp_path / "z.orc")).column("x").to_pylist() == list(range(5))
