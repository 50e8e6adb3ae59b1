"""The port's ``read_csv`` (the device tokenizer, ``io/csv_device.py``, and
the pyarrow tier for the shapes it gives away) and ``to_csv`` against the
reference's and pandas'.

The reference's device tier compiles for seconds a call on the CPU, so
it reads ONE file holding every shape the tokenizer serves (quoted
fields with delimiters and newlines inside, ``""`` escapes, empty fields,
ints, 6-decimal floats, booleans, G1's ``idNNN`` strings) once a module;
the many small cases are held to pandas, which answers in milliseconds.
Values exact (floats within 1 ulp of pandas' parse, which is the
correctly rounded one).
"""

import io

import numpy as np
import pandas as pd
import pytest
import torch

import torch_jax_cache  # noqa: F401  (the run's shared JAX compile cache)
from cudf_tpu.io import csv as ref_csv

import cudf_tpu_torch as ct
from cudf_tpu_torch.io import IO_ROUTES
from cudf_tpu_torch.models import io_paths

CPU = torch.device("cpu")


def _every_shape(n=400, seed=0):
    rng = np.random.default_rng(seed)
    lines = ["id1,n,v3,flag,note"]
    for i in range(n):
        note = ['plain', '"with, comma"', '"say ""hi"""', '', '"two\nlines"'][i % 5]
        num = "" if i % 17 == 0 else str(int(rng.integers(-10 ** 6, 10 ** 6)))
        lines.append(f"id{i % 100:03d},{num},{rng.uniform(0, 100):.6f},"
                     f"{['True', 'false', 'TRUE'][i % 3]},{note}")
    return ("\n".join(lines) + "\n").encode()


def _norm(pdf):
    out = pdf.reset_index(drop=True).copy()
    for c in out.columns:
        if out[c].dtype.kind in "iuf":
            out[c] = out[c].astype("float64")
        elif out[c].dtype.kind != "b":
            out[c] = [None if v is None or (isinstance(v, float) and v != v) else str(v)
                      for v in out[c]]
    return out


def _same(got, exp):
    got, exp = _norm(got), _norm(exp)
    assert list(got.columns) == list(exp.columns)
    for c in exp.columns:
        if exp[c].dtype.kind == "f":
            g, e = got[c].to_numpy(), exp[c].to_numpy()
            ulps = np.abs(g.view(np.int64) - e.view(np.int64))
            assert np.array_equal(np.isnan(g), np.isnan(e)) and (
                ulps[~np.isnan(e)] <= 1).all(), c
        else:
            assert list(got[c]) == list(exp[c]), c


@pytest.fixture(scope="module")
def shapes_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("csv") / "shapes.csv"
    path.write_bytes(_every_shape())
    return str(path)


@pytest.fixture(scope="module")
def reference_read(shapes_file):
    return ref_csv.read_csv(shapes_file).to_pandas()


def test_every_shape_against_the_reference_and_pandas(shapes_file, reference_read):
    before = dict(IO_ROUTES)
    got = ct.read_csv(shapes_file, device=CPU).to_pandas()
    assert IO_ROUTES["native"] == before["native"] + 1
    _same(got, reference_read)
    _same(got, pd.read_csv(shapes_file))


@pytest.mark.parametrize("usecols", [["note"], ["v3", "id1"], ["n"]])
def test_usecols_against_pandas(shapes_file, usecols):
    got = ct.read_csv(shapes_file, usecols=usecols, device=CPU).to_pandas()
    exp = pd.read_csv(shapes_file, usecols=usecols)
    _same(got, exp[[c for c in got.columns]])


_SMALL = {
    "quoted_delimiter": b'a,b\n"1,2",3\n"x",4\n',
    "escaped_quotes": b'a,b\n"he said ""hi""",1\n"""",2\n',
    "empty_fields": b"a,b,c\n1,,x\n,2,\n3,3,y\n",
    "crlf": b"a,b\r\n1,x\r\n2,y\r\n",
    "no_trailing_newline": b"a,b\n1,2\n3,4",
    "floats_and_exponents": b"f\n1.5\n-2.25e3\n.5\n1e-7\n",
    "booleans": b"b\nTrue\nfalse\nTRUE\n",
    "all_empty_column": b"a,b\n1,\n2,\n",
    "tab_delimiter": b"a\tb\n1\tx\n",
}


@pytest.mark.parametrize("name", list(_SMALL))
def test_small_shapes_against_pandas(name):
    data = _SMALL[name]
    sep = "\t" if "tab" in name else ","
    got = ct.read_csv(data, sep=sep, device=CPU).to_pandas()
    exp = pd.read_csv(io.BytesIO(data), sep=sep)
    _same(got, exp)


def _late(value):
    """A column whose first 100 rows are ints (or booleans), then ``value``."""
    head = ["True", "false"] if value == "maybe" else ["7", "-3"]
    return ("a,b\n" + "".join(f"{head[i % 2]},{i}\n" for i in range(100))
            + f"{value},100\n").encode()


@pytest.mark.parametrize("value", ["1.5", "abc", "2e3", "maybe"])
def test_a_late_row_widens_the_inferred_type_on_the_device(value):
    """Type inference reads the first rows; a later row that does not
    parse widens the column as pandas does, on the device tier."""
    data = _late(value)
    before = dict(IO_ROUTES)
    got = ct.read_csv(data, device=CPU).to_pandas()
    assert IO_ROUTES["native"] == before["native"] + 1
    assert IO_ROUTES["pyarrow"] == before["pyarrow"]
    exp = pd.read_csv(io.BytesIO(data))
    assert (got["a"].dtype.kind in "iuf") == (exp["a"].dtype.kind in "iuf")
    _same(got, exp)


def test_a_named_dtype_that_does_not_parse_raises():
    """A ``dtype`` the data does not hold raises, as in pandas; the read
    is not handed to the host tier."""
    data = _late("1.5")
    before = dict(IO_ROUTES)
    with pytest.raises(ValueError, match="1.5"):
        ct.read_csv(data, dtype={"a": "int64"}, device=CPU)
    with pytest.raises(ValueError):
        pd.read_csv(io.BytesIO(data), dtype={"a": "int64"})
    assert IO_ROUTES["pyarrow"] == before["pyarrow"]


def test_ragged_rows_take_the_host_tier():
    """Rows of more than one width go to pyarrow, which refuses a long
    row as pandas does."""
    data = b"a,b\n1,2\n3,4,5\n"
    before = IO_ROUTES["pyarrow"]
    with pytest.raises(ValueError):
        ct.read_csv(data, device=CPU)
    assert IO_ROUTES["pyarrow"] == before + 1
    with pytest.raises(ValueError):
        pd.read_csv(io.BytesIO(data))


@pytest.mark.parametrize("kw", [dict(skiprows=1, names=["x", "y"]), dict(nrows=2),
                                dict(na_values=["NA"]), dict(header=None)])
def test_host_tier_shapes_count_their_route(kw):
    data = b"a,b\n1,NA\n2,3\n4,5\n"
    before = IO_ROUTES["pyarrow"]
    got = ct.read_csv(data, device=CPU, **kw).to_pandas()
    assert IO_ROUTES["pyarrow"] == before + 1
    exp = pd.read_csv(io.BytesIO(data), **kw)
    if kw.get("header", "infer") is None:
        exp.columns = [str(c) for c in exp.columns]
        got.columns = [str(i) for i in range(len(got.columns))]
    _same(got, exp)


def test_dtype_dict_and_categories_as_pandas_reads_them():
    """``dtype={"id1": "category"}`` makes a category, as pandas (and
    db-benchmark's pandas solution) reads it; the reference's device tier
    ignores it and gives strings (ROADMAP.md §3)."""
    g1 = io_paths.g1_frame(3000, device=CPU)
    text = io_paths.g1_csv(g1).numpy().tobytes()
    got = ct.read_csv(text, dtype=io_paths.G1_CSV_DTYPES, device=CPU)
    exp = pd.read_csv(io.BytesIO(text), dtype=io_paths.G1_CSV_DTYPES)
    gp = got.to_pandas()
    for c in exp.columns:
        assert str(gp[c].dtype) == str(exp[c].dtype) or (
            str(exp[c].dtype) == "category" and str(gp[c].dtype) == "category"), c
        assert gp[c].astype(str).tolist() == exp[c].astype(str).tolist(), c
    assert io_paths.PLAIN["g1_read_csv"]({"g1": g1}, got) <= 1.0


def test_to_csv_and_scan_csv(tmp_path):
    df = ct.DataFrame.from_pandas(pd.DataFrame({"k": [3, 1, 2], "v": [0.5, None, 2.0],
                                                "s": ["a", "b,c", None]}), device=CPU)
    path = tmp_path / "w.csv"
    df.to_csv(path, index=False)
    assert path.read_text() == df.to_pandas().to_csv(index=False)
    assert ct.Series([1.5, None], device=CPU).to_csv(index=False) == \
        pd.Series([1.5, None]).to_csv(index=False)
    from cudf_tpu_torch.engine import col, lit, scan_csv

    got = scan_csv(str(path), device=CPU).filter(col("k") > lit(1)).select("k", "s").collect()
    _same(got.to_pandas(), pd.read_csv(path).query("k > 1")[["k", "s"]])
    sink = tmp_path / "sink.csv"
    scan_csv(str(path), device=CPU).sink_csv(str(sink)).collect()
    _same(pd.read_csv(sink), pd.read_csv(path))
