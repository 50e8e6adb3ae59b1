"""The port's JSON reader (the device tokenizer, ``io/json_device.py``)
and writer (``io/json.py``) against the reference's and pandas'.

The reader is held to the reference's ``read_json_lines_device`` and to
pandas 3.0.3's ``read_json`` on the same seeded text.  Where they differ
by design the rule is stated: an int column with a null reads as
float64 in pandas and as a nullable int64 in the port, a bool column
with a null as float64 in pandas (object in the reference) and as a
nullable bool in the port; those are compared by values and nulls, not
by dtype.  Floats within 1 ulp of pandas' parse.

The writer is held to pandas, not to the reference: the reference writes
an integral float as an integer (``1.0`` as ``1``, ``-0.0`` as ``-0``),
``1e20`` as 21 digits, and leaves off the last newline
(``cudf_tpu/io/json.py:79-93``), so its float64 column reads back as
int64 (``test_the_reference_writes_integral_floats_as_ints`` pins it).
The port's text equals pandas' byte for byte, and ``json.loads`` of
each line equals pandas' line's, types included.
"""

import io
import json
import warnings

import numpy as np
import pandas as pd
import pytest
import torch

import torch_jax_cache  # noqa: F401  (the run's shared JAX compile cache)
from cudf_tpu.io import json as ref_json
from cudf_tpu.io import json_device as ref_json_device

import cudf_tpu_torch as ct
from cudf_tpu_torch.io import IO_ROUTES
from cudf_tpu_torch.io import json as pj
from cudf_tpu_torch.io import json_device as jd
from cudf_tpu_torch.models import io_formats, io_paths

CPU = torch.device("cpu")
TRICKY = [1.0, -0.0, 0.0, 1e20, 1.5, 0.1 + 0.2, 12.345678, 99.999999, 1e15, 1e16, 1.5e16,
          123456789012.5, 1e-5, 1.5e-11, 1e-10, 4e-11, 5e-11, 2.0 ** 53,
          1234567.1234567891234, float("nan"), float("inf"), -1e20, 1e300, 1e-300,
          9.99999999995, 0.99999999999, 12345678901234567.0, 3.14159265358979, -5e-11,
          0.5, 2.5e-10, 9.5e-11]
STRINGS = ['a"b\\c\n\x01é', "plain", "x/y", "\U0001F600z", "\b\f\r\t", "\x7f", "", "\\\\",
           "\\u00e9", "ñandú"]


def _pandas_json(pdf, **kw):
    with warnings.catch_warnings():                 # pandas' epoch date format warns
        warnings.simplefilter("ignore")
        return pdf.to_json(**kw)


def _frame(n=300, seed=0):
    rng = np.random.default_rng(seed)
    f = np.concatenate([TRICKY, rng.normal(size=n) * 10.0 ** rng.integers(-12, 17, n)])
    m = len(f)
    return pd.DataFrame({
        "f": f,
        "i": rng.integers(-10 ** 18, 10 ** 18, m),
        "i8": rng.integers(-100, 100, m).astype(np.int8),
        "u64": rng.integers(0, 2 ** 63, m, dtype=np.uint64) * np.uint64(2),
        "f32": rng.random(m).astype(np.float32),
        "b": rng.random(m) < 0.5,
        "s": [STRINGS[i % len(STRINGS)] for i in range(m)],
        "c": pd.Categorical([["aa", "b", "ccc/"][i % 3] for i in range(m)]),
        "t": pd.to_datetime(rng.integers(-10 ** 18, 10 ** 18, m)),
        "td": pd.to_timedelta(rng.integers(-10 ** 15, 10 ** 15, m)),
    })


@pytest.mark.parametrize("lines", [True, False])
def test_to_json_is_pandas_text_byte_for_byte(lines):
    pdf = _frame()
    before = dict(IO_ROUTES)
    got = ct.DataFrame.from_pandas(pdf, device=CPU).to_json(lines=lines)
    exp = _pandas_json(pdf, orient="records", lines=lines)
    assert got == exp
    assert IO_ROUTES["native"] == before["native"] + 1 and IO_ROUTES["pandas"] == before["pandas"]
    if lines:
        for g, e in zip(got.splitlines(), exp.splitlines()):
            a, b = json.loads(g), json.loads(e)
            assert a.keys() == b.keys()
            for k in a:
                assert type(a[k]) is type(b[k]) and (a[k] == b[k] or a[k] is None), k


def test_nulls_write_as_null_and_floats_stay_floats():
    pdf = pd.DataFrame({"i": pd.array([1, None, 3], dtype="Int64"), "s": ["a", None, "c"],
                        "f": [1.0, None, np.nan], "b": pd.array([True, None, False],
                                                                dtype="boolean"),
                        "v": [1.0, 2.0, 3.0]})
    text = ct.DataFrame.from_pandas(pdf, device=CPU).to_json(lines=True)
    assert text == _pandas_json(pdf, orient="records", lines=True)
    back = ct.read_json(text, lines=True, device=CPU)
    assert back._table["v"].dtype.is_float and back["v"].to_pandas().tolist() == [1.0, 2.0, 3.0]


def test_the_reference_writes_integral_floats_as_ints():
    """The reference's fault (``io/json.py:79-93``), held to pandas: the
    port keeps the float."""
    import cudf_tpu as ref

    pdf = pd.DataFrame({"v": [1.0, 2.0, 3.0], "z": [-0.0, 1e20, 0.5]})
    ref_text = ref_json.write_json(ref.DataFrame.from_pandas(pdf), lines=True)
    assert ref_text == '{"v":1,"z":-0}\n{"v":2,"z":100000000000000000000}\n{"v":3,"z":0.5}'
    assert ct.read_json(ref_text, lines=True, device=CPU)._table["v"].dtype.is_integer
    port_text = ct.DataFrame.from_pandas(pdf, device=CPU).to_json(lines=True)
    assert port_text == _pandas_json(pdf, orient="records", lines=True)
    assert port_text.endswith("\n")
    assert ct.read_json(port_text, lines=True, device=CPU)._table["v"].dtype.is_float


def test_series_to_json_records_and_lines():
    s = pd.Series([1.0, None, 3.5, 1e20], name="v")
    port = ct.Series(s, device=CPU)
    assert port.to_json() == s.to_json(orient="records")
    assert port.to_json(lines=True) == s.to_json(orient="records", lines=True)


def test_other_orients_take_the_counted_pandas_route():
    pdf = pd.DataFrame({"a": [1, 2], "b": ["x", "y"]})
    before = IO_ROUTES["pandas"]
    got = ct.DataFrame.from_pandas(pdf, device=CPU).to_json(orient="columns")
    assert got == pdf.to_json(orient="columns") and IO_ROUTES["pandas"] == before + 1


def _values(col):
    return [None if v is None or (isinstance(v, float) and v != v) else v
            for v in col.tolist()]


def _same_as_pandas(got, exp):
    """Values and nulls (the dtype rules of the module docstring)."""
    assert list(got.columns) == list(exp.columns)
    for c in exp.columns:
        g, e = _values(got[c]), _values(exp[c])
        if exp[c].dtype.kind == "f":
            ga, ea = np.array([np.nan if v is None else v for v in g], float), \
                np.array([np.nan if v is None else v for v in e], float)
            assert np.array_equal(np.isnan(ga), np.isnan(ea)), c
            ok = ~np.isnan(ea)
            assert (np.abs(ga[ok].view(np.int64) - ea[ok].view(np.int64)) <= 1).all(), c
        else:
            assert g == e, c


CASES = {
    "every_type": lambda: _pandas_json(_frame(200, 1)[["f", "i", "b", "s"]], orient="records",
                                       lines=True),
    "missing_keys_nulls_whitespace": lambda: (
        '{"a": 1, "b": "x"}\n{"b" : null , "c": 2.5}\n\n{"a":3,"a":4, "c": 1}\n{}\n'),
    "escapes": lambda: '{"s": "a\\"b\\\\c\\/d\\n\\u00e9\\ud83d\\ude00\\t"}\n{"s": "\\\\\\\\"}\n',
    "int_then_float": lambda: '{"a": 1}\n{"a": 2.5}\n{"a": 3}\n',
    "int_with_null": lambda: '{"a": 1}\n{"a": null}\n{"a": 3}\n',
    "bool_with_null": lambda: '{"a": true}\n{"a": null}\n{"a": false}\n',
    "no_last_newline": lambda: '{"a": 1, "b": "x"}\n{"a": 2, "b": "y"}',
}


@pytest.mark.parametrize("case", list(CASES))
def test_read_json_lines_matches_pandas(case):
    text = CASES[case]()
    got = ct.read_json(text, lines=True, device=CPU).to_pandas()
    exp = pd.read_json(io.StringIO(text), lines=True, convert_dates=False)
    _same_as_pandas(got, exp)


def test_read_json_dtype_as_pandas():
    """``dtype``: categories, a narrower int, floats from ints, strings."""
    text = _pandas_json(_frame(60, 4)[["i8", "s", "c", "b"]], orient="records", lines=True)
    dtype = {"i8": "int32", "s": "category", "c": "category", "b": "bool"}
    got = ct.read_json(text, lines=True, dtype=dtype, device=CPU)
    exp = pd.read_json(io.StringIO(text), lines=True, dtype=dtype)
    assert got._table["s"].dtype.is_dictionary and str(got["i8"].dtype) == "int32"
    _same_as_pandas(got.to_pandas().astype(object), exp.astype(object))
    with pytest.raises(ValueError):
        ct.read_json(text, lines=True, dtype={"s": "int64"}, device=CPU)


def test_read_json_matches_the_reference_device_tokenizer():
    """The same NDJSON through the reference's ``read_json_lines_device``
    (no escapes or widening: the shapes the reference reads right)."""
    pdf = _frame(150, 2)[["f", "i", "b", "c"]]
    text = _pandas_json(pdf, orient="records", lines=True).encode()
    exp = ref_json_device.read_json_lines_device(text).to_pandas()
    got = ct.read_json(text, lines=True, device=CPU).to_pandas()
    assert list(got.columns) == list(exp.columns)
    for c in ("i", "b", "c"):
        assert _values(got[c]) == _values(exp[c]), c
    assert np.allclose(got["f"].to_numpy(), exp["f"].to_numpy(), rtol=1e-15, equal_nan=True)


def test_the_records_orient_reads_on_the_device():
    pdf = _frame(120, 3)[["f", "i", "s"]]
    text = _pandas_json(pdf, orient="records")
    before = dict(IO_ROUTES)
    got = ct.read_json(text, device=CPU).to_pandas()
    assert IO_ROUTES["native"] == before["native"] + 1
    _same_as_pandas(got, pd.read_json(io.StringIO(text), orient="records"))


def test_the_reference_cannot_read_a_surrogate_pair():
    """The reference's fault (``io/json_device.py:274-298``): it reads
    ``\ud83d\ude00``, pandas' escape of any character above the BMP, as
    two lone surrogates and raises UnicodeEncodeError; the port reads
    the character."""
    text = pd.DataFrame({"s": ["\U0001F600z", "a"]}).to_json(orient="records", lines=True)
    with pytest.raises(UnicodeEncodeError):
        ref_json_device.read_json_lines_device(text.encode())
    assert ct.read_json(text, lines=True, device=CPU)["s"].to_pandas().tolist() == \
        ["\U0001F600z", "a"]


def test_nested_shapes_take_the_counted_host_routes():
    before = dict(IO_ROUTES)
    lines = ct.read_json('{"a": {"x": 1}}\n{"a": {"x": 2}}\n', lines=True, device=CPU)
    assert IO_ROUTES["pyarrow"] == before["pyarrow"] + 1
    assert lines._table["a"].dtype.is_struct
    records = ct.read_json('[{"a": [1, 2]}, {"a": [3]}]', device=CPU)
    assert IO_ROUTES["pandas"] == before["pandas"] + 1 and len(records) == 2
    with pytest.raises(jd.UnsupportedJson):
        jd.read_json_device(b'{"a": [1]}\n', device=CPU)


def test_unescape_and_escape_are_inverse_on_the_device():
    words = ["plain", 'q"', "b\\s", "sl/", "\n\t", "é", "\U0001F600", "\x01", ""]
    col = ct.Series(words, device=CPU)._column
    esc = pj.escape(col)
    assert esc.host_strings() == [json.dumps(w)[1:-1].replace("/", "\\/") for w in words]
    assert jd.unescape(esc).host_strings() == words


@pytest.mark.parametrize("n", [1, 7, 5000])
def test_g1_ndjson_built_on_the_device_is_pandas_text(n):
    g = io_paths.g1_frame(n, seed=n, device=CPU)
    text = io_formats.g1_ndjson(g).numpy().tobytes()
    assert text == g.to_pandas().to_json(orient="records", lines=True).encode()
    assert g.to_json(lines=True).encode() == text
