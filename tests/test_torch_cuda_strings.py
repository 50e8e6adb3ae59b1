"""Strings and temporals on the card: the ``str``, ``dt`` and ``cat``
accessors, the device regex and spans, the parsers and formatters, time
zones and every ``models/strings_dt.py`` request on CUDA tensors, each
against the same call on CPU tensors.

Marked ``cuda``: without a CUDA device every test here skips (decided in
the fixture, never at import).  On a machine with a card run
``python -m pytest tests/test_torch_cuda_strings.py -q --noconftest``.
Text (bytes and offsets), integers, bools, ticks and validity exact;
float sums rtol 1e-9 (atomic adds on the card add in a varying order).
Every output must stay on the card, and no call may take the host route.
"""

import pytest
import torch

import cudf_tpu_torch as ct
from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.models import strings_dt as sd
from cudf_tpu_torch.models import tpch
from cudf_tpu_torch.ops import datetime as dto
from cudf_tpu_torch.ops import strings as so

pytestmark = pytest.mark.cuda

CPU = torch.device("cpu")
N = 200_000
WORDS = ["", "a", "ab", "Hello", "  pad me ", "abcabcab", "ñandú", "Ünïcödé wörld", "日本語",
         "x1y22z333", "id0000000123", "MiXeD", "-42", "+7", "añb", "ok", "2020-01-05"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _text(device):
    g = torch.Generator().manual_seed(3)
    pick = torch.randint(0, len(WORDS), (N,), generator=g).tolist()
    vals = [None if i % 11 == 0 else WORDS[p] for i, p in enumerate(pick)]
    return ct.Series(Column.from_strings(vals, device=device), name="t")


def _equal(got, exp):
    """Two port objects on different devices hold the same columns."""
    if hasattr(got, "_table"):
        assert list(got._table.names) == list(exp._table.names)
        for a, b in zip(got._table.columns, exp._table.columns):
            _equal_col(a, b)
        return
    col = got._column if hasattr(got, "_column") else got.column(got.device)
    ecol = exp._column if hasattr(exp, "_column") else exp.column(exp.device)
    _equal_col(col, ecol)
    if hasattr(got, "_index") and hasattr(got._index, "column"):
        _equal_col(got._index.column(got.device), exp._index.column(exp.device))


def _equal_col(a, b):
    assert a.device.type == "cuda" and a.dtype == b.dtype and a.length == b.length
    if a.dtype.is_dictionary:
        a, b = a.decode_dictionary(), b.decode_dictionary()
    va = torch.ones(a.length, dtype=torch.bool) if a.validity is None else a.validity.cpu()
    vb = torch.ones(b.length, dtype=torch.bool) if b.validity is None else b.validity.cpu()
    assert torch.equal(va, vb)
    if a.dtype.is_string:
        assert torch.equal(a.offsets.cpu(), b.offsets) and torch.equal(a.data.cpu(), b.data)
        return
    x, y = a.data.cpu()[va], b.data[vb]
    if x.is_floating_point():
        assert torch.allclose(x, y, rtol=1e-9, atol=0)
    else:
        assert torch.equal(x, y)


CALLS = {
    "len": lambda s: s.str.len(), "upper": lambda s: s.str.upper(),
    "title": lambda s: s.str.title(), "strip": lambda s: s.str.strip(),
    "slice": lambda s: s.str.slice(1, 4), "get": lambda s: s.str.get(3),
    "contains": lambda s: s.str.contains("ab", regex=False),
    "contains_re": lambda s: s.str.contains(r"a.b|[0-9]{2}"),
    "fullmatch": lambda s: s.str.fullmatch(r".{5}"),
    "startswith": lambda s: s.str.startswith("a"), "find": lambda s: s.str.find("a"),
    "count": lambda s: s.str.count("ab"), "count_re": lambda s: s.str.count(r"[^a ]+"),
    "replace_re": lambda s: s.str.replace(r"a+|ñ", "#", regex=True),
    "replace": lambda s: s.str.replace("ab", "XYZ"),
    "extract": lambda s: s.str.extract(r"([0-9]+)", expand=False),
    "split": lambda s: s.str.split("a", n=2, expand=True),
    "pad": lambda s: s.str.pad(9, fillchar="é"), "zfill": lambda s: s.str.zfill(6),
    "isalpha": lambda s: s.str.isalpha(), "concat": lambda s: s + "_" + s,
    "to_numeric": lambda s: ct.to_numeric(s, errors="coerce"),
    "category": lambda s: s.astype("category"),
}


@pytest.mark.parametrize("name", list(CALLS))
def test_str_on_the_card_equals_cpu(dev, name):
    before = so.STRING_ROUTES["host"]
    _equal(CALLS[name](_text(dev)), CALLS[name](_text(CPU)))
    assert so.STRING_ROUTES["host"] == before


def _stamps(device):
    g = torch.Generator().manual_seed(5)
    ticks = torch.randint(-2_000_000_000, 4_000_000_000, (N,), generator=g) * 10 ** 9
    valid = torch.rand(N, generator=g) > 0.05
    col = Column(dt.TIMESTAMP_NS, N, ticks.to(device), valid.to(device))
    return ct.Series(col, name="d")


DT = {
    **{f: (lambda s, f=f: getattr(s.dt, f)) for f in (
        "year", "month", "day", "hour", "dayofweek", "dayofyear", "quarter", "is_month_end",
        "is_leap_year")},
    "floor": lambda s: s.dt.floor("h"), "round": lambda s: s.dt.round("15min"),
    "strftime": lambda s: s.dt.strftime("%Y-%m-%d %H:%M:%S %j %a %b"),
    "astype_str": lambda s: s.astype(str),
    "roundtrip": lambda s: ct.to_datetime(s.dt.strftime("%Y-%m-%dT%H:%M:%S")),
    "tz": lambda s: s.dt.tz_localize("UTC").dt.tz_convert("America/New_York").dt.hour,
    "tz_local": lambda s: s.dt.tz_localize("Europe/Paris", ambiguous="NaT",
                                           nonexistent="NaT").dt.tz_convert("UTC"),
    "tz_text": lambda s: s.dt.tz_localize("UTC").dt.tz_convert("Asia/Kolkata").astype(str),
    "months": lambda s: ct.Series._from(dto.add_calendrical_months(
        s._column, 13), s._index),
}


@pytest.mark.parametrize("name", list(DT))
def test_dt_on_the_card_equals_cpu(dev, name):
    _equal(DT[name](_stamps(dev)), DT[name](_stamps(CPU)))


def test_date_range_on_the_card(dev):
    for freq in ("MS", "QE", "YS"):
        got = ct.date_range("2001-03-15", periods=40, freq=freq, device=dev)
        exp = ct.date_range("2001-03-15", periods=40, freq=freq, device=CPU)
        _equal(got, exp)


def _moved(col, device):
    """A column with every buffer on ``device``."""
    to = (lambda t: None if t is None else t.to(device))
    return Column(col.dtype, col.length, col.data.to(device), to(col.validity), to(col.offsets),
                  tuple(_moved(c, device) for c in col.children))


@pytest.fixture(scope="module")
def request_frames():
    """The requests' tables, made on the CPU (the card's generators draw
    other numbers)."""
    g = torch.Generator().manual_seed(7)
    df = ct.DataFrame({"v1": torch.randint(1, 6, (N,), generator=g, dtype=torch.int32),
                       "v3": torch.rand(N, generator=g, dtype=torch.float64) * 100})
    for col, k, width in (("id1", 100, 3), ("id3", N // 100, 10)):
        keys = Column.from_strings([f"id{i:0{width}d}" for i in range(1, k + 1)], device=CPU)
        df[col] = Column.from_dictionary(
            torch.randint(0, k, (N,), generator=g, dtype=torch.int32), keys)
    return df, tpch.generate_device(0.01, seed=7, device=CPU)["lineitem"]


@pytest.mark.parametrize("name", list(sd.REQUESTS))
def test_strings_dt_requests_on_the_card_equal_cpu(dev, request_frames, name):
    def frames(device):
        return sd.prepare({t: ct.DataFrame({n: _moved(c, device) for n, c in f._table.items()})
                           for t, f in zip(("g1", "lineitem"), request_frames)})
    on_card, on_cpu = frames(dev), frames(CPU)
    got = sd.ANSWERS[name](sd.REQUESTS[name](on_card), on_card)
    exp = sd.ANSWERS[name](sd.REQUESTS[name](on_cpu), on_cpu)
    assert list(got) == list(exp)
    for k in exp:
        if exp[k].is_floating_point():
            assert torch.allclose(got[k].cpu(), exp[k], rtol=1e-9, atol=0), k
        else:
            assert torch.equal(got[k].cpu(), exp[k]), k
    plain = sd.PLAIN[name](on_card)
    for k in plain:
        assert torch.allclose(got[k].double(), plain[k].double(), rtol=1e-9, atol=0) \
            if plain[k].is_floating_point() else torch.equal(got[k], plain[k]), k
