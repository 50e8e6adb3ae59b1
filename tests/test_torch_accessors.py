"""``Series.str``, ``.dt`` and ``.cat`` of the port
(``cudf_tpu_torch/frame/accessors.py``) and the string entry points of
``frame/tools.py`` against the reference's ``cudf_tpu`` Series accessors
on the JAX CPU backend and against pandas 3, on the same seeded data
(every ``str`` and ``dt`` call against pandas alone is in
``tests/test_torch_str_pandas.py`` and ``tests/test_torch_dt_pandas.py``).

Held to pandas where the reference is wrong (ROADMAP.md §3): ``str.get``
past a row's end (null), ``to_numeric(errors="coerce")`` of text that is
no number (NaN; the reference raises), ``dt.is_*`` of NaT (False),
``cat.codes`` (the narrowest signed integer; the reference gives int64),
``.`` over UTF-8 in the regex predicates.  Every value and null exact;
predicates of a missing value False (pandas 3's ``str`` dtype).
"""

import numpy as np
import pandas as pd
import pytest
import torch

import torch_jax_cache  # noqa: F401  (the run's shared JAX compile cache)
import cudf_tpu
import cudf_tpu_torch as ct
from cudf_tpu_torch.ops.strings import STRING_ROUTES
from torch_accessors_helpers import DT, DT_CALLS, STR_CALLS, TEXT, ours, same

torch.set_num_threads(1)


ASCII = TEXT.where(TEXT.map(lambda v: v is None or (isinstance(v, str) and v.isascii())))


@pytest.mark.parametrize("name", ["len", "upper", "slice", "contains_literal", "startswith",
                                  "find", "replace_literal", "pad", "zfill", "isdigit"])
def test_str_matches_reference(name):
    """Over ASCII text, where the reference is right."""
    fn = STR_CALLS[name]
    got = fn(ours(ASCII)).to_pandas()
    ref = fn(cudf_tpu.Series(ASCII)).to_pandas()
    assert got.astype(object).where(got.notna(), None).tolist() == \
        ref.astype(object).where(ref.notna(), None).tolist()


def test_nullable_string_results_are_nullable():
    s = TEXT.astype("string")
    for name in ("len", "upper", "contains_literal", "find"):
        got, exp = STR_CALLS[name](ours(s)).to_pandas(), STR_CALLS[name](s)
        pd.testing.assert_series_equal(got, exp, check_names=False)


def test_reference_faults_held_to_pandas():
    s = pd.Series(["ab", None, "ñandú"])
    assert ours(s).str.get(4).to_pandas().tolist()[0] != ours(s).str.get(4).to_pandas().tolist()[0]
    assert cudf_tpu.Series(s).str.get(4).to_pandas().tolist()[0] == ""        # reference: ""
    assert ours(s).str.fullmatch(r".{5}").to_pandas().tolist() == [False, False, True]
    assert ours(s).str.count(r".").to_pandas().tolist()[2] == 5
    num = pd.Series(["1", "abc", None, "3.5"])
    got = ct.to_numeric(ours(num), errors="coerce").to_pandas()
    pd.testing.assert_series_equal(got, pd.to_numeric(num, errors="coerce"))
    with pytest.raises(ValueError):
        cudf_tpu.to_numeric(cudf_tpu.Series(num), errors="coerce")           # reference raises
    cats = pd.Series(["x", "y", None, "x"], dtype="category")
    codes = ours(cats).cat.codes.to_pandas()
    pd.testing.assert_series_equal(codes, cats.cat.codes)
    assert codes.dtype == np.int8 and cudf_tpu.Series(cats).cat.codes.to_pandas().dtype == np.int64


def test_to_numeric_and_astype():
    s = pd.Series(["12", "-3", "0007"])
    pd.testing.assert_series_equal(ct.to_numeric(ours(s)).to_pandas(), pd.to_numeric(s))
    f = pd.Series(["1.5", "-2e3", " 4 ", None])
    pd.testing.assert_series_equal(ct.to_numeric(ours(f)).to_pandas(), pd.to_numeric(f))
    with pytest.raises(ValueError, match='Unable to parse string "x" at position 1'):
        ct.to_numeric(ours(pd.Series(["1", "x"])))
    assert ct.to_numeric(ours(pd.Series(["1", "x"])), errors="ignore").to_pandas().tolist() == \
        ["1", "x"]
    pd.testing.assert_series_equal(ours(s).astype("int64").to_pandas(), s.astype("int64"))
    pd.testing.assert_series_equal(ours(s).astype("float32").to_pandas(), s.astype("float32"))
    with pytest.raises(ValueError):
        ours(pd.Series(["1", "x"])).astype("int64")
    ints = pd.Series([1, -20, 300], dtype="int32")
    pd.testing.assert_series_equal(ours(ints).astype(str).to_pandas(), ints.astype(str))
    text = pd.Series(["2020-01-05", "1999-12-31 23:59:59"])
    pd.testing.assert_series_equal(ours(text).astype("datetime64[ns]").to_pandas(),
                                   text.astype("datetime64[ns]"))


def test_string_concat_and_map():
    a, b = pd.Series(["x", None, "z"]), pd.Series(["1", "2", None])
    same(ours(a) + "_" + ours(b), a + "_" + b)
    same("<" + ours(a), "<" + a)
    same(ours(a.astype("category")) + ours(b), a.astype("category").astype(str).where(
        a.notna()) + b)
    keys = pd.Series(["x", "y", "x", None])
    same(ours(keys).map({"x": 1, "y": 2}), keys.map({"x": 1, "y": 2}))


@pytest.mark.parametrize("name", ["year", "month", "hour", "dayofyear", "floor", "ceil",
                                  "tz_hour"])
def test_dt_matches_reference(name):
    fn = DT_CALLS[name]
    got = fn(ours(DT)).to_pandas()
    ref = fn(cudf_tpu.Series(DT)).to_pandas()
    assert got.astype(object).where(got.notna(), None).tolist() == \
        ref.astype(object).where(ref.notna(), None).tolist()


def test_durations_match_pandas():
    td = pd.Series(pd.to_timedelta([1.5, -1, 90061, None], unit="s"))
    for fn in (lambda s: s.dt.days, lambda s: s.dt.seconds, lambda s: s.dt.total_seconds(),
               lambda s: s.astype(str)):
        same(fn(ours(td)), fn(td))


def test_cat_accessor():
    cats = pd.Series(["b", "a", None, "b"], dtype="category")
    s = ours(cats)
    assert s.cat.categories.to_pandas().tolist() == ["a", "b"]
    same(s.cat.add_categories(["c"]).cat.codes, cats.cat.add_categories(["c"]).cat.codes)
    same(s.cat.set_categories(["b", "z"]), cats.cat.set_categories(["b", "z"]))
    with pytest.raises(AttributeError):
        ours(pd.Series([1, 2])).cat
    with pytest.raises(AttributeError):
        ours(pd.Series([1, 2])).str
    with pytest.raises(AttributeError):
        ours(pd.Series(["a"])).dt


def test_every_accessor_call_stays_on_the_device_route():
    before = STRING_ROUTES["host"]
    s = ours(pd.Series(["id0000000123", "id0000004567", None]))
    s.str.len(), s.str.upper(), s.str.contains(r"^id0+[1-9]\d{2}$"), s.str.slice(2)
    s.str.replace(r"0+", "-", regex=True), s.str.split("0000", n=1, expand=True)
    ct.to_numeric(s.str.slice(2), errors="coerce"), s.str.slice(0, 8).astype("category")
    assert STRING_ROUTES["host"] == before
