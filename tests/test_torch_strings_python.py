"""The port's string ops (``cudf_tpu_torch/ops/strings.py``) against Python's
own ``str`` methods on every row of the seeded strings of
``tests/test_torch_strings.py``, non-ASCII ones included, and ``get``
past a row's end against pandas (null; the reference's slice gives "").
Every result exact."""

import pytest

import torch_jax_cache  # noqa: F401  (the run's shared JAX compile cache)
from cudf_tpu.core.column import Column as RefColumn
from cudf_tpu.ops import strings as ref_str
from cudf_tpu_torch.ops import strings as so
from torch_strings_helpers import VALS, port, python, values


PY_CASES = {
    "length": (so.length, (), len),
    "upper": (so.upper, (), str.upper),
    "lower": (so.lower, (), str.lower),
    "title": (so.title, (), str.title),
    "capitalize": (so.capitalize, (), str.capitalize),
    "swapcase": (so.swapcase, (), str.swapcase),
    "strip": (so.strip, (), str.strip),
    "rstrip_chars": (so.strip, ("ú ", "right"), lambda s: s.rstrip("ú ")),
    "slice_1_4": (so.slice_strings, (1, 4), lambda s: s[1:4]),
    "slice_step": (so.slice_strings, (None, None, 2), lambda s: s[::2]),
    "find_n": (so.find_literal, ("n",), lambda s: s.find("n")),
    "rfind_ö": (so.find_literal, ("ö", True), lambda s: s.rfind("ö")),
    "contains_ñ": (so.contains_literal, ("ñ",), lambda s: "ñ" in s),
    "count_aa": (so.count_literal, ("aa",), lambda s: s.count("aa")),
    "center": (so.pad, (9, "both", "é"), lambda s: s.center(9, "é")),
    "ljust": (so.pad, (8, "right", "-"), lambda s: s.ljust(8, "-")),
    "zfill": (so.zfill, (5,), lambda s: s.zfill(5)),
    **{k: (getattr(so, k), (), getattr(str, k)) for k in (
        "isdigit", "isdecimal", "isnumeric", "isalpha", "isalnum", "isspace", "isupper",
        "islower")},
}


@pytest.mark.parametrize("name", list(PY_CASES))
def test_ops_match_python_on_unicode(name):
    """Every row, non-ASCII ones included, against Python's str."""
    ours, args, fn = PY_CASES[name]
    assert values(ours(port(VALS), *args)) == python(VALS, fn)


@pytest.mark.parametrize("i", [0, 2, -1, -3, 7])
def test_get_past_the_end_is_null_as_pandas(i):
    """The reference's get(i) is a slice: "" past the end, where pandas
    (and the port) give null."""
    exp = python(VALS, lambda s: s[i] if -len(s) <= i < len(s) else None)
    assert values(so.get(port(VALS), i)) == exp
    ref = ref_str.get(RefColumn.from_strings(["ab"]), 5).to_pylist()
    assert ref == [""]                                  # the reference's fault
