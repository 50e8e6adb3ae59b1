"""The port's device regex (``cudf_tpu_torch/ops/regex_engine.py``) and its
span consumers (``ops/string_spans.py``) against Python's ``re`` over the
UTF-8 rows of ``tests/test_torch_regex.py``: the predicates, the spans
and ``split(expand=True)``, where the reference matched ``.`` and
negated classes to one byte.  Every result exact."""

import re

import pytest

from cudf_tpu_torch.ops import strings as so
from torch_regex_helpers import MIXED, PATTERNS, port, python, values


@pytest.mark.parametrize("pat", PATTERNS + [r".{5}", r"[^x]+", r"a.b", r"^.$", r"ñ+",
                                            r"(?i)hello", r"[A-Z]"])
def test_predicates_match_python_on_utf8(pat):
    """``.`` and a negated class consume one whole character."""
    rx = re.compile(pat)
    before = so.STRING_ROUTES["host"]
    assert values(so.contains_re(port(MIXED), pat)) == python(MIXED, lambda s: bool(rx.search(s)))
    assert values(so.fullmatch_re(port(MIXED), pat)) == python(
        MIXED, lambda s: bool(rx.fullmatch(s)))
    unicode_aware = any(t in pat for t in ("\\d", "\\s", "\\w", "(?i)"))
    assert (so.STRING_ROUTES["host"] == before) != unicode_aware or not unicode_aware


@pytest.mark.parametrize("pat", [r"0+", r"\d+", r"[^a-z ]+", r".b", r"aa", r"é"])
def test_spans_match_python(pat):
    rx = re.compile(pat)
    assert values(so.replace_re(port(MIXED), pat, "#")) == python(MIXED, lambda s: rx.sub("#", s))
    assert values(so.count_re(port(MIXED), pat)) == python(MIXED, lambda s: len(rx.findall(s)))
    got = so.extract_re(port(MIXED), f"({pat})")
    assert [values(c) for c in got] == [python(MIXED, lambda s: (
        m.group(0) if (m := rx.search(s)) else None))]


@pytest.mark.parametrize("sep,regex,n", [("0000", False, 1), ("a", False, -1), (" ", False, 2),
                                         (r"\d+", True, -1), (r"[ñ ]", True, 1)])
def test_split_expand_matches_python(sep, regex, n):
    rx = re.compile(sep if regex else re.escape(sep))
    cols = so.split_expand(port(MIXED), sep, n, regex)
    parts = python(MIXED, lambda s: rx.split(s, maxsplit=max(n, 0)))
    width = max(len(p) for p in parts if p is not None)
    assert len(cols) == width
    for k, c in enumerate(cols):
        assert values(c) == [None if p is None or k >= len(p) else p[k] for p in parts]
