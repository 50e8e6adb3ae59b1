"""The port's device regex (``cudf_tpu_torch/ops/regex_engine.py``: the
host DFA compiler and the device scan) and its span consumers
(``ops/string_spans.py``: replace, count, extract, split) against the
reference's ``cudf_tpu/ops/regex_engine.py`` / ``string_spans.py`` on the
JAX CPU backend over ASCII rows, and against Python's ``re`` over UTF-8
rows, where the reference matched ``.`` and negated classes to one byte
(``fullmatch(".{5}")`` of "ñandú" False, ``count(".")`` 7).

Every result exact.  Patterns the engine refuses (backreferences,
lookaround, lazy repeats in span mode) take the host route, which
``STRING_ROUTES`` counts.
"""

import re

import numpy as np
import pytest
import torch

from cudf_tpu.core.column import Column as RefColumn
from cudf_tpu.ops import strings as ref_str
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.ops import regex_engine as rex
from cudf_tpu_torch.ops import strings as so

torch.set_num_threads(1)

CPU = torch.device("cpu")
ASCII_WORDS = ["", "a", "ab", "abc", "aXb", "id0000000123", "id0001000000", "x1y22z333",
               "foo bar", "FOO", "a.b", "0000", "zz9", "hello world", "tab\tbed"]
UTF8_WORDS = ["ñandú", "añb", "HeLLo ñ", "日本語テキスト", "naïve café", "a😀b", "ñ", "über 9"]


def _strings(words, seed, n=48):
    rng = np.random.default_rng(seed)
    out = [str(v) for v in rng.choice(words, n)]
    for i in rng.choice(n, n // 8, replace=False):
        out[i] = None
    return out


ASCII = _strings(ASCII_WORDS, 1)
MIXED = _strings(ASCII_WORDS + UTF8_WORDS, 2)


def port(vals):
    return Column.from_strings(vals, device=CPU)


def values(col):
    if col.dtype.is_string:
        return col.host_strings()
    data = col.data.tolist()
    if col.validity is None:
        return data
    return [d if ok else None for d, ok in zip(data, col.validity.tolist())]


def python(vals, fn):
    return [None if v is None else fn(v) for v in vals]


PATTERNS = [r"a.b", r"^id0+[1-9]\d{2}$", r"\d+", r"[a-c]+", r"(foo|bar)", r"o{2,}",
            r"[^a-z]", r"z$", r"^a", r"x\d?y", r"\s\w+"]


@pytest.mark.parametrize("pat", PATTERNS)
def test_predicates_match_reference_on_ascii(pat):
    col, ref = port(ASCII), RefColumn.from_strings(ASCII)
    for ours, theirs in ((so.contains_re, ref_str.contains_re), (so.match_re, ref_str.match_re),
                         (so.fullmatch_re, ref_str.fullmatch_re)):
        assert values(ours(col, pat)) == theirs(ref, pat).to_pylist(), ours.__name__


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


def test_utf8_faults_of_the_reference():
    """pandas: fullmatch(".{5}") of "ñandú" True, contains("a.b") of "añb"
    True, count(".") of "ñandú" 5; the reference: False, False, 7."""
    col = port(["ñandú", "añb"])
    assert values(so.fullmatch_re(col, r".{5}")) == [True, False]
    assert values(so.contains_re(col, r"a.b")) == [False, True]
    assert values(so.count_re(col, r".")) == [5, 3]
    ref = RefColumn.from_strings(["ñandú", "añb"])
    assert ref_str.fullmatch_re(ref, r".{5}").to_pylist() == [False, False]
    assert ref_str.count_re(ref, r".").to_pylist()[0] == 7


SPAN_PATTERNS = [r"0+", r"\d+", r"[a-c]", r"o{2}", r"ab|b"]


@pytest.mark.parametrize("pat", SPAN_PATTERNS)
def test_spans_match_reference_on_ascii(pat):
    col, ref = port(ASCII), RefColumn.from_strings(ASCII)
    assert values(so.replace_re(col, pat, "-")) == ref_str.replace_re(ref, pat, "-").to_pylist()
    assert values(so.replace_re(col, pat, "<>", n=1)) == \
        ref_str.replace_re(ref, pat, "<>", n=1).to_pylist()
    assert values(so.count_re(col, pat)) == ref_str.count_re(ref, pat).to_pylist()


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


def test_split_matches_reference_on_ascii():
    cols = so.split_expand(port(ASCII), "0", 2)
    ref = ref_str.split_expand(RefColumn.from_strings(ASCII), "0", 2)
    assert [values(c) for c in cols] == [c.to_pylist() for c in ref]


def test_unsupported_patterns_take_the_counted_host_route():
    for pat in (r"(a)\1", r"a(?=b)", r"(?<!x)b"):
        with pytest.raises(rex.Unsupported):
            rex.compile_dfa(pat)
        before = so.STRING_ROUTES["host"]
        rx = re.compile(pat)
        assert values(so.contains_re(port(ASCII), pat)) == \
            python(ASCII, lambda s: bool(rx.search(s)))
        assert so.STRING_ROUTES["host"] == before + 1
    assert values(so.replace_re(port(["aaab"]), r"a+?", "-")) == ["---b"]   # lazy: the host


def test_dfa_tables_are_small_and_cached():
    d = rex.compile_dfa(r"^id0+[1-9]\d{2}$", 0, search=True)
    assert d is rex.compile_dfa(r"^id0+[1-9]\d{2}$", 0, search=True)
    assert d.classes <= 8 and d.table.shape[0] == d.classes * d.accept.shape[0]
    assert d.anchor_start and d.anchor_end and d.unicode
    spans = rex.match_spans(port(["a00b0", "000"]), r"0+")
    assert spans.tolist() == [0, 2, 1, 0, 1, 3, 2, 1]


def test_inline_flags_are_honoured():
    """``(?i)`` in the pattern: the reference compiled it case-sensitive
    (``contains("(?i)hello")`` of "HELLO" False); pandas and the port True."""
    col = port(["HELLO", "hello", "help"])
    assert values(so.contains_re(col, r"(?i)hello")) == [True, True, False]
    assert values(so.contains_re(col, r"(?a)\w+o$")) == [False, True, False]
    assert ref_str.contains_re(RefColumn.from_strings(["HELLO"]), r"(?i)hello").to_pylist() == \
        [False]
