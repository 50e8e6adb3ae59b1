"""LIST columns' element access and the string splits that build them
(``ops/lists.py`` ``extract_list_element``, ``contains``, ``index_of``,
``count_elements``; ``str.split(expand=False)`` and ``str.findall``)
against the reference's (``cudf_tpu``, JAX on the CPU) and pandas, over
the seeded lists of ``tests/test_torch_lists_structs.py``; everything
exact."""

import numpy as np
import pandas as pd
import pytest

import torch_jax_cache  # noqa: F401  (the run's shared JAX compile cache)
import cudf_tpu as ref
from cudf_tpu.ops import lists as ref_lists
import cudf_tpu_torch as ct
from cudf_tpu_torch.ops import lists
from torch_lists_structs_helpers import CPU, TEXT, _lists, _norm, _pair, _same


def test_count_elements():
    r, p = _pair(_lists(1))
    _same(lists.count_elements(p), ref_lists.count_elements(r))


@pytest.mark.parametrize("index", [0, 1, 3, -1, -2, -7])
def test_extract_list_element(index):
    r, p = _pair(_lists(2))
    _same(lists.extract_list_element(p, index), ref_lists.extract_list_element(r, index))


@pytest.mark.parametrize("value", [0, 5, -20])
def test_contains_and_index_of(value):
    r, p = _pair(_lists(4))
    _same(lists.contains(p, value), ref_lists.contains(r, value))
    _same(lists.index_of(p, value), ref_lists.index_of(r, value))


def test_contains_strings():
    data = _lists(5, strings=True)
    r, p = _pair(data)
    _same(lists.contains(p, "s3"), ref_lists.contains(r, "s3"))


@pytest.mark.parametrize("pat,n", [(",", -1), (",", 1), (",,", -1), (None, -1)])
def test_split_lists_match_pandas(pat, n):
    text = TEXT + [" a  b c "]
    got = ct.Series(text, device=CPU).str.split(pat, n=n).to_pandas().tolist()
    exp = pd.Series(text, dtype=object).str.split(pat, n=n).tolist()
    assert got == [None if v is None or v is np.nan else v for v in exp]


def test_split_lists_on_the_device():
    from cudf_tpu_torch.ops.strings import STRING_ROUTES

    before = STRING_ROUTES["host"]
    s = ct.Series(TEXT, device=CPU).str.split(",")
    assert STRING_ROUTES["host"] == before
    assert s.dtype.is_list and s.dtype.value_type.is_string
    assert _norm(s.list.len().to_pandas().tolist()[:3]) == [4, None, 1]


@pytest.mark.parametrize("pat", [r"[1-9]+", r"\d", r"[a-z]+\d?", r"(\d)(\d)"])
def test_findall_matches_reference(pat):
    text = TEXT + ["id0000000123", "99 8 ", None]
    got = ct.Series(text, device=CPU).str.findall(pat).to_pandas().tolist()
    exp = pd.Series(text, dtype=object).str.findall(pat).tolist()
    # several groups: pandas' tuples are the port's lists (a LIST of LISTs)
    assert got == [None if v is None or v is np.nan else
                   [list(t) if isinstance(t, tuple) else t for t in v] for v in exp]
    if "(" not in pat:           # the reference's Arrow lists hold no tuples
        assert ref.Series(text).str.findall(pat)._column.to_pylist() == got
