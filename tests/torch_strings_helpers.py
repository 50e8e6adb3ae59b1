"""Inputs and comparisons shared by tests/test_torch_strings.py and
tests/test_torch_strings_python.py."""

import numpy as np
import torch

from cudf_tpu_torch.core.column import Column


CPU = torch.device("cpu")
WORDS = ["", "a", "ab", "Hello", "  pad me ", "abcabcab", "ñandú", "Ünïcödé wörld", "日本語",
         "x1y22z333", "id0000000123", "MiXeD CaSe", "\tspace\n", "-42", "+7", "ǅemo",
         "aaaa", "añb", "😀 ok"]


def _strings(seed, n=60):
    rng = np.random.default_rng(seed)
    out = [str(v) for v in rng.choice(WORDS, n)]
    for i in rng.choice(n, n // 10, replace=False):
        out[i] = None
    return out


VALS = _strings(0)


def port(vals):
    return Column.from_strings(vals, device=CPU)


def values(col):
    """A port column's rows as Python values, None where null."""
    if col.dtype.is_string:
        return col.host_strings()
    data = col.data.tolist()
    if col.validity is None:
        return data
    return [d if ok else None for d, ok in zip(data, col.validity.tolist())]


def python(vals, fn):
    return [None if v is None else fn(v) for v in vals]
