"""Inputs and patterns shared by tests/test_torch_regex.py and
tests/test_torch_regex_python.py."""

import numpy as np
import torch

from cudf_tpu_torch.core.column import Column


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
