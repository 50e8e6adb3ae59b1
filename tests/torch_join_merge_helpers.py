"""Frames and comparisons shared by tests/test_torch_join_merge.py and
tests/test_torch_merge_pandas.py."""

import numpy as np
import pandas as pd
import torch


CPU = torch.device("cpu")


NL, NR = 40, 30


def _frames(seed, nulls=False):
    rng = np.random.default_rng(seed)
    left = pd.DataFrame({"k": rng.integers(0, 8, NL), "j": rng.integers(0, 2, NL),
                         "s": rng.choice(["p", "q", "rr"], NL), "v": rng.normal(size=NL)})
    right = pd.DataFrame({"k": rng.integers(2, 11, NR), "j": rng.integers(0, 2, NR),
                          "s": rng.choice(["p", "rr", "t"], NR), "w": rng.normal(size=NR)})
    if nulls:
        left["v"] = left["v"].where(rng.random(NL) > 0.2)
        left["k"] = left["k"].astype(float).where(rng.random(NL) > 0.2)
        right["k"] = right["k"].astype(float).where(rng.random(NR) > 0.2)
    return left, right


def _pandas(df):
    out = df.to_pandas()
    for c in out.columns:
        if out[c].dtype == object or isinstance(out[c].dtype, pd.StringDtype):
            out[c] = out[c].astype(object)
    return out


def _norm(df):
    out = df.copy()
    for c in out.columns:
        if out[c].dtype.kind in "iu":
            out[c] = out[c].astype(float)
        elif out[c].dtype.kind not in "fb":
            out[c] = out[c].astype(object).where(out[c].notna(), None)
    return out


def _check(got, exp, ordered=True):
    got, exp = _norm(_pandas(got)), _norm(exp)
    assert list(got.columns) == list(exp.columns)
    if not ordered:
        got = got.sort_values(list(got.columns), na_position="last").reset_index(drop=True)
        exp = exp.sort_values(list(exp.columns), na_position="last").reset_index(drop=True)
    pd.testing.assert_frame_equal(got.reset_index(drop=True), exp.reset_index(drop=True),
                                  check_exact=True, check_dtype=False)
