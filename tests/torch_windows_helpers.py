"""Inputs and comparisons shared by the window tests
(tests/test_torch_windows.py, test_torch_rolling_fixed.py,
test_torch_rolling_grouped.py, test_torch_resample.py)."""

import numpy as np
import pandas as pd


CPU = "cpu"


def _values(n=240, seed=0, scale=10.0, nan=True):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n) * scale + 3.0
    if nan:
        x[::11] = np.nan
    return pd.Series(x)


def _close(got, exp, rtol, atol=0.0):
    g = got.to_pandas() if hasattr(got, "to_pandas") else got
    np.testing.assert_allclose(np.asarray(g, float), np.asarray(exp, float), rtol=rtol,
                               atol=atol, equal_nan=True)


REF_ATOL = 1e-11      # the reference's prefix-sum rounding over these columns


def _two_pass(x, lo, hi, ddof=1):
    out = np.full(len(lo), np.nan)
    for i, (a, b) in enumerate(zip(lo, hi)):
        v = x[a:b]
        v = v[~np.isnan(v)]
        if len(v) > ddof:
            out[i] = np.var(v, ddof=ddof)
    return out
