"""Frames and comparisons shared by tests/test_torch_groupby_slice.py and
tests/test_torch_groupby_spec.py."""

import numpy as np
import pandas as pd
import torch

import cudf_tpu_torch as ct


CPU = torch.device("cpu")
N = 20_000


F32_RTOL, F32_ATOL = 1e-5, 1e-6


def _frame(seed, K, null_frac=0.2, all_null_groups=False):
    """k int64 keys (offset 7); f float64 in [0, 100) like G1's v3 and g
    float32, both with nulls; i int64 below 2^23 in magnitude; b bool.
    Unless all_null_groups, every group keeps one valid f and g (nulls
    only on repeated keys)."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, K, N) + 7
    pdf = pd.DataFrame({
        "k": k,
        "f": rng.uniform(0, 100, N).astype(np.float32).astype(np.float64),
        "g": rng.normal(size=N).astype(np.float32),
        "i": rng.integers(-2**23, 2**23, N),
        "b": rng.random(N) > 0.5,
    })
    nulls = rng.random(N) < null_frac
    if not all_null_groups:
        nulls &= pdf.k.duplicated().to_numpy()
    pdf.loc[nulls, "f"] = np.nan
    pdf.loc[nulls, "g"] = np.nan
    return pdf


def _port(pdf, spec, **kw):
    return ct.from_pandas(pdf, device=CPU).groupby("k", **kw).agg(spec).to_pandas()


def _assert_frames(got, exp, rtol):
    """Index and integer/bool columns exact; float columns of the same
    width, to rtol (float32 ones to F32_RTOL and F32_ATOL at least), NaN
    in the same places."""
    np.testing.assert_array_equal(got.index.to_numpy(), exp.index.to_numpy())
    assert list(got.columns) == list(exp.columns)
    for col in exp.columns:
        g, e = got[col].to_numpy(), exp[col].to_numpy()
        if e.dtype.kind == "f":
            assert g.dtype == e.dtype, col
            rt, at = (max(rtol, F32_RTOL), F32_ATOL) if e.dtype == np.float32 else (rtol, 0)
            np.testing.assert_allclose(g, e, rtol=rt, atol=at, equal_nan=True,
                                       err_msg=str(col))
        else:
            assert g.dtype == e.dtype, col
            np.testing.assert_array_equal(g, e, err_msg=str(col))
