"""Centred and grouped rolling windows (``frame/window.py``): fault 2 of
ROADMAP.md §3 (a centred window computes the column's tail, where the
reference leaves the last (w - 1) // 2 rows NaN) held to pandas 3, and
``groupby(...).rolling`` against pandas and the reference, with the
tolerances of ``tests/test_torch_windows.py``."""

import numpy as np
import pandas as pd
import pytest

import torch_jax_cache  # noqa: F401  (the run's shared JAX compile cache)
import cudf_tpu as R
import cudf_tpu_torch as ct
from torch_windows_helpers import CPU, REF_ATOL, _close, _values


@pytest.mark.parametrize("w", [4, 5, 50])
@pytest.mark.parametrize("fn", ["sum", "mean", "max", "count"])
def test_fault_2_centred_windows_compute_the_tail(w, fn):
    ps = _values(60, 1)
    got = getattr(ct.Series(ps, device=CPU).rolling(w, min_periods=1, center=True), fn)()
    _close(got, getattr(ps.rolling(w, min_periods=1, center=True), fn)(), 1e-9)
    six = pd.Series(np.arange(1.0, 7.0))
    assert ct.Series(six, device=CPU).rolling(4, min_periods=1, center=True).sum().tolist()[-1] \
        == 15.0


@pytest.mark.parametrize("fn", ["sum", "mean", "min", "max", "count", "var", "std"])
def test_grouped_rolling_equals_pandas_and_the_reference(fn):
    rng = np.random.default_rng(7)
    pdf = pd.DataFrame({"k": rng.integers(0, 5, 200), "v": _values(200, 8).to_numpy(),
                        "w": rng.normal(size=200)})
    df = ct.DataFrame.from_pandas(pdf, device=CPU)
    got = getattr(df.groupby("k")["v"].rolling(4, min_periods=2), fn)().to_pandas()
    exp = getattr(pdf.groupby("k")["v"].rolling(4, min_periods=2), fn)()
    assert list(got.index) == list(exp.index)
    _close(got, exp, 1e-9)
    if fn != "count":
        ref = getattr(R.DataFrame.from_pandas(pdf).groupby("k")["v"].rolling(
            4, min_periods=2), fn)().to_pandas()
        _close(got, ref, 1e-12 if fn not in ("var", "std") else 1e-9, REF_ATOL)
    frame = getattr(df.groupby("k").rolling(3), fn)().to_pandas()
    pexp = getattr(pdf.groupby("k").rolling(3), fn)()
    assert list(frame.columns) == list(pexp.columns) == ["v", "w"]
    _close(frame["w"], pexp["w"], 1e-9)
