"""Fixed-size rolling windows (``frame/window.py``) against the reference
(JAX on the CPU) and a two-pass float64 variance: every aggregation, the
var and std, with the tolerances of ``tests/test_torch_windows.py``."""

import numpy as np
import pytest

import torch_jax_cache  # noqa: F401  (the run's shared JAX compile cache)
import cudf_tpu as R
import cudf_tpu_torch as ct
from torch_windows_helpers import CPU, REF_ATOL, _close, _two_pass, _values


@pytest.mark.parametrize("fn", ["sum", "mean", "min", "max", "count"])
@pytest.mark.parametrize("w,mp", [(1, None), (5, None), (5, 1), (13, 3), (300, 1)])
def test_fixed_windows_equal_the_reference(fn, w, mp):
    ps = _values()
    got = getattr(ct.Series(ps, device=CPU).rolling(w, min_periods=mp), fn)()
    exp = getattr(R.Series(ps).rolling(w, min_periods=mp), fn)()
    if fn == "count":          # pandas (and the port) count rows against min_periods
        exp = getattr(ps.rolling(w, min_periods=mp), fn)()
        _close(got, exp, 0)
        return
    _close(got, exp.to_pandas(), 1e-12, REF_ATOL)


@pytest.mark.parametrize("fn", ["var", "std"])
@pytest.mark.parametrize("w,mp", [(5, None), (13, 3), (300, 2)])
def test_fixed_var_std_equal_the_reference_and_two_pass(fn, w, mp):
    ps = _values()
    got = getattr(ct.Series(ps, device=CPU).rolling(w, min_periods=mp), fn)()
    _close(got, getattr(R.Series(ps).rolling(w, min_periods=mp), fn)().to_pandas(), 1e-9)
    hi = np.arange(1, len(ps) + 1)
    var = _two_pass(ps.to_numpy(), np.maximum(hi - w, 0), hi)
    cnt = ps.notna().rolling(w, min_periods=1).sum().to_numpy()
    var[cnt < (w if mp is None else mp)] = np.nan
    _close(got, var if fn == "var" else np.sqrt(var), 1e-9)
