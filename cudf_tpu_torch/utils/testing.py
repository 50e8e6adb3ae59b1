"""Test utilities (port of ``cudf_tpu/utils/testing.py``): differential
assertions against pandas, the reference's oracle (cudf.testing).

pandas is imported inside the functions only: the package imports
without it.
"""

from __future__ import annotations

import numpy as np


def assert_eq(left, right, check_dtype: bool = True, check_index: bool = True,
              check_names: bool = False, rtol: float = 1e-12, atol: float = 1e-12,
              sort_rows: bool = False):
    """Compare a cudf_tpu_torch object with a pandas one (or two of either
    kind): frames and series by pandas' testing functions, scalars by
    value (floats within rtol/atol, NaN equal to NaN; no pandas needed)."""
    from cudf_tpu_torch.frame.dataframe import DataFrame
    from cudf_tpu_torch.frame.index import Index
    from cudf_tpu_torch.frame.series import Series

    if isinstance(left, (DataFrame, Series, Index)):
        left = left.to_pandas()
    if isinstance(right, (DataFrame, Series, Index)):
        right = right.to_pandas()
    if not type(left).__module__.startswith("pandas"):
        _assert_scalars(left, right, rtol, atol)
        return
    import pandas as pd

    if isinstance(left, pd.DataFrame):
        if sort_rows:
            left = left.sort_values(list(left.columns)).reset_index(drop=True)
            right = right.sort_values(list(right.columns)).reset_index(drop=True)
        if not check_index:
            left = left.reset_index(drop=True)
            right = right.reset_index(drop=True)
        pd.testing.assert_frame_equal(left, right, check_dtype=check_dtype,
                                      check_names=check_names, rtol=rtol, atol=atol,
                                      check_like=False)
    elif isinstance(left, pd.Series):
        if sort_rows:
            left = left.sort_values().reset_index(drop=True)
            right = right.sort_values().reset_index(drop=True)
        if not check_index:
            left = left.reset_index(drop=True)
            right = right.reset_index(drop=True)
        pd.testing.assert_series_equal(left, right, check_dtype=check_dtype,
                                       check_names=check_names, rtol=rtol, atol=atol)
    elif isinstance(left, pd.Index):
        pd.testing.assert_index_equal(left, right, check_names=check_names)
    else:
        _assert_scalars(left, right, rtol, atol)


def _assert_scalars(left, right, rtol, atol):
    if isinstance(left, float) and isinstance(right, float) and np.isnan(left):
        assert np.isnan(right), f"{left} != {right}"
    elif isinstance(left, (float, np.floating)) or isinstance(right, (float, np.floating)):
        assert np.isclose(left, right, rtol=rtol, atol=atol, equal_nan=True), \
            f"{left} != {right}"
    else:
        assert left == right, f"{left!r} != {right!r}"


def make_random_frame(n: int, seed: int = 0, nulls: bool = True, strings: bool = True, *,
                      device="cuda"):
    """(cudf_tpu_torch.DataFrame on ``device``, pandas.DataFrame) with the
    same content: the reference's columns and draws for the same seed."""
    import pandas as pd

    from cudf_tpu_torch.frame.dataframe import DataFrame

    rng = np.random.default_rng(seed)
    data = {
        "i64": rng.integers(-1000, 1000, n),
        "i32": rng.integers(-100, 100, n).astype(np.int32),
        "f64": rng.normal(size=n),
        "f32": rng.normal(size=n).astype(np.float32),
        "b": rng.integers(0, 2, n).astype(bool),
        "k": rng.integers(0, max(n // 10, 1), n),
    }
    pdf = pd.DataFrame(data)
    if strings:
        pool = ["apple", "banana", "cherry", "", "date_x", "elderberry", "fig", "grape"]
        pdf["s"] = rng.choice(pool, n)
    if nulls:
        mask = rng.random(n) < 0.15
        pdf.loc[mask, "f64"] = np.nan
        if strings:
            mask2 = rng.random(n) < 0.1
            pdf.loc[mask2, "s"] = None
    return DataFrame.from_pandas(pdf, device=device), pdf
