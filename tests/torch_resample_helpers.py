"""The resample check shared by tests/test_torch_resample.py and
tests/test_torch_resample_long_bins.py."""

import numpy as np
import pandas as pd

import cudf_tpu_torch as ct
from torch_windows_helpers import CPU, _close


AGGS = ["sum", "mean", "min", "max", "count", "first", "last", "std", "var", "median", "size"]
_STAMPS = pd.to_datetime(["2024-01-01 00:00", "2024-01-01 00:10", "2024-01-01 00:50",
                          "2024-01-01 02:05", "2024-01-01 02:07"])


def check_resample(agg, rule):
    """Fault 1: an empty bin sums (and counts) to 0, as in pandas."""
    ps = pd.Series([1.0, 2.0, 4.0, np.nan, 8.0], index=_STAMPS)
    got = getattr(ct.Series(ps, device=CPU).resample(rule), agg)().to_pandas()
    exp = getattr(ps.resample(rule), agg)()
    assert list(got.index) == list(exp.index)
    _close(got, exp, 1e-12)
