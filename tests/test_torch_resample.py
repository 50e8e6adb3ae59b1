"""``frame/resample.py`` against pandas 3 within rtol 1e-12 (fault 1 of
ROADMAP.md §3: an empty resample bin sums and counts to 0, where the
reference gives NaN), and a frame's resample on a column against pandas
and the reference where it is right, over five seeded stamps.  The bins of
7 minutes and a day are in ``tests/test_torch_resample_long_bins.py``."""

import pandas as pd
import pytest

import torch_jax_cache  # noqa: F401  (the run's shared JAX compile cache)
import cudf_tpu as R
import cudf_tpu_torch as ct
from torch_windows_helpers import CPU, _close
from torch_resample_helpers import AGGS, _STAMPS, check_resample


@pytest.mark.parametrize("agg", AGGS)
@pytest.mark.parametrize("rule", ["20min", "h"])
def test_resample_matches_pandas(agg, rule):
    check_resample(agg, rule)


def test_resample_frame_on_a_column_and_the_reference_where_it_is_right():
    pdf = pd.DataFrame({"ts": _STAMPS, "a": [1, 2, 3, 4, 5], "b": [0.5, 1.5, 2.5, 3.5, 4.5]})
    df = ct.DataFrame.from_pandas(pdf, device=CPU)
    pd.testing.assert_frame_equal(df.resample("h", on="ts").sum().to_pandas(),
                                  pdf.resample("h", on="ts").sum(), check_freq=False)
    _close(df.resample("20min", on="ts")["b"].sum(), pdf.resample("20min", on="ts")["b"].sum(),
           0)
    _close(df.resample("20min", on="ts").b.mean(),
           R.DataFrame.from_pandas(pdf).resample("20min", on="ts").mean().to_pandas()["b"], 0)
    assert R.DataFrame.from_pandas(pdf).resample("20min", on="ts").sum().to_pandas()[
        "b"].isna().any()           # the reference's fault 1
