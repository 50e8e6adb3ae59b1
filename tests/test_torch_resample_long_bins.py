"""``frame/resample.py`` against pandas 3 within rtol 1e-12 over bins of 7
minutes and of a day, every aggregation (``tests/test_torch_resample.py``
holds the other bins and the frame's resample)."""

import pytest

from torch_resample_helpers import AGGS, check_resample


@pytest.mark.parametrize("agg", AGGS)
@pytest.mark.parametrize("rule", ["7min", "D"])
def test_resample_matches_pandas(agg, rule):
    check_resample(agg, rule)
