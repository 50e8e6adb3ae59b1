"""Two faults of the port, each held to pandas 3 (or to the ROADMAP.md
line it names):

1. ``dt.strftime`` raised on directives the reference answers (it formats
   through pandas on the host): %w %u %U %W %G %V %z %Z %c %x %X now have
   device fields, a directive outside Python's documented set takes the
   counted host route;
2. interval, period and sparse columns, which the reference lacks too,
   named ROADMAP.md queue 1, item 6c instead of "beyond the reference".
"""

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

import cudf_tpu_torch as ct
from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.ops.strings import STRING_ROUTES

torch.set_num_threads(1)

CPU = "cpu"
STAMPS = ["2024-01-07", "2021-01-03 13:05:09.123456", "2020-12-31 23:59:59", None,
          "1999-01-01", "2027-01-01 07:00", "2008-12-29"]


def _stamps(tz=None):
    s = pd.Series(pd.to_datetime(STAMPS, format="ISO8601"))
    return s.dt.tz_localize(tz) if tz else s


# 1 -------------------------------------------------------------------
def test_the_week_directives_and_c_of_a_sunday():
    got = ct.Series(_stamps(), device=CPU).dt.strftime("%U %W %u %w %G-%V %c")
    assert got.tolist()[0] == "01 01 7 0 2024-01 Sun Jan  7 00:00:00 2024"


@pytest.mark.parametrize("fmt", ["%U %W %u %w", "%G-%V", "%c", "%x %X", "%Y %z%Z",
                                 "%j %U-%W %a"])
def test_strftime_directives_match_pandas_on_the_device(fmt):
    before = STRING_ROUTES["host"]
    got = ct.Series(_stamps(), device=CPU).dt.strftime(fmt).to_pandas()
    pd.testing.assert_series_equal(got, _stamps().dt.strftime(fmt), check_dtype=False)
    assert STRING_ROUTES["host"] == before


@pytest.mark.parametrize("fmt", ["%Y-%m-%d %H:%M %z %Z", "%c %Z", "%z"])
def test_zone_directives_match_pandas(fmt):
    s = _stamps("America/New_York")
    got = ct.Series(s, device=CPU).dt.strftime(fmt).to_pandas()
    pd.testing.assert_series_equal(got, s.dt.strftime(fmt), check_dtype=False)


def test_directive_outside_pythons_set_takes_the_counted_host_route():
    before = STRING_ROUTES["host"]
    got = ct.Series(_stamps(), device=CPU).dt.strftime("%e|%D").to_pandas()
    pd.testing.assert_series_equal(got, _stamps().dt.strftime("%e|%D"), check_dtype=False)
    assert STRING_ROUTES["host"] == before + 1


# 2 -------------------------------------------------------------------
def test_interval_period_and_sparse_columns_name_beyond_the_reference():
    with pytest.raises(NotImplementedError, match="beyond the reference"):
        Column.from_pandas(pd.Series(pd.arrays.IntervalArray.from_breaks([0, 1, 2])),
                           device=CPU)
    with pytest.raises(NotImplementedError, match="beyond the reference"):
        Column.from_pandas(pd.Series(pd.period_range("2024-01", periods=3, freq="M")),
                           device=CPU)
    with pytest.raises(NotImplementedError, match="beyond the reference"):
        Column.from_pandas(pd.Series(pd.arrays.SparseArray([0, 1, 0])), device=CPU)
    with pytest.raises(NotImplementedError, match="beyond the reference"):
        Column(dt.DType(dt.TypeId.INTERVAL), 2, torch.zeros(2, dtype=torch.int64))
    with pytest.raises(NotImplementedError, match="beyond the reference"):
        Column.from_arrow(pa.array([(1, 2, 3)], pa.month_day_nano_interval()), device=CPU)
