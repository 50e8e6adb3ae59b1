"""Every sort-tier groupby aggregation and ``nth`` (``cudf_tpu_torch/ops/
groupby.py`` ``make_grouper`` and its aggregations) against cudf_tpu's
sort tier on the JAX CPU backend and against pandas, over the module's
one frame grouped by (a, b) under dropna, with the tolerances of
``tests/test_torch_sort_groupby.py`` (counts, sizes, integer and bool
results exact; float64 rtol 1e-12; float32 within F32_RTOL); dtypes and
nulls are pandas'."""

import numpy as np
import pandas as pd
import pytest
import torch

import torch_jax_cache  # noqa: F401  (the run's shared JAX compile cache)
from cudf_tpu.ops import groupby as ref_gb
from cudf_tpu_torch.ops import groupby as gb
from torch_sort_groupby_helpers import (AGGS, F32_RTOL, REF_COLUMNS, _check_series, _port_column,
                                     _ref_column, groupers)


@pytest.mark.parametrize("agg", AGGS)
def test_sort_tier_aggs_match_reference_and_pandas(groupers, agg):
    """Every sort-tier agg of every value dtype, under a row mask (null
    and NaN keys dropped): values equal to the reference's sort tier on
    REF_COLUMNS, dtypes, values and nulls pandas' on all."""
    pdf, port, ref = groupers
    exp_pd = pdf.groupby(["a", "b"])
    for col in ("i", "f", "g", "t", "u", "s"):
        if agg == "quantile" and col == "t":
            continue                           # pandas refuses a bool quantile
        got = gb.aggregate(_port_column(pdf[col]), port, agg)
        g_np = got.to_numpy()
        if col in REF_COLUMNS[agg]:
            exp = ref_gb._AGG_DISPATCH.get(agg, ref_gb.group_quantile)(_ref_column(pdf[col]), ref)
            e_np = np.asarray(exp.to_numpy())
            if got.dtype.is_float:
                rtol = 1e-12 if got.data.dtype == torch.float64 else F32_RTOL
                np.testing.assert_allclose(g_np.astype(np.float64), e_np.astype(np.float64),
                                           rtol=rtol, equal_nan=True, err_msg=f"{agg} {col}")
            else:
                np.testing.assert_array_equal(g_np.astype(e_np.dtype), e_np,
                                              err_msg=f"{agg} {col}")
        want = getattr(exp_pd[col], agg)()
        _check_series(pd.Series(g_np), want.reset_index(drop=True), 1e-12, f"{agg} {col}")


def test_group_nth_matches_reference(groupers):
    """Each group's n-th kept row (from the end for n < 0), null where the
    group is shorter: the reference's values and nulls."""
    pdf, port, ref = groupers
    for col in ("i", "f"):
        for n in (0, 3, -1, -50):
            got = gb.group_nth(_port_column(pdf[col]), port, n)
            exp = ref_gb.group_nth(_ref_column(pdf[col]), ref, n)
            np.testing.assert_array_equal(got.to_numpy().astype(float),   # None -> NaN
                                          np.asarray(exp.to_numpy(), dtype=float),
                                          err_msg=f"{col} {n}")
