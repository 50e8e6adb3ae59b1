"""``ops/copying.py`` ``shift`` and ``ops/replace.py`` ``ffill``/``bfill``
against the reference's functions on the JAX CPU backend, on the seeded
columns of ``tests/test_torch_column_ops.py`` (the port's columns built
over the reference columns' buffers), every dtype, with and without a
fill value and a limit.  Integer, bool, temporal and string results
exact; float results rtol 1e-12; nulls in the same rows."""

import numpy as np
import pandas as pd
import pytest

import torch_jax_cache  # noqa: F401  (the run's shared JAX compile cache)
from cudf_tpu.ops import copying as ref_copying
from cudf_tpu.ops import replace as ref_replace
from cudf_tpu_torch.ops import copying, replace
from torch_column_ops_helpers import assert_same, cols


@pytest.mark.parametrize("name", ["i32", "f64", "bool", "ts", "dict", "str"])
@pytest.mark.parametrize("periods,fill", [(3, None), (-2, None), (2, 7)])
def test_shift_matches_reference(cols, name, periods, fill):
    ref, port = cols
    if fill is not None and name in ("dict", "str", "ts", "bool"):
        fill = {"dict": "AIR", "str": "q", "ts": np.datetime64("1999-01-01", "ns"),
                "bool": True}[name]
        if name in ("dict", "str", "ts"):
            got = pd.Series(copying.shift(port[name], periods, fill).to_numpy())
            exp = pd.Series(port[name].to_numpy()).shift(periods, fill_value=fill)
            pd.testing.assert_series_equal(got, exp, check_dtype=False)
            return
    assert_same(copying.shift(port[name], periods, fill),
                ref_copying.shift(ref[name], periods, fill))


@pytest.mark.parametrize("name", ["i32", "f64", "bool", "ts", "dict", "str"])
@pytest.mark.parametrize("limit", [None, 1])
def test_ffill_bfill_match_reference(cols, name, limit):
    ref, port = cols
    assert_same(replace.ffill(port[name], limit), ref_replace.ffill(ref[name], limit))
    assert_same(replace.bfill(port[name], limit), ref_replace.bfill(ref[name], limit))
