"""``rank`` of the port's sort tier (``cudf_tpu_torch/ops/sort.py``) against
the reference's ``cudf_tpu/ops/sort.py`` on the JAX CPU backend, every
method, null placement and direction, on the seeded values of
``tests/test_torch_sort.py``, with its tolerances and its held faults."""

import numpy as np
import pandas as pd
import pytest

import torch_jax_cache  # noqa: F401  (the run's shared JAX compile cache)
from cudf_tpu.ops import sort as ref_sort
from cudf_tpu_torch.ops import sort as sort_ops
from torch_sort_helpers import N, _pair, _same, _values


@pytest.mark.parametrize("method", ["average", "min", "max", "first", "dense"])
@pytest.mark.parametrize("na_option", ["keep", "top", "bottom"])
@pytest.mark.parametrize("ascending", [True, False])
def test_rank_matches_reference(method, na_option, ascending):
    rng = np.random.default_rng(4)
    x, v = _values(rng, np.float64, distinct=20), rng.random(N) > 0.15
    x[np.isnan(x)] = 3.0                         # NaN is a value here; pandas nulls it
    ref, port = _pair(x, v)
    for pct in (False, True):
        got = sort_ops.rank(port, method, ascending, na_option, pct)
        exp = ref_sort.rank(ref, method, ascending, na_option, pct)
        if method == "dense" and pct and na_option == "keep":
            # the reference counts the null run among the dense ranks
            exp_pd = pd.Series(np.where(v, x, np.nan)).rank(
                method=method, ascending=ascending, na_option=na_option, pct=pct)
            np.testing.assert_allclose(got.to_numpy(), exp_pd.to_numpy(), rtol=1e-15)
            continue
        _same(got.data, exp.data, (method, na_option, pct))
        assert (got.validity is None) == (exp.validity is None)
        if got.validity is not None:
            _same(got.validity, exp.validity)
        exp_pd = pd.Series(np.where(v, x, np.nan)).rank(
            method=method, ascending=ascending, na_option=na_option, pct=pct)
        np.testing.assert_allclose(got.to_numpy(), exp_pd.to_numpy(), rtol=1e-15)
