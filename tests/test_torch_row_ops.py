"""The row operators of the port's sort tier (``cudf_tpu_torch/ops/row_ops.py``:
order and equality operands and ``row_hash``) against the reference's
``cudf_tpu/ops/row_ops.py`` on the JAX CPU backend, every dtype with and
without nulls, on the seeded values of ``tests/test_torch_sort.py``,
with its tolerances."""

import numpy as np
import pytest
import torch

import torch_jax_cache  # noqa: F401  (the run's shared JAX compile cache)
from cudf_tpu.ops import row_ops as ref_row_ops
from cudf_tpu_torch.ops import row_ops
from torch_sort_helpers import DTYPES, N, _pair, _same, _values


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("nulls", [False, True])
def test_row_operands_and_hash_match_reference(dtype, nulls):
    """order_keys (both directions, nulls first and last), equality_keys
    and row_hash equal the reference's operand for operand, bit for bit."""
    rng = np.random.default_rng(1)
    x = _values(rng, dtype)
    valid = rng.random(N) > 0.2 if nulls else None
    ref, port = _pair(x, valid)
    for asc in (True, False):
        for na in ("first", "last"):
            got = row_ops.order_keys(port, asc, na)
            exp = ref_row_ops.order_keys(ref, asc, na)
            assert len(got) == len(exp)
            for g, e in zip(got, exp):
                _same(g, e, (asc, na))
    for g, e in zip(row_ops.equality_keys(port), ref_row_ops.equality_keys(ref)):
        e = np.asarray(e)
        _same(g, e.view(np.int64) if e.dtype == np.uint64 else
              e.astype(np.int64) if e.dtype in (np.uint16, np.uint32) else e)
    for seed in (0, 7):
        _same(row_ops.row_hash([port], seed).view(torch.uint64).numpy().astype(np.uint64),
              ref_row_ops.row_hash([ref], seed))
        _same(row_ops.hash_column(port, seed), row_ops.row_hash([port], seed))
