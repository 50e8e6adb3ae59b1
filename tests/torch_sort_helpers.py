"""Inputs and comparisons shared by tests/test_torch_sort.py,
test_torch_sort_rank.py and test_torch_row_ops.py."""

import numpy as np
import torch

from cudf_tpu.core.column import Column as RefColumn
import cudf_tpu_torch as ct


CPU = torch.device("cpu")
N = 257
INTS = [np.int8, np.int16, np.int32, np.int64, np.uint8, np.uint16, np.uint32, np.uint64]
DTYPES = INTS + [np.float32, np.float64, np.bool_]
SPECIALS = [np.nan, 0.0, -0.0, np.inf, -np.inf]


def _values(rng, dtype, n=N, distinct=None):
    """Seeded values of dtype: ints over their whole range (or a few
    values), floats with NaN, +-0.0 and +-inf, bools."""
    dtype = np.dtype(dtype)
    if dtype == np.bool_:
        return rng.random(n) > 0.5
    if dtype.kind in "iu":
        info = np.iinfo(dtype)
        if distinct:
            return rng.integers(0, distinct, n).astype(dtype)
        return rng.integers(int(info.min), int(info.max), n, dtype=dtype, endpoint=True)
    x = (rng.normal(size=n) * 1e3).astype(dtype)
    if distinct:
        x = rng.integers(0, distinct, n).astype(dtype)
    at = rng.choice(n, 5 * 6, replace=False).reshape(5, 6)
    for spec, rows in zip(SPECIALS, at):
        x[rows] = spec
    return x


def _pair(x, valid=None):
    """(reference column, port column) over the same buffers; the data
    under a null is 0 in both (see order_keys)."""
    if valid is not None:
        x = np.where(valid, x, np.zeros(1, x.dtype))
    ref = RefColumn.from_numpy(x, mask=valid)
    return ref, ct.from_buffers(x.dtype, x.shape[0], x, valid, device=CPU)


def _np(t):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return t


def _same(got, exp, what=""):
    got, exp = _np(got), _np(exp)
    assert got.dtype == exp.dtype, (what, got.dtype, exp.dtype)
    np.testing.assert_array_equal(got, exp, err_msg=str(what))
