"""Inputs and comparisons shared by the groupby family tests
(tests/test_torch_groupby_family.py, test_torch_groupby_bitwise.py,
test_torch_groupby_transform.py)."""

import numpy as np
import torch

from cudf_tpu.core.column import Column as RefColumn
from cudf_tpu.ops import groupby as ref_gb
import cudf_tpu_torch as ct
from cudf_tpu_torch.ops import groupby as gb


CPU = torch.device("cpu")
N = 400
BIT_DTYPES = [np.int8, np.int16, np.int32, np.int64, np.uint8, np.uint16, np.uint32,
              np.uint64, np.bool_]


def _key(rng, n=N, groups=7, nulls=True):
    """int32 keys 0..groups-1 (the last group all-null in the values), a
    null key's data 0 (the reference orders nulls by their data)."""
    k = rng.integers(0, groups, n).astype(np.int32)
    valid = rng.random(n) > 0.1 if nulls else None
    if valid is not None:
        k = np.where(valid, k, 0)
    return k, valid


def _values(rng, dtype, k, groups=7):
    """Values of dtype with nulls (NaN too for floats), every row of the
    last group null."""
    dtype = np.dtype(dtype)
    if dtype == np.bool_:
        x = rng.random(k.shape[0]) > 0.5
    elif dtype.kind == "f":
        x = rng.normal(0, 50, k.shape[0]).astype(dtype)
        x[rng.random(k.shape[0]) < 0.05] = np.nan
    else:
        lo = 0 if dtype.kind == "u" else -100
        x = rng.integers(lo, 100, k.shape[0]).astype(dtype)
    valid = (rng.random(k.shape[0]) > 0.1) & (k != groups - 1)
    return x, valid


def _port(x, valid):
    return ct.from_buffers(x.dtype, x.shape[0], x, valid, device=CPU)


def _ref(x, valid):
    return RefColumn.from_numpy(x, mask=valid)


def _groupers(k, kv, dropna):
    return (gb.make_grouper([_port(k, kv)], dropna=dropna),
            ref_gb.make_grouper([_ref(k, kv)], dropna=dropna))


def _port_values(col):
    """(values, valid) of a port column on the host, NaN and null as
    missing."""
    v = col.data.numpy()
    ok = np.ones(col.length, bool) if col.validity is None else col.validity.numpy()
    if v.dtype.kind == "f":
        ok = ok & ~np.isnan(v)
    return v, ok


def _ref_values(col):
    v = np.asarray(col.data)
    ok = np.ones(col.length, bool) if col.validity is None else np.asarray(col.validity)
    if v.dtype.kind == "f":
        ok = ok & ~np.isnan(v)
    return v, ok


def _assert_same(port_col, exp, exp_ok, rtol, what):
    got, ok = _port_values(port_col)
    np.testing.assert_array_equal(ok, exp_ok, err_msg=f"{what} nulls")
    if got.dtype.kind == "f":
        np.testing.assert_allclose(got[ok], np.asarray(exp)[ok], rtol=rtol, atol=0,
                                   err_msg=what)
    else:
        np.testing.assert_array_equal(got[ok], np.asarray(exp)[ok], err_msg=what)
