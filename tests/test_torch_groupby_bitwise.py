"""The port's bitwise groupby aggregations (``cudf_tpu_torch/ops/groupby.py``
bitwise_and, bitwise_or, bitwise_xor on the sort tier) against numpy on
every integer and bool dtype, against cudf_tpu's on the JAX CPU backend
on two dtypes (its reset scans take seconds a dtype to compile on a
CPU), and raising for floats, over the seeded keys and values of
``tests/test_torch_groupby_family.py``.  Every result exact."""

import numpy as np
import pytest
import torch

import torch_jax_cache  # noqa: F401  (the run's shared JAX compile cache)
from cudf_tpu.ops import groupby as ref_gb
from cudf_tpu_torch.ops import groupby as gb
from torch_groupby_family_helpers import (BIT_DTYPES, _assert_same, _groupers, _key, _port,
                                       _port_values, _ref, _ref_values, _values)


@pytest.mark.parametrize("op", ["and", "or", "xor"])
@pytest.mark.parametrize("dtype", BIT_DTYPES, ids=lambda d: np.dtype(d).name)
def test_bitwise_aggregations_match_numpy(dtype, op):
    """Each group's bitwise reduction of its valid values in the column's
    dtype (bool stays bool, uint64 keeps its high bit), null for the
    all-null group; held to numpy's reduce over each group."""
    rng = np.random.default_rng(2)
    k, kv = _key(rng, nulls=False)
    if np.dtype(dtype) == np.uint64:
        x = rng.integers(0, 1 << 62, k.shape[0]).astype(np.uint64) | np.uint64(1 << 63)
        xv = (rng.random(k.shape[0]) > 0.1) & (k != 6)
    else:
        x, xv = _values(rng, dtype, k)
    g = gb.make_grouper([_port(k, None)])
    got = gb.aggregate(_port(x, xv), g, f"bitwise_{op}")
    assert got.data.dtype == torch.from_numpy(x[:1]).dtype
    fn = {"and": np.bitwise_and, "or": np.bitwise_or, "xor": np.bitwise_xor}[op]
    exp, ok = [], []
    for key in range(7):
        vals = x[(k == key) & xv]
        ok.append(vals.size > 0)
        exp.append(fn.reduce(vals) if vals.size else x[0])
    _assert_same(got, np.array(exp, dtype=x.dtype), np.array(ok), 0, f"bitwise_{op}")


@pytest.mark.parametrize("dtype", [np.int8, np.int32], ids=lambda d: np.dtype(d).name)
def test_bitwise_aggregations_match_reference(dtype):
    """The reference gives int64; the port the column's dtype, whose values
    must be the reference's."""
    rng = np.random.default_rng(3)
    k, kv = _key(rng)
    x, xv = _values(rng, dtype, k)
    port_g, ref_g = _groupers(k, kv, True)
    for op in ("and", "or", "xor"):
        got = gb.aggregate(_port(x, xv), port_g, f"bitwise_{op}")
        ref = getattr(ref_gb, f"group_bitwise_{op}")(_ref(x, xv), ref_g)
        exp, ok = _ref_values(ref)
        np.testing.assert_array_equal(_port_values(got)[1], ok)
        np.testing.assert_array_equal(got.data.numpy()[ok].astype(np.int64), exp[ok])


def test_bitwise_of_floats_raises():
    g = gb.make_grouper([_port(np.zeros(3, np.int32), None)])
    with pytest.raises(TypeError):
        gb.aggregate(_port(np.ones(3), None), g, "bitwise_or")
