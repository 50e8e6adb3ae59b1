"""Kernel A (cudf_tpu_torch.kernels.hash_aggregate) against the
reference's Pallas kernel in interpret mode and its jnp oracle.

On CPU tensors the wrapper takes its plain PyTorch version.  Tolerances:
counts exact; integer sums exact (both sides are exact int64); min/max
exact (the reference keeps f32 values, and int values below 2^24, exact).
Float sums: the port sums f32 inputs in float64 (error ~1e-16 relative)
while the reference keeps double-float f32 pairs, so the two agree to
rtol 1e-7 (atol 1e-6 for sums that cancel to near zero), and the port
agrees with numpy's float64 bincount to rtol 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_jax_cache  # noqa: F401  (the run's shared JAX compile cache)
from cudf_tpu.kernels.hash_aggregate import (onehot_groupby_aggregate as ref_onehot,
                                             reference_groupby_aggregate)
from cudf_tpu_torch.kernels.hash_aggregate import (onehot_groupby_aggregate,
                                                   onehot_groupby_aggregate_plain)

torch.set_num_threads(1)


def _port(keys, vals, K, valid=None, with_minmax=True):
    out = onehot_groupby_aggregate(
        torch.from_numpy(keys), torch.from_numpy(vals), K,
        valid=None if valid is None else torch.from_numpy(valid),
        with_minmax=with_minmax)
    return [None if t is None else t.numpy() for t in out]


def _ref(keys, vals, K, valid=None, int_mode=False):
    out = ref_onehot(jnp.asarray(keys), jnp.asarray(vals), K,
                     valid=None if valid is None else jnp.asarray(valid),
                     interpret=True, int_mode=int_mode)
    return [np.asarray(t) for t in out]


def _exact_sums(keys, vals, K, ok):
    return np.bincount(keys[ok], weights=vals[ok].astype(np.float64), minlength=K)


@pytest.mark.parametrize("n,K", [(1000, 7), (5000, 100), (4096, 128), (10000, 500)])
def test_float_matches_reference(rng, n, K):
    keys = rng.integers(0, K, n).astype(np.int32)
    vals = rng.normal(size=n).astype(np.float32)
    s, c, mn, mx = _port(keys, vals, K)
    rs, rc, rmn, rmx = _ref(keys, vals, K)
    assert s.dtype == np.float64 and mn.dtype == np.float32
    np.testing.assert_allclose(s, rs, rtol=1e-7, atol=1e-6)
    np.testing.assert_allclose(s, _exact_sums(keys, vals, K, keys >= 0), rtol=1e-12)
    np.testing.assert_array_equal(c, rc)
    np.testing.assert_array_equal(mn, rmn)
    np.testing.assert_array_equal(mx, rmx)
    js, jc, jmn, jmx = [np.asarray(t) for t in reference_groupby_aggregate(
        jnp.asarray(keys), jnp.asarray(vals), K)]
    np.testing.assert_array_equal(c, jc)
    np.testing.assert_array_equal(mn, jmn)
    np.testing.assert_array_equal(mx, jmx)


def test_masked_matches_reference(rng):
    n, K = 3000, 50
    keys = rng.integers(0, K, n).astype(np.int32)
    vals = rng.normal(size=n).astype(np.float32)
    valid = rng.random(n) > 0.3
    s, c, mn, mx = _port(keys, vals, K, valid)
    rs, rc, rmn, rmx = _ref(keys, vals, K, valid)
    np.testing.assert_allclose(s, rs, rtol=1e-7, atol=1e-6)
    np.testing.assert_array_equal(c, rc)
    np.testing.assert_array_equal(mn, rmn)
    np.testing.assert_array_equal(mx, rmx)


def test_out_of_range_keys_dropped(rng):
    n, K = 1000, 10
    keys = rng.integers(-5, K + 5, n).astype(np.int32)
    vals = np.ones(n, np.float32)
    s, c, _, _ = _port(keys, vals, K)
    rs, rc, _, _ = _ref(keys, vals, K)
    np.testing.assert_array_equal(c, rc)
    np.testing.assert_array_equal(s, rs)
    assert int(c.sum()) == int(((keys >= 0) & (keys < K)).sum())


@pytest.mark.parametrize("with_mask", [False, True])
def test_int_mode_exact_vs_reference(rng, with_mask):
    """int32 values: the reference's int_mode sums are exact int64, and so
    are the port's; values below 2^24 keep the reference's f32 min/max
    exact too."""
    n, K = 6000, 300
    keys = rng.integers(0, K, n).astype(np.int32)
    vals = rng.integers(-2**23, 2**23, n).astype(np.int32)
    valid = (rng.random(n) > 0.25) if with_mask else None
    s, c, mn, mx = _port(keys, vals, K, valid)
    rs, rc, rmn, rmx = _ref(keys, vals, K, valid, int_mode=True)
    assert s.dtype == np.int64 and mn.dtype == np.int32
    np.testing.assert_array_equal(s, rs)
    np.testing.assert_array_equal(c, rc)
    seen = c > 0
    np.testing.assert_array_equal(mn[seen].astype(np.float32), rmn[seen])
    np.testing.assert_array_equal(mx[seen].astype(np.float32), rmx[seen])


def test_wide_values_keep_their_width(rng):
    """Beyond the reference's TPU limits: int64 values past 2^31 sum
    exactly, float64 values sum in float64."""
    n, K = 4000, 64
    keys = rng.integers(0, K, n).astype(np.int32)
    big = rng.integers(-2**60, 2**60, n)
    s, c, mn, mx = _port(keys, big, K)
    exp = np.zeros(K, np.int64)
    np.add.at(exp, keys, big)
    np.testing.assert_array_equal(s, exp)
    for k in range(K):
        np.testing.assert_array_equal([mn[k], mx[k]],
                                      [big[keys == k].min(), big[keys == k].max()])
    f = rng.normal(size=n) * 1e6
    s, _, _, _ = _port(keys, f, K)
    np.testing.assert_allclose(s, _exact_sums(keys, f, K, keys >= 0), rtol=1e-12)


def test_bool_values_and_empty_groups(rng):
    n, K = 500, 40
    keys = rng.integers(0, K - 5, n).astype(np.int32)   # groups 35.. stay empty
    vals = rng.random(n) > 0.5
    s, c, mn, mx = _port(keys, vals, K)
    assert s.dtype == np.int64 and mn.dtype == np.bool_
    np.testing.assert_array_equal(s, np.bincount(keys, weights=vals, minlength=K))
    assert (c[35:] == 0).all() and mn[35:].all() and not mx[35:].any()
    _, _, fmn, fmx = _port(keys, vals.astype(np.float32), K)
    assert np.isposinf(fmn[35:]).all() and np.isneginf(fmx[35:]).all()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_minmax_skip_nan_like_pandas(rng, dtype):
    """min/max skip NaN as pandas does, and a group of only NaN gives NaN
    (the reference propagates NaN: ROADMAP.md queue 3)."""
    import pandas as pd

    n, K = 3000, 60
    keys = rng.integers(0, K, n).astype(np.int32)
    vals = rng.normal(size=n).astype(dtype)
    vals[rng.random(n) < 0.3] = np.nan
    vals[keys % 7 == 0] = np.nan                         # groups of only NaN
    _, c, mn, mx = _port(keys, vals, K)
    exp = pd.DataFrame({"k": keys, "v": vals}).groupby("k")["v"].agg(["min", "max"])
    np.testing.assert_array_equal(c, np.bincount(keys, minlength=K))
    np.testing.assert_array_equal(mn[exp.index], exp["min"].to_numpy())
    np.testing.assert_array_equal(mx[exp.index], exp["max"].to_numpy())
    assert np.isnan(mn[exp.index % 7 == 0]).all()


def test_kernel_minmax_identities_decode_to_nan():
    """On the card a group of only NaN keeps kernel A's identities (all
    ones for min, zero for max); the wrapper decodes both to NaN."""
    from cudf_tpu_torch.kernels.hash_aggregate import _decode_order_key

    enc = torch.tensor([-1, 0], dtype=torch.int64)
    assert torch.isnan(_decode_order_key(enc, torch.float64)).all()


def test_without_minmax_and_plain_is_the_wrapper(rng):
    keys = torch.from_numpy(rng.integers(0, 9, 300).astype(np.int32))
    vals = torch.from_numpy(rng.normal(size=300))
    s, c, mn, mx = onehot_groupby_aggregate(keys, vals, 9, with_minmax=False)
    assert mn is None and mx is None
    before = onehot_groupby_aggregate.launches
    ps, pc, _, _ = onehot_groupby_aggregate_plain(keys, vals, 9)
    assert torch.equal(s, ps) and torch.equal(c, pc)
    assert onehot_groupby_aggregate.launches == before      # CPU: no kernel


def test_list_form_matches_reference_and_single_calls(rng):
    """Kernel A's list form (plain path): float32, int32, float64 and bool
    columns under one mask in one call, min/max on two of them; the f32
    column matches the reference (the (5000, 100) shape that
    test_float_matches_reference compiles), every column its
    single-column call, and the counts are shared."""
    n, K = 5000, 100
    keys = rng.integers(0, K, n).astype(np.int32)
    cols = [rng.normal(size=n).astype(np.float32), rng.integers(-2**31, 2**31, n).astype(np.int32),
            rng.normal(size=n) * 1e6, rng.random(n) > 0.5]
    flags = [True, False, True, False]
    s, c, mn, mx = onehot_groupby_aggregate(torch.from_numpy(keys),
                                            [torch.from_numpy(v) for v in cols], K,
                                            with_minmax=flags)
    rs, rc, rmn, rmx = _ref(keys, cols[0], K)
    np.testing.assert_allclose(s[0].numpy(), rs, rtol=1e-7, atol=1e-6)
    np.testing.assert_array_equal(c.numpy(), rc)
    np.testing.assert_array_equal(mn[0].numpy(), rmn)
    np.testing.assert_array_equal(mx[0].numpy(), rmx)
    assert mn[1] is None and mx[3] is None and mn[2].dtype == torch.float64
    for j, v in enumerate(cols):
        one = _port(keys, v, K, with_minmax=flags[j])
        np.testing.assert_array_equal(s[j].numpy(), one[0])
        np.testing.assert_array_equal(c.numpy(), one[1])
        if flags[j]:
            np.testing.assert_array_equal(mn[j].numpy(), one[2])
            np.testing.assert_array_equal(mx[j].numpy(), one[3])
    with pytest.raises(ValueError):
        onehot_groupby_aggregate(torch.from_numpy(keys), [], K)
    with pytest.raises(ValueError):
        onehot_groupby_aggregate(torch.from_numpy(keys), [torch.from_numpy(cols[0])], K,
                                 with_minmax=[True, False])


def test_column_launches_fit_shared_memory():
    """The launches kernel A splits a call's columns into: at most
    MAX_COLUMNS each, and bins that fit one block's shared memory."""
    from cudf_tpu_torch.kernels import hash_aggregate as ha

    assert ha.column_launches(100, [False] * 3) == [[0, 1, 2]]
    assert ha.column_launches(100, [False] * 6) == [[0, 1, 2, 3], [4, 5]]
    assert ha.column_launches(4096, [True, False, True, True]) == [[0, 1], [2, 3]]
    assert ha.column_launches(4096, [False] * 6) == [[0, 1, 2, 3], [4, 5]]
    for K in (1, 100, 4096):
        for flags in ([True] * 5, [False, True] * 3):
            parts = ha.column_launches(K, flags)
            assert sorted(j for p in parts for j in p) == list(range(len(flags)))
            for p in parts:
                slots = sum(3 if flags[j] else 1 for j in p)
                assert len(p) <= ha.MAX_COLUMNS and K * (8 * slots + 4) <= ha.MAX_SHARED


def test_wrapper_checks_inputs():
    keys = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        onehot_groupby_aggregate(keys.long(), torch.ones(4), 3)
    with pytest.raises(ValueError):
        onehot_groupby_aggregate(keys, torch.ones(5), 3)
    with pytest.raises(ValueError):
        onehot_groupby_aggregate(keys, torch.ones(4), 5000)
    with pytest.raises(ValueError):
        onehot_groupby_aggregate(keys, torch.ones(8)[::2], 3)
