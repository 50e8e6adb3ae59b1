"""Kernels B, C, D and the radix pipeline (cudf_tpu_torch.kernels.
radix_partition) against the reference's Pallas kernels in interpret mode.

On CPU tensors each wrapper takes its plain PyTorch version.  Tolerances:
histograms, counts, integer sums and partition multisets exact.  Float
sums: the port sums f32 inputs in float64 while the reference keeps
double-float f32 pairs, so the two agree to rtol 1e-7 (atol 1e-6 where
sums cancel), and the port agrees with numpy's float64 bincount to rtol
1e-12.  Reference calls use the small tiles of tests/test_radix.py
(tile_rows=32, chunk_rows=2, agg_rows=8) and compile once per shape, so
each case is computed once per module.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudf_tpu.kernels import radix_partition as ref
from cudf_tpu_torch.kernels import radix_partition as rp
from torch_radix_partition_helpers import _windows, rng

torch.set_num_threads(1)

REF_TILES = dict(tile_rows=32, chunk_rows=2, agg_rows=8)
PORT_TILE = 32 * 128          # the reference's tile, in keys


def test_digit_histogram_matches_reference(rng):
    n, K, tile_rows = 20_000, 600, 16
    keys = rng.integers(0, K, n).astype(np.int32)
    keys[::13] = -1                                  # dropped like SENTINEL
    tile = tile_rows * 128
    nt = -(-n // tile)
    padded = np.concatenate([keys, np.full(nt * tile - n, ref.SENTINEL, np.int32)])
    exp = np.asarray(ref.digit_histogram(
        jnp.asarray(padded.reshape(1, nt * tile_rows, 128)), nbits=3, shift=7,
        tile_rows=tile_rows, interpret=True))
    for k in (keys, padded):
        got = rp.digit_histogram(torch.from_numpy(k), nbits=3, shift=7, tile=tile)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), exp)


@pytest.mark.parametrize("dom_bits", [17, 27])
def test_radix_scatter_matches_reference_partition(rng, dom_bits):
    """The reference's radix_partition at merge_tiles=1 runs radix_scatter;
    per-window multisets of (key, row id) pairs must agree, at 2^4 and at
    2^14 buckets (the scatter route's widest), and the port's windows
    hold their rows in input order."""
    n = 30_000 if dom_bits == 17 else 10_000     # two passes at a third of the rows
    keys = rng.integers(0, 1 << dom_bits, n).astype(np.int32)
    vals = np.arange(n, dtype=np.int32)
    pdata, rbase, G = ref.radix_partition(
        jnp.asarray(keys), jnp.asarray(vals), dom_bits, tile_rows=8,
        chunk_rows=2, align_rows=8, merge_tiles=1, interpret=True)
    rbase = np.asarray(rbase) * 128
    exp = _windows(np.asarray(pdata[0]).ravel(), np.asarray(pdata[1]).ravel(), rbase, G)

    pk, (pv,), base, pG = rp.radix_partition(torch.from_numpy(keys),
                                             [torch.from_numpy(vals)], dom_bits,
                                             tile=8 * 128, merge_tiles=1)
    assert pG == G
    base = base.numpy()
    assert base[-1] == n                              # exact: every row, once
    got = _windows(pk.numpy(), pv.numpy(), base, G)
    assert got == exp
    win = np.repeat(np.arange(G), np.diff(base))
    assert ((pk.numpy()[:n] >> rp.WINDOW_BITS) == win).all()   # no garbage
    assert (np.diff(pv.numpy().astype(np.int64) + win * n) > 0).all()   # input order


def test_radix_scatter_drops_negative_keys_and_carries_payloads(rng):
    n, nbits, tile = 5000, 4, 512
    keys = rng.integers(0, 1 << 17, n).astype(np.int32)
    keys[::7] = -1
    tk = torch.from_numpy(keys)
    pays = [torch.arange(n, dtype=torch.int32), torch.from_numpy(rng.normal(size=n))]
    hist = rp.digit_histogram(tk, nbits, 13, tile)
    offsets, base = rp.partition_offsets(hist)
    ok, (oi, of) = rp.radix_scatter(tk, pays, offsets, nbits, 13, tile)
    m = int(base[-1])
    assert m == int((keys >= 0).sum())
    rows = oi[:m].long()
    assert torch.equal(tk[rows], ok[:m]) and torch.equal(pays[1][rows], of[:m])
    assert sorted(rows.tolist()) == np.flatnonzero(keys >= 0).tolist()
    # each (tile, bucket) run starts at its offset, in input order
    for t in range(hist.shape[0]):
        for b in range(1 << nbits):
            lo, cnt = int(offsets[t, b]), int(hist[t, b])
            run = rows[lo:lo + cnt]
            assert ((run // tile) == t).all() and ((tk[run] >> 13) == b).all()


_CASES = ["low_k", "one_pass", "tiny_k", "k_1e6", "skew", "two_pass", "int"]


@functools.lru_cache(maxsize=None)
def _case(name):
    rng = np.random.default_rng(_CASES.index(name))
    n, K, mode = {"low_k": (50_000, 1000, "float"), "one_pass": (40_000, 30_000, "float"),
                  "tiny_k": (60_000, 7, "float"), "k_1e6": (24_000, 1_000_000, "float"),
                  "skew": (40_000, 25_000, "float"),
                  "two_pass": (20_000, 1_200_000, "float"),
                  "int": (40_000, 30_000, "int")}[name]
    keys = rng.integers(0, K, n).astype(np.int32)
    if name == "skew":       # 90% of rows on one key
        keys = np.where(rng.random(n) < 0.9, 17, keys).astype(np.int32)
    if mode == "int":
        vals = rng.integers(-2**30, 2**30, n).astype(np.int32)
    else:
        vals = rng.normal(size=n).astype(np.float32)
    rs, rc = ref.radix_groupby_sum_count(jnp.asarray(keys), jnp.asarray(vals), K,
                                         interpret=True, int_mode=(mode == "int"),
                                         **REF_TILES)
    return keys, vals, K, np.asarray(rs), np.asarray(rc)


@pytest.mark.parametrize("name", _CASES)
def test_radix_groupby_matches_reference(name):
    keys, vals, K, rs, rc = _case(name)
    s, c = rp.radix_groupby_sum_count(torch.from_numpy(keys), torch.from_numpy(vals),
                                      K, tile=PORT_TILE, agg_rows=8 * 128)
    s, c = s.numpy(), c.numpy()
    np.testing.assert_array_equal(c, rc)
    np.testing.assert_array_equal(c, np.bincount(keys, minlength=K))
    if vals.dtype == np.int32:
        assert s.dtype == np.int64
        np.testing.assert_array_equal(s, rs)
    else:
        assert s.dtype == np.float64
        np.testing.assert_allclose(s, rs, rtol=1e-7, atol=1e-6)
        exp = np.bincount(keys, weights=vals.astype(np.float64), minlength=K)
        np.testing.assert_allclose(s, exp, rtol=1e-12)


def test_bucket_aggregate_matches_reference_windows(rng):
    """Kernel D alone over the port's partition, against the reference
    pipeline's per-key results (one case, compiled once for both)."""
    keys, vals, K, rs, rc = _case("one_pass")
    tk = torch.from_numpy(keys)
    pk, (pv,), base, G = rp.radix_partition(tk, [torch.from_numpy(vals)], 15,
                                            tile=PORT_TILE)
    s, c = rp.bucket_aggregate(pk, pv, base, G, agg_rows=1024)
    np.testing.assert_array_equal(c.numpy()[:K], rc)
    np.testing.assert_allclose(s.numpy()[:K], rs, rtol=1e-7, atol=1e-6)
    assert (c.numpy()[K:] == 0).all()
    _, none = rp.bucket_aggregate(pk, pv, base, G, with_counts=False)
    assert none is None


def test_bucket_aggregate_list_form_matches_reference():
    """Kernel D's list form (plain path): float32, float64, int32, int64
    and bool columns over one partition, more than one launch's worth,
    give the reference's sums for the f32 column, the single-column form's
    sums for each, and one shared count."""
    keys, vals, K, rs, rc = _case("one_pass")
    rng = np.random.default_rng(11)
    n = keys.shape[0]
    cols = [torch.from_numpy(vals), torch.from_numpy(vals.astype(np.float64)),
            torch.from_numpy(rng.integers(-2**31, 2**31, n).astype(np.int32)),
            torch.from_numpy(rng.integers(-2**62, 2**62, n)),
            torch.from_numpy(rng.random(n) > 0.5)]
    pk, pv, base, G = rp.radix_partition(torch.from_numpy(keys), cols, 15, tile=PORT_TILE)
    sums, c = rp.bucket_aggregate(pk, pv, base, G, agg_rows=1024)
    assert len(sums) == len(cols) > rp.MAX_AGG_COLUMNS
    np.testing.assert_array_equal(c.numpy()[:K], rc)
    np.testing.assert_allclose(sums[0].numpy()[:K], rs, rtol=1e-7, atol=1e-6)
    np.testing.assert_array_equal(sums[1].numpy(), sums[0].numpy())
    for s, v in zip(sums, pv):
        one, none = rp.bucket_aggregate(pk, v, base, G, with_counts=False)
        assert none is None and s.dtype == one.dtype and torch.equal(s, one)
    exp = np.zeros(K, np.int64)
    np.add.at(exp, keys, cols[3].numpy())                # int64 sums wrap as numpy's
    np.testing.assert_array_equal(sums[3].numpy()[:K], exp)
    assert [s.dtype for s in sums] == [torch.float64] * 2 + [torch.int64] * 3
    with pytest.raises(ValueError):
        rp.bucket_aggregate(pk, [], base, G)
    with pytest.raises(ValueError):
        rp.bucket_aggregate(pk, pv[:2], base, G, agg_rows=0)


def _shuffling_scatter(plain):
    """radix_scatter_plain with each bucket's rows in a new random order on
    every call, as kernel C's shared-atomic slots may come on the card."""
    def scatter(keys, payloads, offsets, nbits, shift, tile):
        out_keys, outs = plain(keys, payloads, offsets, nbits, shift, tile)
        m = int((keys >= 0).sum())
        digit = (out_keys[:m] >> shift) & ((1 << nbits) - 1)
        perm = torch.argsort(digit.double() + torch.rand(m, dtype=torch.float64))
        out_keys[:m] = out_keys[:m][perm]
        for o in outs:
            o[:m] = o[:m][perm]
        return out_keys, outs
    return scatter


@pytest.mark.parametrize("nvals", [1, 4, 5, 9])
def test_pipeline_pairs_many_values_with_their_keys(rng, monkeypatch, nvals):
    """Past MAX_PAYLOADS values per launch the keys are still partitioned
    once, so every value column stays paired with its own key on both
    routes, even when kernel C's plain scatter orders rows differently on
    each call."""
    monkeypatch.setattr(rp, "radix_scatter_plain", _shuffling_scatter(rp.radix_scatter_plain))
    n, K = 5000, 40_000
    keys = torch.from_numpy(rng.integers(0, K, n).astype(np.int32))
    keys[::9] = -1
    vals = [torch.from_numpy(rng.integers(-99, 99, n).astype(np.int32) * (j + 1))
            for j in range(nvals)]
    sums, c = rp.radix_groupby_sum_count(keys, vals, K, tile=1024)
    ok = keys >= 0
    k = keys[ok].long()
    assert torch.equal(c, torch.bincount(k, minlength=K))
    for merge_tiles in (1, 4):
        pk, pv, base, G = rp.radix_partition(keys, vals, rp.domain_bits(K), tile=1024,
                                             merge_tiles=merge_tiles)
        route = [rp.bucket_aggregate(pk, v, base, G)[0][:K] for v in pv]
        for s, r, v in zip(sums, route, vals):
            exp = torch.zeros(K, dtype=torch.int64).index_add_(0, k, v[ok].long())
            assert torch.equal(s, exp) and torch.equal(r, exp)


def test_pipeline_shares_one_partition_across_values(rng):
    n, K = 6000, 100_000
    keys = torch.from_numpy(rng.integers(0, K, n).astype(np.int32))
    keys[::5] = -1
    a = torch.from_numpy(rng.integers(-9, 9, n))
    b = torch.from_numpy(rng.normal(size=n))
    (sa, sb), c = rp.radix_groupby_sum_count(keys, [a, b], K)
    ok = keys >= 0
    k = keys[ok].long()
    assert torch.equal(sa, torch.zeros(K, dtype=torch.int64).index_add_(0, k, a[ok]))
    assert torch.allclose(sb, torch.zeros(K, dtype=torch.float64).index_add_(0, k, b[ok]),
                          rtol=1e-12, atol=0)
    assert torch.equal(c, torch.bincount(k, minlength=K))
    with pytest.raises(ValueError):
        rp.radix_groupby_sum_count(keys, [a], (1 << 27) + 1)
