"""Kernels E and F (cudf_tpu_torch.kernels.tile_sort), kernel G
(radix_partition.merge_scatter) and the sorted partition route against
the reference's Pallas kernels in interpret mode, and the routes of
``radix_partition`` against each other.

On CPU tensors each wrapper takes its plain PyTorch version.  Reference
calls use tests/test_radix.py's small tiles (tile_rows=8: 1024 keys a
tile, four a supertile) and are computed once per module.  Everything
is exact: the reference's bitonic sort is unstable, so where keys tie
its riders are held as a multiset; with unique keys per tile they are
equal.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudf_tpu.kernels import bitonic as ref_bitonic
from cudf_tpu.kernels import radix_partition as ref
from cudf_tpu_torch.kernels import radix_partition as rp
from cudf_tpu_torch.kernels import tile_sort as ts
from test_torch_radix_partition import _windows

torch.set_num_threads(1)

TILE_ROWS = 8
TILE = TILE_ROWS * 128
TILES = 8
MASK = rp.WINDOW_BITS + rp.PASS_BITS          # the second pass's mask_bits


def _tile_keys(masked):
    """TILES tiles of int32 keys: the first half heavy with ties (and
    negative keys), the second half unique per tile (unique in their low
    MASK bits when masked)."""
    rng = np.random.default_rng(3 + masked)
    n = TILES * TILE
    keys = np.empty(n, np.int32)
    half = n // 2
    keys[:half] = rng.integers(-3, 4, half)
    for t in range(TILES // 2, TILES):
        if masked:
            low = rng.choice(1 << MASK, TILE, replace=False)
            high = rng.integers(0, 1 << 10, TILE)
            keys[t * TILE:(t + 1) * TILE] = (high << MASK) | low
        else:
            keys[t * TILE:(t + 1) * TILE] = rng.choice(
                np.arange(-2**31, 2**31 - 1, 2**17, dtype=np.int64), TILE, replace=False)
    return keys


@functools.lru_cache(maxsize=None)
def _reference_sort(kernel):
    """(keys, rider row ids, reference keys, reference riders) of the
    reference's tile_sort (no mask) or tile_sort_data (mask_bits=MASK),
    alternate=True."""
    masked = kernel == "tile_sort_data"
    keys = _tile_keys(masked)
    rows = np.arange(keys.size, dtype=np.int32)
    if masked:
        data = jnp.asarray(np.stack([keys, rows]).reshape(2, -1, 128))
        out = np.array(ref_bitonic.tile_sort_data(data, tile_rows=TILE_ROWS, alternate=True,
                                                    mask_bits=MASK, interpret=True))
        rk, rr = out[0].ravel(), out[1].ravel()
    else:
        rk, rr = (np.array(a).ravel() for a in ref_bitonic.tile_sort(
            jnp.asarray(keys.reshape(-1, 128)), jnp.asarray(rows.reshape(-1, 128)),
            tile_rows=TILE_ROWS, alternate=True, interpret=True))
    return keys, rows, rk, rr


@pytest.mark.parametrize("kernel", ["tile_sort", "tile_sort_data"])
def test_tile_sort_matches_reference(kernel):
    keys, rows, rk, rr = _reference_sort(kernel)
    masked = kernel == "tile_sort_data"
    mask_bits = MASK if masked else None
    tk, tr = torch.from_numpy(keys), torch.from_numpy(rows)
    if masked:
        gk, (gr,) = ts.tile_sort_data(tk, [tr], TILE, alternate=True, mask_bits=mask_bits)
    else:
        gk, gr = ts.tile_sort(tk, tr, tile=TILE, alternate=True)
    gk, gr = gk.numpy(), gr.numpy()
    order = ts.sort_key_plain(torch.from_numpy(rk), mask_bits).numpy()
    np.testing.assert_array_equal(ts.sort_key_plain(torch.from_numpy(gk), mask_bits).numpy(),
                                  order)
    for t in range(TILES):
        blk = slice(t * TILE, (t + 1) * TILE)
        step = -1 if t % 2 else 1
        assert (np.diff(order[blk]) * step >= 0).all()               # odd tiles descend
        assert (keys[gr[blk]] == gk[blk]).all()                      # riders paired
        assert sorted(gr[blk]) == list(range(t * TILE, (t + 1) * TILE))
        assert sorted(zip(gk[blk], gr[blk])) == sorted(zip(rk[blk], rr[blk]))
        if t >= TILES // 2:                                          # unique keys
            np.testing.assert_array_equal(gk[blk], rk[blk])
            np.testing.assert_array_equal(gr[blk], rr[blk])


@functools.lru_cache(maxsize=None)
def _reference_partition(dom_bits):
    rng = np.random.default_rng(dom_bits)
    n = 30_000 if dom_bits <= MASK else 20_000      # a ragged last tile
    keys = rng.integers(0, 1 << dom_bits, n).astype(np.int32)
    keys[:2] = 0, (1 << dom_bits) - 1                # the domain's ends
    vals = np.arange(n, dtype=np.int32)
    pdata, base, G = ref.radix_partition(jnp.asarray(keys), jnp.asarray(vals), dom_bits,
                                         tile_rows=TILE_ROWS, chunk_rows=2, align_rows=8,
                                         merge_tiles=4, interpret=True)
    base = np.asarray(base) * 128
    return keys, vals, G, _windows(np.asarray(pdata[0]).ravel(), np.asarray(pdata[1]).ravel(),
                                   base, G)


@pytest.mark.parametrize("negatives", [False, True])
@pytest.mark.parametrize("dom_bits", [17, 21])
def test_sorted_route_matches_reference_partition(dom_bits, negatives):
    """One pass (17 bits) and two passes (21 bits) at merge_tiles = 4,
    the single or first pass under mask_bits = dom_bits: the same windows
    as the reference, exact, every run sorted.  With negatives, -1 rows
    between the reference's rows are dropped and change no window."""
    keys, vals, G, exp = _reference_partition(dom_bits)
    n = keys.size
    if negatives:
        at = np.arange(0, n, 7)
        keys = np.insert(keys, at, -1)
        vals = np.insert(vals, at, n + np.arange(at.size, dtype=np.int32))
    pk, (pv,), base, pG = rp.radix_partition(torch.from_numpy(keys), [torch.from_numpy(vals)],
                                             dom_bits, tile=TILE, merge_tiles=4)
    assert pG == G
    pk, pv, base = pk.numpy(), pv.numpy(), base.numpy()
    assert base[-1] == n
    np.testing.assert_array_equal(pk[:n] >> rp.WINDOW_BITS, np.repeat(np.arange(G), np.diff(base)))
    assert _windows(pk, pv, base, G) == exp
    key_of = np.empty(vals.size, np.int32)
    key_of[vals] = keys
    np.testing.assert_array_equal(key_of[pv[:n]], pk[:n])
    st = 4 * TILE
    if dom_bits <= MASK:                      # each (supertile, bucket) run is sorted
        hist = rp.digit_histogram(torch.from_numpy(keys), dom_bits - rp.WINDOW_BITS,
                                  rp.WINDOW_BITS, st)
        offsets, _ = rp.partition_offsets(hist)
        for lo, cnt in zip(offsets.view(-1).tolist(), hist.view(-1).tolist()):
            assert (np.diff(pk[lo:lo + cnt]) >= 0).all()
    else:                                     # a window: one sorted run per supertile
        region = keys >> MASK
        for g in range(G):
            w = pk[base[g]:base[g + 1]]
            supertiles = -(-int((region == g >> rp.PASS_BITS).sum()) // st)
            assert int((np.diff(w) < 0).sum()) < max(supertiles, 1)


# ----------------------------------------------------------------------
# the routes of radix_partition against each other (no reference)
# ----------------------------------------------------------------------

def _route_case(name):
    rng = np.random.default_rng(len(name))
    n, bits = {"ragged": (21_111, 17), "negatives": (20_000, 16), "f64_bits": (12_000, 15),
               "five_values": (15_000, 18), "two_pass": (25_000, 21),
               "edges_one_pass": (17_001, 20), "edges_two_pass": (19_999, 23)}[name]
    keys = rng.integers(0, 1 << bits, n).astype(np.int32)
    if name in ("negatives", "five_values", "two_pass", "edges_one_pass", "edges_two_pass"):
        keys[rng.random(n) < 0.15] = -1
    if name.startswith("edges"):                           # the domain's ends, many times
        keys[rng.random(n) < 0.1] = 0
        keys[rng.random(n) < 0.1] = (1 << bits) - 1
    keys[:40] = keys[40]                                   # ties
    vals = [torch.arange(n, dtype=torch.int32)]
    if name == "f64_bits":
        f = rng.normal(size=n)
        f[::5], f[1::5] = np.nan, -0.0
        vals.append(torch.from_numpy(f))
    if name == "five_values":
        vals += [torch.from_numpy(rng.integers(-9, 9, n) * j) for j in range(1, 5)]
    return torch.from_numpy(keys), vals, bits


def _bits(v):
    return v.view(torch.int64) if v.dtype == torch.float64 else v.long()


@pytest.mark.parametrize("name", ["ragged", "negatives", "f64_bits", "five_values",
                                  "two_pass", "edges_one_pass", "edges_two_pass"])
def test_routes_agree(name):
    """merge_tiles 1 (kernel C), 2 and 4 (kernels F, G): the same base and
    the same (key, value bits) multiset in every window, every value
    paired with its own row's key."""
    keys, vals, bits = _route_case(name)
    valid = int((keys >= 0).sum())
    seen = []
    for merge_tiles in (1, 2, 4):
        tile = None if merge_tiles == 1 else TILE
        pk, pv, base, G = rp.radix_partition(keys, vals, bits, tile=tile,
                                             merge_tiles=merge_tiles)
        assert int(base[-1]) == valid and len(pv) == len(vals) and pk.shape == keys.shape
        rows = pv[0][:valid].long()
        assert torch.equal(keys[rows], pk[:valid])
        for v, p in zip(vals, pv):
            assert torch.equal(_bits(v[rows]), _bits(p[:valid]))
        seen.append((base, [_windows(pk.numpy(), _bits(p).numpy(), base.numpy(), G)
                            for p in pv]))
    for base, wins in seen[1:]:
        assert torch.equal(base, seen[0][0]) and wins == seen[0][1]


@pytest.mark.parametrize("name", ["ragged", "edges_one_pass", "edges_two_pass"])
def test_masked_pass_keeps_the_signed_order(name):
    """The route's single or first pass sorts under mask_bits =
    domain_bits; for keys below 2^domain_bits (and -1) F and G give, bit
    for bit, what they give without the mask."""
    keys, vals, bits = _route_case(name)
    shift = rp.WINDOW_BITS if bits <= MASK else MASK
    nbits, tile = bits - shift, 512
    st = 4 * tile
    offsets, _ = rp.partition_offsets(rp.digit_histogram(keys, nbits, shift, st), align=st)
    out_rows = (-(-keys.shape[0] // st) + (1 << nbits)) * st
    outs = []
    for mask_bits in (None, bits):
        sk, sv = ts.tile_sort_data(keys, vals, tile, alternate=True, mask_bits=mask_bits)
        mk, mv = rp.merge_scatter(sk, sv, offsets, nbits, shift, st, tile, mask_bits, out_rows)
        outs.append([sk, *sv, mk, *mv])
    assert all(torch.equal(a, b) for a, b in zip(*outs))


@pytest.mark.parametrize("alternate", [False, True])
@pytest.mark.parametrize("mask_bits", [None, MASK])
def test_plain_tile_sort_is_a_stable_sort(alternate, mask_bits):
    rng = np.random.default_rng(5)
    n, tile = 5_000, 1024                                  # a short last tile
    keys = rng.integers(-2**31, 2**31, n).astype(np.int32)
    keys[: n // 2] = rng.integers(-2, 3, n // 2)
    f = rng.normal(size=n)
    f[::3] = -0.0
    gk, (gf,) = ts.tile_sort_data(torch.from_numpy(keys), [torch.from_numpy(f)], tile,
                                  alternate=alternate, mask_bits=mask_bits)
    order = ts.sort_key_plain(torch.from_numpy(keys), mask_bits).numpy()
    for t0 in range(0, n, tile):
        idx = t0 + np.argsort(order[t0:t0 + tile], kind="stable")
        if alternate and (t0 // tile) % 2:
            idx = idx[::-1]
        np.testing.assert_array_equal(gk.numpy()[t0:t0 + tile], keys[idx])
        np.testing.assert_array_equal(gf.numpy()[t0:t0 + tile].view(np.int64),
                                      f[idx].view(np.int64))


@pytest.mark.parametrize("merge_tiles", [1, 2, 4])
@pytest.mark.parametrize("mask_bits", [None, MASK])
def test_plain_merge_scatter_is_a_stable_sort(merge_tiles, mask_bits):
    """F then G equals, bit for bit, a stable sort of each supertile of
    the input by its order key, placed bucket by bucket."""
    rng = np.random.default_rng(merge_tiles)
    n, tile = 9_000, 512
    nbits, shift = (rp.PASS_BITS, rp.WINDOW_BITS) if mask_bits else (4, 16)
    high = rng.integers(0, 1 << 5, n) << MASK if mask_bits else 0
    keys = (rng.integers(0, 1 << (shift + nbits), n) + high).astype(np.int32)
    keys[::9] = -7
    keys[100:400] = keys[401]                              # ties across tiles
    vals = [torch.from_numpy(rng.normal(size=n)), torch.arange(n, dtype=torch.int32)]
    tk = torch.from_numpy(keys)
    st = merge_tiles * tile
    hist = rp.digit_histogram(tk, nbits, shift, st)
    offsets, base = rp.partition_offsets(hist)
    sk, sv = ts.tile_sort_data(tk, vals, tile, alternate=True, mask_bits=mask_bits)
    gk, gv = rp.merge_scatter(sk, sv, offsets, nbits, shift, st, tile, mask_bits)
    order = ts.sort_key_plain(tk, mask_bits).numpy()
    idx = np.concatenate([t0 + np.argsort(order[t0:t0 + st], kind="stable")
                          for t0 in range(0, n, st)])
    idx = idx[keys[idx] >= 0]
    digit = (keys[idx] >> shift) & ((1 << nbits) - 1)
    idx = idx[np.argsort(digit, kind="stable")]            # bucket-major, supertiles in order
    m = int(base[-1])
    assert m == idx.size
    np.testing.assert_array_equal(gk.numpy()[:m], keys[idx])
    np.testing.assert_array_equal(gv[0].numpy()[:m].view(np.int64),
                                  vals[0].numpy()[idx].view(np.int64))
    np.testing.assert_array_equal(gv[1].numpy()[:m], idx)


def test_merge_scatter_padded_regions_and_checks():
    """out_rows: rows no run covers hold key -1 and zero payloads (a
    first pass's regions padded to whole supertiles)."""
    n, tile, st, nbits, shift = 3000, 256, 1024, 2, 20
    keys = torch.randint(0, 1 << 22, (n,), generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    vals = [torch.ones(n, dtype=torch.float64)]
    offsets, base = rp.partition_offsets(rp.digit_histogram(keys, nbits, shift, st), align=st)
    assert (base % st == 0).all()
    out_rows = (-(-n // st) + (1 << nbits)) * st
    sk, sv = ts.tile_sort_data(keys, vals, tile, alternate=True)
    pk, (pv,) = rp.merge_scatter(sk, sv, offsets, nbits, shift, st, tile, out_rows=out_rows)
    assert pk.shape == (out_rows,) and int((pk >= 0).sum()) == n
    assert torch.equal(pv, (pk >= 0).double())
    for g in range(1 << nbits):
        w = pk[int(base[g]):int(base[g + 1])]
        real = w[w >= 0]
        assert ((real >> shift) == g).all() and (w[real.shape[0]:] == -1).all()
    with pytest.raises(ValueError, match="mask_bits"):
        rp.merge_scatter(sk, sv, offsets, nbits, shift, st, tile, mask_bits=20)
    with pytest.raises(ValueError, match="multiple"):
        rp.merge_scatter(sk, sv, offsets, nbits, shift, st, 300)
    with pytest.raises(ValueError, match="tile"):
        ts.tile_sort_data(keys, vals, ts.MAX_TILE + 1)
    with pytest.raises(ValueError, match="power of two"):
        rp.radix_partition(keys, vals, 22, merge_tiles=3)


def test_partition_offsets_with_regions():
    """Tiles 0-1 in region 0, tile 2 in region 1 (the second pass's
    layout): windows are region-major, tiles in order inside."""
    hist = torch.tensor([[3, 0], [1, 2], [4, 5]], dtype=torch.int32)
    region = torch.tensor([0, 0, 1])
    offsets, base = rp.partition_offsets(hist, region, 2)
    assert base.tolist() == [0, 4, 6, 10, 15]
    assert offsets.tolist() == [[0, 4], [3, 4], [6, 10]]
    _, aligned = rp.partition_offsets(hist, align=4)
    assert aligned.tolist() == [0, 8, 16]
