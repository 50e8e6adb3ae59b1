"""The CUDA kernels A-H against their plain PyTorch versions on the card.

Marked ``cuda``: without a CUDA device every test here skips (decided in
the fixture, never at import).  On a machine with an H100 run
``python -m pytest tests/test_torch_cuda_kernels.py -q``; it builds the
kernels first.  Tolerances: counts, histograms, integer sums, min/max and
partition multisets exact; float64 sums rtol 1e-12 plus atol 1e-9, since
atomics add in a varying order and sums of signed values cancel to near
zero (the terms here are below 500 in magnitude, fewer than 1e5 a group).
The join tables and probes (kernel D's id/idpay modes, kernel H) are
exact: they hold and copy build row ids and payload bits; H's outputs are
checked after the caching allocator was filled with junk, since the
kernel writes every row itself.  The sorted
route's kernels (E and F, the tile sort; G, the merge and scatter) match
bit for bit: both sides are stable sorts.
"""

import pytest
import torch

from cudf_tpu_torch.kernels import hash_aggregate as ha
from cudf_tpu_torch.kernels import radix_partition as rp
from cudf_tpu_torch.kernels import tile_sort as ts

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _close(a, b):
    if a.dtype.is_floating_point:
        return torch.allclose(a, b, rtol=1e-12, atol=1e-9, equal_nan=True)
    return torch.equal(a, b)


@pytest.mark.parametrize("n,K", [(1, 1), (1000, 7), (200_000, 100), (300_000, 4096)])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.float32,
                                   torch.float64, torch.bool])
def test_onehot_kernel_matches_plain(dev, n, K, dtype):
    g = torch.Generator(device=dev).manual_seed(n + K)
    keys = torch.randint(-2, K + 2, (n,), generator=g, device=dev, dtype=torch.int32)
    if dtype == torch.bool:
        vals = torch.rand(n, generator=g, device=dev) > 0.5
    elif dtype.is_floating_point:
        vals = torch.randn(n, generator=g, device=dev, dtype=dtype) * 100
        vals[torch.rand(n, generator=g, device=dev) < 0.1] = float("nan")
        vals[keys % 5 == 1] = float("nan")                 # groups of only NaN
        vals[::97] = -float("nan")                         # NaN with the sign bit
    else:
        vals = torch.randint(-2**20, 2**20, (n,), generator=g, device=dev, dtype=dtype)
    valid = torch.rand(n, generator=g, device=dev) > 0.2
    for mask in (None, valid):
        before = ha.onehot_groupby_aggregate.launches
        got = ha.onehot_groupby_aggregate(keys, vals, K, valid=mask)
        exp = ha.onehot_groupby_aggregate_plain(keys, vals, K, valid=mask)
        assert ha.onehot_groupby_aggregate.launches == before + 1
        for a, b in zip(got, exp):
            assert a.dtype == b.dtype and _close(a.cpu(), b.cpu())


@pytest.mark.parametrize("n,K,tile", [(5000, 1_000_000, 1024), (400_000, 30_000, None),
                                      (300_000, 1 << 27, None)])
def test_radix_kernels_match_plain(dev, n, K, tile):
    g = torch.Generator(device=dev).manual_seed(n)
    keys = torch.randint(0, K, (n,), generator=g, device=dev, dtype=torch.int32)
    keys[::11] = -1
    nbits = (K - 1).bit_length() - rp.WINDOW_BITS
    tile = rp.choose_tile(n, nbits) if tile is None else tile
    hist = rp.digit_histogram(keys, nbits, rp.WINDOW_BITS, tile)
    assert torch.equal(hist, rp.digit_histogram_plain(keys, nbits, rp.WINDOW_BITS, tile))
    offsets, base = rp.partition_offsets(hist)
    vals = torch.randn(n, generator=g, device=dev, dtype=torch.float64)
    rows = torch.arange(n, device=dev, dtype=torch.int32)
    pk, (pr, pv) = rp.radix_scatter(keys, [rows, vals], offsets, nbits, rp.WINDOW_BITS, tile)
    m = int(base[-1])
    win = torch.repeat_interleave(torch.arange(1 << nbits, device=dev), base[1:] - base[:-1])
    assert torch.equal(pk[:m].long() >> rp.WINDOW_BITS, win)
    assert torch.equal(keys[pr[:m].long()], pk[:m]) and torch.equal(vals[pr[:m].long()], pv[:m])
    assert torch.equal(torch.sort(pr[:m]).values, torch.nonzero(keys >= 0).squeeze(1).int())
    for agg_rows in (1000, rp.AGG_ROWS):
        s, c = rp.bucket_aggregate(pk, pv, base, 1 << nbits, agg_rows=agg_rows)
        es, ec = rp.bucket_aggregate_plain(pk, pv, base, 1 << nbits)
        assert _close(s.cpu(), es.cpu()) and torch.equal(c, ec)
    s, c = rp.radix_groupby_sum_count(keys, vals, K)
    ok = keys >= 0
    es = torch.zeros(K, dtype=torch.float64, device=dev).index_add_(0, keys[ok].long(), vals[ok])
    assert _close(s.cpu(), es.cpu())
    assert torch.equal(c, torch.bincount(keys[ok].long(), minlength=K))


@pytest.mark.parametrize("nvals", [5, 9])
def test_radix_pipeline_many_values_match_plain(dev, nvals):
    """More values than one partition launch carries: each stays paired
    with its own key through the row ids that launch carries."""
    n, K = 2_000_000, 1_000_000
    g = torch.Generator(device=dev).manual_seed(nvals)
    keys = torch.randint(0, K, (n,), generator=g, device=dev, dtype=torch.int32)
    vals = [torch.randint(-999, 999, (n,), generator=g, device=dev, dtype=torch.int32)
            * (j + 1) for j in range(nvals)]
    sums, c = rp.radix_groupby_sum_count(keys, vals, K)
    k = keys.long()
    assert torch.equal(c, torch.bincount(k, minlength=K))
    for s, v in zip(sums, vals):
        assert torch.equal(s, torch.zeros(K, dtype=torch.int64, device=dev).index_add_(
            0, k, v.long()))


def test_cuda_path_raises_and_never_falls_back(dev):
    keys = torch.zeros(10, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        ha.onehot_groupby_aggregate(keys, torch.ones(10), 3)        # vals on CPU
    with pytest.raises(ValueError):
        rp.digit_histogram(keys.long(), 3, 13, 1024)                # int64 keys
    with pytest.raises(ValueError):
        ts.tile_sort(keys, torch.ones(10, dtype=torch.int32), tile=8)   # rider on CPU
    with pytest.raises(ValueError):
        ts.tile_sort_data(keys, [], ts.MAX_TILE * 2)                  # tile too large
    with pytest.raises(ValueError):
        ts.tile_sort_data(keys, [torch.ones(10, dtype=torch.int16, device=dev)], 8)
    offsets = torch.zeros(1, 4, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        rp.merge_scatter(keys, [], offsets, 2, 13, 16, 8, mask_bits=20)   # mask != 15
    with pytest.raises(ValueError):
        rp.merge_scatter(keys, [], offsets.cpu(), 2, 13, 16, 8)        # offsets on CPU
    with pytest.raises(ValueError):
        rp.window_probe(keys, torch.tensor([0, 10], device=dev),
                        torch.zeros(1, rp.SPAN, dtype=torch.int64, device=dev),
                        stage_min_rows=0)
    before = (ts.tile_sort.launches, ts.tile_sort_data.launches, rp.merge_scatter.launches)
    ts.tile_sort(keys, tile=8)
    ts.tile_sort_data(keys, [], 8, alternate=True)
    rp.merge_scatter(keys, [], offsets, 2, 13, 16, 8)
    assert (ts.tile_sort.launches, ts.tile_sort_data.launches,
            rp.merge_scatter.launches) == tuple(b + 1 for b in before)


def _sort_inputs(dev, n, seed, mask_bits, widths, nbits=7):
    """int32 keys with ties and negatives (below 2^(13 + nbits), or with
    random bits above a mask) and payload columns of the given widths,
    float64 ones with NaN and -0.0."""
    g = torch.Generator(device=dev).manual_seed(seed)
    keys = torch.randint(0, 1 << (rp.WINDOW_BITS + nbits), (n,), generator=g, device=dev,
                         dtype=torch.int32)
    if mask_bits is not None:
        keys |= torch.randint(0, 1 << min(10, 31 - mask_bits), (n,), generator=g, device=dev,
                              dtype=torch.int32) << mask_bits
    keys[::13] = -5
    keys[7:n // 3:3] = keys[1]                    # ties across tiles
    cols = []
    for j, w in enumerate(widths):
        if w == 8:
            c = torch.randn(n, generator=g, device=dev, dtype=torch.float64)
            c[j::7], c[j + 1::7] = float("nan"), -0.0
        else:
            c = torch.randint(-2**31, 2**31 - 1, (n,), generator=g, device=dev,
                              dtype=torch.int32)
        cols.append(c)
    return keys, cols


def _same_bits(a, b):
    return a.dtype == b.dtype and torch.equal(a.view(torch.uint8), b.view(torch.uint8))


@pytest.mark.parametrize("n,tile", [(3 * 4096, 4096), (100_003, 4096), (50_001, 1000)])
@pytest.mark.parametrize("alternate", [False, True])
@pytest.mark.parametrize("mask_bits", [None, 1, 7, 8, 20, 21, 27, 30])
@pytest.mark.parametrize("widths", [(), (4,), (8, 4), (8, 8, 4, 4)])
def test_tile_sort_kernels_match_plain(dev, n, tile, alternate, mask_bits, widths):
    """Kernels E and F: bit for bit the stable per-tile sort, over 32
    order bits or 2 to 31 under a mask (one to four 8-bit passes, the
    last narrower), with short tiles."""
    keys, cols = _sort_inputs(dev, n, n + len(widths), mask_bits, widths)
    before = (ts.tile_sort.launches, ts.tile_sort_data.launches)
    gk, gc = ts.tile_sort_data(keys, cols, tile, alternate=alternate, mask_bits=mask_bits)
    ek, ec = ts.tile_sort_data_plain(keys, cols, tile, alternate, mask_bits)
    assert torch.equal(gk, ek) and all(_same_bits(a, b) for a, b in zip(gc, ec))
    out = ts.tile_sort(keys, *cols, tile=tile, alternate=alternate, mask_bits=mask_bits)
    assert torch.equal(out[0], ek) and all(_same_bits(a, b) for a, b in zip(out[1:], ec))
    assert (ts.tile_sort.launches, ts.tile_sort_data.launches) == (before[0] + 1,
                                                                    before[1] + 1)


@pytest.mark.parametrize("merge_tiles", [1, 2, 4])
@pytest.mark.parametrize("mask_bits", [None, 20])
@pytest.mark.parametrize("n", [3 * 16384, 70_001])
@pytest.mark.parametrize("widths", [(), (4,), (8, 4, 8, 4)])
def test_merge_scatter_matches_plain(dev, merge_tiles, mask_bits, n, widths):
    """Kernel G over kernel F's output: bit for bit the plain merge, in the
    valid rows and, with out_rows, in every padded row too."""
    tile = 4096
    nbits, shift, st = 7, rp.WINDOW_BITS, merge_tiles * tile
    keys, cols = _sort_inputs(dev, n, merge_tiles * n, mask_bits, widths)
    hist = rp.digit_histogram(keys, nbits, shift, st)
    sk, sc = ts.tile_sort_data(keys, cols, tile, alternate=True, mask_bits=mask_bits)
    for align, out_rows in ((1, None), (st, (-(-n // st) + (1 << nbits)) * st)):
        offsets, base = rp.partition_offsets(hist, align=align)
        before = rp.merge_scatter.launches
        gk, gc = rp.merge_scatter(sk, sc, offsets, nbits, shift, st, tile, mask_bits, out_rows)
        assert rp.merge_scatter.launches == before + 1
        ek, ec = rp.merge_scatter_plain(sk, sc, offsets, nbits, shift, st, tile, mask_bits,
                                        out_rows)
        m = int(base[-1]) if out_rows is None else out_rows
        assert torch.equal(gk[:m], ek[:m])
        assert all(_same_bits(a[:m], b[:m]) for a, b in zip(gc, ec))
    assert int((gk >= 0).sum()) == int((keys >= 0).sum())


@pytest.mark.parametrize("bits", [17, 21, 27])
def test_radix_partition_routes_agree(dev, bits):
    """merge_tiles 1 (kernel C) and 4 (kernels F and G, two passes above
    20 bits): the same windows; the sorted route is the CPU's bit for bit."""
    n = 1_000_003
    keys, (rows, f) = _sort_inputs(dev, n, bits, None, (4, 8), nbits=bits - rp.WINDOW_BITS)
    rows = torch.arange(n, dtype=torch.int32, device=dev)
    outs = {}
    for mt in (1, 4):
        pk, (pr, pf), base, G = rp.radix_partition(keys, [rows, f], bits, merge_tiles=mt)
        m = int(base[-1])
        assert m == int((keys >= 0).sum())
        win = torch.repeat_interleave(torch.arange(G, device=dev), base[1:] - base[:-1])
        assert torch.equal(pk[:m].long() >> rp.WINDOW_BITS, win)
        assert torch.equal(keys[pr[:m].long()], pk[:m]) and _same_bits(f[pr[:m].long()], pf[:m])
        order = torch.argsort(pr[:m].long() + win * n)     # by window, then row
        outs[mt] = (base, pk[:m][order], pr[:m][order])
    assert all(torch.equal(a, b) for a, b in zip(outs[1], outs[4]))
    gk, (gr, gf), gbase, _ = rp.radix_partition(keys, [rows, f], bits)
    ek, (er, ef), ebase, _ = rp.radix_partition(keys.cpu(), [rows.cpu(), f.cpu()], bits)
    m = int(ebase[-1])
    assert torch.equal(gbase.cpu(), ebase) and torch.equal(gk[:m].cpu(), ek[:m])
    assert torch.equal(gr[:m].cpu(), er[:m]) and _same_bits(gf[:m].cpu(), ef[:m])


def _partitioned(dev, G, n, seed):
    """(pkeys, base) of n probe keys over G windows, window 1 left empty
    and every 13th key negative (so rows past base[-1] hold garbage)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    keys = torch.randint(0, G * rp.SPAN, (n,), generator=g, device=dev, dtype=torch.int32)
    if G == 1:
        keys[::13] = -1
        return keys, torch.tensor([0, n], device=dev)
    keys = torch.where((keys >> rp.WINDOW_BITS) == 1, keys + rp.SPAN, keys)
    keys[::13] = -1
    pk, _, base, _ = rp.radix_partition(keys, [], rp.domain_bits(G * rp.SPAN))
    assert int(base[2] - base[1]) == 0 and int(base[-1]) < n
    return pk, base


@pytest.mark.parametrize("m,pay_dtype", [(1, None), (2, None), (3, None), (4, None),
                                         (1, torch.int64), (1, torch.float32),
                                         (1, torch.float64)])
@pytest.mark.parametrize("G", [1, 16])
def test_window_probe_matches_plain(dev, m, pay_dtype, G):
    """Kernel H: single window and partitioned probes, an empty window
    (no rows, and a table of zeros), empty slots and rows past base[-1]."""
    g = torch.Generator(device=dev).manual_seed(m * 10 + G)
    pk, base = _partitioned(dev, G, 400_000, seed=G)
    tables = torch.randint(0, 1 << 20, (m, G * rp.SPAN), generator=g, device=dev)
    tables[torch.rand(tables.shape, generator=g, device=dev) < 0.3] = 0
    tables[:, :rp.SPAN // 2] = 0
    pay = None
    if pay_dtype is not None:
        vals = torch.randn(G * rp.SPAN, generator=g, device=dev, dtype=torch.float64) * 1e6
        vals = vals.to(pay_dtype)
        if pay_dtype.is_floating_point:
            vals[::7] = float("nan")
            vals[1::7] = -0.0
        pay = rp.payload_bits(vals).long()
    for stage_min_rows in (1, rp.STAGE_MIN_ROWS, 1 << 40):   # every window staged, some, none
        before = rp.window_probe.launches
        bids, out = rp.window_probe(pk, base, tables, pay, pay_dtype,
                                    stage_min_rows=stage_min_rows)
        assert rp.window_probe.launches == before + 1
        eb, eo = rp.window_probe_plain(pk, base, tables, pay, pay_dtype)
        assert torch.equal(bids, eb)
        assert (bids[:, int(base[-1]):] == -1).all()
        if pay_dtype is not None:
            assert out.dtype == pay_dtype
            assert torch.equal(rp.payload_bits(out), rp.payload_bits(eo))


def _fill_junk(*shapes):
    """Fill blocks of these int32 shapes with 0x7f bytes and free them:
    the caching allocator hands them to the next allocations of that size."""
    junk = [torch.full(sh, 0x7F7F7F7F, dtype=torch.int32, device="cuda") for sh in shapes]
    torch.cuda.synchronize()
    del junk


@pytest.mark.parametrize("G,n", [(1, 400_003), (16, 1_000_001), (512, 50_001),
                                 (2048, 3_000_001)])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("m,pay_dtype", [(1, None), (3, None), (1, torch.float32),
                                         (1, torch.float64)])
def test_window_probe_writes_every_row(dev, G, n, offset, m, pay_dtype):
    """Kernel H writes every output row: rows per slot far above (G = 1:
    ~49) and far below (G = 512: ~0.01) the staging threshold, each window
    staged, by the threshold, or never; n % 4 != 0, the keys a view at a
    4-byte offset, the outputs allocated over junk."""
    g = torch.Generator(device=dev).manual_seed(G + n + m)
    pk, base = _partitioned(dev, G, n, seed=G + offset)
    if offset:
        pk = torch.cat([pk.new_zeros(1), pk])[1:]
        assert pk.data_ptr() % 16 == 4
    tables = torch.randint(0, 1 << 20, (m, G * rp.SPAN), generator=g, device=dev)
    tables[torch.rand(tables.shape, generator=g, device=dev) < 0.3] = 0
    pay = None
    if pay_dtype is not None:
        vals = (torch.randn(G * rp.SPAN, generator=g, device=dev, dtype=torch.float64)
                * 1e6).to(pay_dtype)
        vals[::5], vals[1::5] = float("nan"), -0.0
        pay = rp.payload_bits(vals).long()
    eb, eo = rp.window_probe_plain(pk, base, tables, pay, pay_dtype)
    for stage_min_rows in (1, rp.STAGE_MIN_ROWS, 1 << 40):
        _fill_junk((m, n), (2 * n,))
        bids, out = rp.window_probe(pk, base, tables, pay, pay_dtype,
                                    stage_min_rows=stage_min_rows)
        assert torch.equal(bids, eb)
        if pay_dtype is not None:
            assert torch.equal(rp.payload_bits(out), rp.payload_bits(eo))


@pytest.mark.parametrize("pay_dtype", [None, torch.int32, torch.float64])
@pytest.mark.parametrize("dom", [5000, 1 << 20])
def test_window_tables_match_plain(dev, pay_dtype, dom):
    """Kernel D's id and idpay modes: id + 1 and payload bits per key,
    0 for an empty slot, and a duplicated key is reported."""
    g = torch.Generator(device=dev).manual_seed(dom)
    n_r = dom // 2
    rk = torch.randperm(dom, generator=g, device=dev)[:n_r].int()
    rk[::17] = -1
    rv = None
    if pay_dtype is not None:
        rv = (torch.randn(n_r, generator=g, device=dev, dtype=torch.float64) * 1e9).to(pay_dtype)
    before = rp.bucket_aggregate.launches
    ids, pay, unique, G = rp.build_join_tables(rk, dom, rv)
    assert rp.bucket_aggregate.launches == before + (1 if rv is None else 2) and unique
    ok = rk >= 0
    exp = torch.zeros(G * rp.SPAN, dtype=torch.int64, device=dev)
    exp[rk[ok].long()] = torch.nonzero(ok).squeeze(1) + 1
    assert torch.equal(ids, exp)
    if rv is not None:
        want = torch.zeros_like(exp)
        want[rk[ok].long()] = rp.payload_bits(rv)[ok].long()
        assert torch.equal(pay, want)
    rk[1] = rk[2]                              # rk[::17] are the negatives
    assert rp.build_join_tables(rk, dom)[2] is False


def test_join_entry_points_match_cpu(dev):
    """radix_join_inner_unique (with a payload) and radix_join_inner_multi
    on the card give the CPU's (probe row, build row, payload) triples."""
    g = torch.Generator().manual_seed(5)
    dom, nl = 300_000, 1_000_000
    rk = torch.randperm(dom, generator=g)[:200_000].int()
    lk = torch.randint(-5, dom, (nl,), generator=g, dtype=torch.int32)
    lv = torch.arange(nl, dtype=torch.int32)
    rv = torch.randn(rk.shape[0], generator=g, dtype=torch.float64)
    dup = torch.cat([rk, rk[:50_000], rk[:10_000]])
    for run in ("unique", "multi"):
        outs = []
        for d in (torch.device("cpu"), dev):
            if run == "unique":
                pk, pv, bid, pay, unique = rp.radix_join_inner_unique(
                    lk.to(d), lv.to(d), rk.to(d), dom, rv=rv.to(d))
                assert unique
                f = bid >= 0
                outs.append(sorted(zip(pv[f].tolist(), bid[f].tolist(), pay[f].tolist())))
            else:
                pk, pv, bids, mult = rp.radix_join_inner_multi(lk.to(d), lv.to(d), dup.to(d), dom)
                assert mult == 3
                f = bids >= 0
                outs.append(sorted(zip(pv.expand_as(bids)[f].tolist(), bids[f].tolist())))
        assert outs[0] == outs[1] and len(outs[0]) > nl // 2
