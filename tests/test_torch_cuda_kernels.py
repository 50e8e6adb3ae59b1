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
    ek, (er, ev) = rp.radix_scatter_plain(keys, [rows, vals], offsets, nbits, rp.WINDOW_BITS,
                                          tile)
    m = int(base[-1])
    assert m == int((keys >= 0).sum())
    win = torch.repeat_interleave(torch.arange(1 << nbits, device=dev), base[1:] - base[:-1])
    assert torch.equal(pk[:m].long() >> rp.WINDOW_BITS, win)
    assert torch.equal(pk[:m], ek[:m]) and torch.equal(pr[:m], er[:m])   # stable: row for row
    assert _same_bits(pv[:m], ev[:m])
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
    keys, cols = _sort_inputs(dev, n, merge_tiles * n, mask_bits, widths)
    gk = _merge_matches_plain(keys, cols, 4096, merge_tiles, 7, mask_bits)
    assert int((gk >= 0).sum()) == int((keys >= 0).sum())


def _merge_matches_plain(keys, cols, tile, merge_tiles, nbits, mask_bits):
    """Kernel G over kernel F's output against the plain merge, bit for
    bit: without out_rows in the valid rows, and with out_rows (a first
    pass's padded regions) in every row, the outputs allocated over junk
    since the kernel has no prefill.  Returns the out_rows call's keys."""
    n, shift, st = keys.numel(), rp.WINDOW_BITS, merge_tiles * tile
    hist = rp.digit_histogram(keys, nbits, shift, st)
    sk, sc = ts.tile_sort_data(keys, cols, tile, alternate=True, mask_bits=mask_bits)
    for align, out_rows in ((1, None), (st, (-(-n // st) + (1 << nbits)) * st)):
        offsets, base = rp.partition_offsets(hist, align=align)
        rows = n if out_rows is None else out_rows
        _fill_junk((rows,), *[(rows * c.element_size() // 4,) for c in cols])
        before = rp.merge_scatter.launches
        gk, gc = rp.merge_scatter(sk, sc, offsets, nbits, shift, st, tile, mask_bits, out_rows)
        assert rp.merge_scatter.launches == before + 1
        ek, ec = rp.merge_scatter_plain(sk, sc, offsets, nbits, shift, st, tile, mask_bits,
                                        out_rows)
        m = int(base[-1]) if out_rows is None else out_rows
        assert torch.equal(gk[:m], ek[:m])
        assert all(_same_bits(a[:m], b[:m]) for a, b in zip(gc, ec))
    return gk


@pytest.mark.parametrize("case", ["equal_keys", "one_bucket", "negative_supertile", "nbits_1",
                                  "nbits_max", "short_last_supertile"])
@pytest.mark.parametrize("widths", [(4,), (8, 4), (4, 8, 8), (8, 4, 4, 8)])
@pytest.mark.parametrize("masked", [False, True])
def test_merge_scatter_edge_shapes_match_plain(dev, case, widths, masked):
    """Kernel G where a merge path goes wrong: every key equal across the
    four tiles (stability: ties by tile, then position), a supertile all
    in one bucket, a supertile of only negative keys, 1 and MAX_MERGE_BITS
    digit bits, a last supertile shorter than one tile; 1 to 4 payloads of
    mixed width; under the route's mask or none."""
    tile, st = 4096, 4 * 4096
    nbits = {"nbits_1": 1, "nbits_max": rp.MAX_MERGE_BITS}.get(case, 7)
    n = 3 * st + 1000 if case == "short_last_supertile" else 2 * st + 5000
    keys, cols = _sort_inputs(dev, n, len(widths), rp.WINDOW_BITS + nbits if masked else None,
                              widths, nbits=nbits)
    if case == "equal_keys":
        keys.fill_(3 << rp.WINDOW_BITS | 77)
    elif case == "one_bucket":
        keys[:st] = (keys[:st] & (rp.SPAN - 1)) | (1 << rp.WINDOW_BITS)
    elif case == "negative_supertile":
        keys[st:2 * st] = -1 - keys[st:2 * st].abs()
    _merge_matches_plain(keys, cols, tile, 4, nbits, rp.WINDOW_BITS + nbits if masked else None)


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


@pytest.mark.parametrize("nbits,n,tile", [(1, 50_001, 1000), (4, 100_003, 4096),
                                          (7, 300_007, 16384), (7, 1_000_003, 1 << 19),
                                          (8, 70_001, 50_001), (14, 400_003, 1 << 17),
                                          (14, 2_100_003, 1 << 19)])
@pytest.mark.parametrize("case", ["random", "one_bucket", "negative_tile"])
@pytest.mark.parametrize("widths", [(4,), (8, 4), (4, 8, 8), (8, 4, 4, 8)])
def test_radix_scatter_is_stable_and_matches_plain(dev, nbits, n, tile, case, widths):
    """Kernel C bit for bit against its plain version (a stable argsort by
    digit) in the valid rows: keys and every payload, 1 to 14 digit bits,
    a ragged last tile, negative keys, every key of a tile in one bucket
    or none valid, tiles of one chunk (1000 keys) and of many (up to
    524,288 keys at 2^7), and above SCATTER_BITS the two stable passes
    (two launches)."""
    keys, cols = _sort_inputs(dev, n, nbits + n, None, widths, nbits=nbits)
    if case == "one_bucket":
        keys[:tile] = (keys[:tile] & (rp.SPAN - 1)) | (1 << rp.WINDOW_BITS)
    elif case == "negative_tile":
        keys[tile:2 * tile] = -1
    hist = rp.digit_histogram(keys, nbits, rp.WINDOW_BITS, tile)
    assert torch.equal(hist, rp.digit_histogram_plain(keys, nbits, rp.WINDOW_BITS, tile))
    offsets, base = rp.partition_offsets(hist)
    _fill_junk((n,), *[(n * c.element_size() // 4,) for c in cols])
    before = rp.radix_scatter.launches
    gk, gc = rp.radix_scatter(keys, cols, offsets, nbits, rp.WINDOW_BITS, tile)
    assert rp.radix_scatter.launches == before + (1 if nbits <= rp.SCATTER_BITS else 2)
    ek, ec = rp.radix_scatter_plain(keys, cols, offsets, nbits, rp.WINDOW_BITS, tile)
    m = int(base[-1])
    assert m == int((keys >= 0).sum())
    assert torch.equal(gk[:m], ek[:m])
    assert all(_same_bits(a[:m], b[:m]) for a, b in zip(gc, ec))


@pytest.mark.parametrize("case", ["random", "sorted", "route_sorted", "equal", "unaligned"])
@pytest.mark.parametrize("nbits,tile", [(1, 4096), (4, 16384), (5, 1001), (7, 16384),
                                        (7, 1001), (8, 4096), (14, 1 << 19)])
def test_digit_histogram_shapes_match_plain(dev, case, nbits, tile):
    """Kernel B exact against its plain version over junk-filled memory,
    1 to 14 digit bits: random keys, keys sorted whole and sorted per supertile by the sorted
    route (kernel G's output, as the second pass reads it), every key
    equal, and keys starting off a 16-byte boundary; at 2^14 buckets a
    524,288-key tile is cut over several blocks that add into a zeroed
    row."""
    n = 2_100_003 if nbits == 14 else 300_001
    g = torch.Generator(device=dev).manual_seed(n + nbits)
    keys = torch.randint(0, 1 << (rp.WINDOW_BITS + nbits), (n,), generator=g, device=dev,
                         dtype=torch.int32)
    keys[::9] = -1
    if case == "sorted":
        keys = torch.sort(keys).values
    elif case == "route_sorted":
        keys = rp.radix_partition(keys, [], 21)[0]
    elif case == "equal":
        keys.fill_(5 << rp.WINDOW_BITS | 3)
    elif case == "unaligned":
        keys = keys[1:]
    nt = -(-keys.numel() // tile)
    _fill_junk((nt << nbits,))
    before = rp.digit_histogram.launches
    hist = rp.digit_histogram(keys, nbits, rp.WINDOW_BITS, tile)
    assert rp.digit_histogram.launches == before + 1
    assert torch.equal(hist, rp.digit_histogram_plain(keys, nbits, rp.WINDOW_BITS, tile))


def test_partition_cut_fills_the_card(dev):
    """The 2^14 scatter route's tiles are cut over several blocks for
    kernel B; the sorted route's are not; kernels B and C report their
    occupancy, C two blocks an SM at G1's payloads (4 + 8 bytes a row)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert rp.tile_parts(-(-10**8 // (1 << 19)), 1 << 19, 14, sms)[0] > 1
    assert rp.tile_parts(-(-10**8 // 16384), 16384, 7, sms) == (1, 16384)
    occ = rp.partition_occupancy("digit_histogram", 14)
    assert occ["blocks_per_sm"] >= 1 and occ["registers"] > 0
    occ = rp.partition_occupancy("radix_scatter", 7, 12)
    assert occ["blocks_per_sm"] == 2 and occ["registers"] > 0


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
    assert rp.bucket_aggregate.launches == before + 1 and unique     # idpay: one launch
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


def _agg_columns(dev, n, dtypes, seed):
    """Value columns of these dtypes: int32 over its whole range and
    int64 within +-2^62, so that the kernel's low words carry and its
    int64 sums wrap; floats of either sign."""
    g = torch.Generator(device=dev).manual_seed(seed)
    cols = []
    for dt in dtypes:
        if dt.is_floating_point:
            c = (torch.randn(n, generator=g, device=dev, dtype=torch.float64) * 100).to(dt)
        else:
            lo, hi = (-2**31, 2**31 - 1) if dt == torch.int32 else (-2**62, 2**62)
            c = torch.randint(lo, hi, (n,), generator=g, device=dev, dtype=dt)
        cols.append(c)
    return cols


MIXED = (torch.int32, torch.int64, torch.float32, torch.float64)


@pytest.mark.parametrize("route", ["sorted", "scatter", "one_window"])
@pytest.mark.parametrize("agg_rows", [1000, rp.AGG_ROWS])
@pytest.mark.parametrize("dtypes", [(torch.float64,), (torch.int32, torch.int64, torch.float32),
                                    MIXED, MIXED + (torch.int32, torch.float64)])
def test_bucket_aggregate_columns_match_plain(dev, route, agg_rows, dtypes):
    """Kernel D's list form: mixed dtypes in one launch (one to three
    columns; four and six take two launches), windows of one step
    (AGG_ROWS) and of several (1000 rows), empty windows first, in the
    middle and last, whose slots must read 0, over the sorted route's
    runs, kernel C's unsorted ones and one unpartitioned window in input
    order; outputs allocated over junk, since the kernel writes every
    slot itself."""
    n = 300_001
    g = torch.Generator(device=dev).manual_seed(n + len(dtypes) + agg_rows)
    vals = _agg_columns(dev, n, dtypes, len(dtypes))
    if route == "one_window":
        pk = torch.randint(-3, rp.SPAN, (n,), generator=g, device=dev, dtype=torch.int32)
        pv, base, G = vals, torch.tensor([0, n], device=dev), 1
    else:
        keys = torch.randint(2 * rp.SPAN, 60 * rp.SPAN, (n,), generator=g, device=dev,
                             dtype=torch.int32)         # windows 0, 1 and 60-63 empty
        keys = torch.where((keys >> rp.WINDOW_BITS) == 30, keys + rp.SPAN, keys)
        keys[::17] = -1
        pk, pv, base, G = rp.radix_partition(keys, vals, 19,
                                             merge_tiles=4 if route == "sorted" else 1)
        assert G == 64 and int(base[31] - base[30]) == 0
    _fill_junk(*[(2 * G * rp.SPAN,)] * (len(dtypes) + 1))
    before = rp.bucket_aggregate.launches
    sums, counts = rp.bucket_aggregate(pk, pv, base, G, agg_rows=agg_rows)
    assert rp.bucket_aggregate.launches == before + -(-len(dtypes) // rp.MAX_AGG_COLUMNS)
    exp, e_counts = rp.bucket_aggregate_plain(pk, pv, base, G)
    assert torch.equal(counts, e_counts)
    for s, e in zip(sums, exp):
        assert s.dtype == e.dtype and _close(s.cpu(), e.cpu())
    empty = torch.nonzero(base[1:] == base[:-1]).squeeze(1)
    slots = (empty.unsqueeze(1) * rp.SPAN + torch.arange(rp.SPAN, device=dev)).view(-1)
    assert all(bool((t[slots] == 0).all()) for t in [counts] + sums)
    one = rp.bucket_aggregate(pk, pv[-1], base, G, agg_rows=agg_rows, with_counts=False)
    assert one[1] is None and _close(one[0].cpu(), exp[-1].cpu())


@pytest.mark.parametrize("pay_dtype", [torch.float32, torch.float64, torch.int64])
@pytest.mark.parametrize("agg_rows", [500, rp.AGG_ROWS])
def test_window_tables_idpay_one_launch_copies_bits(dev, pay_dtype, agg_rows):
    """Kernel D's id + idpay in one launch: id + 1 and the payload's bits
    exactly (NaN, -0.0 and int64 beyond 2^53), 0 in every empty slot,
    over a partitioned build with empty windows, outputs over junk."""
    g = torch.Generator(device=dev).manual_seed(agg_rows)
    dom, n_r = 1 << 20, 200_000
    rk = torch.randperm(dom // 2, generator=g, device=dev)[:n_r].int()   # windows 64-127 empty
    rk[::23] = -1
    if pay_dtype.is_floating_point:
        rv = (torch.randn(n_r, generator=g, device=dev, dtype=torch.float64) * 1e9).to(pay_dtype)
        rv[::7], rv[1::7] = float("nan"), -0.0
    else:
        rv = torch.randint(-2**62, 2**62, (n_r,), generator=g, device=dev)
    rid1 = torch.arange(1, n_r + 1, dtype=torch.int32, device=dev)
    pk, (pr, pp), base, G = rp.radix_partition(rk, [rid1, rp.payload_bits(rv)], 20)
    _fill_junk(*[(2 * G * rp.SPAN,)] * 3)
    before = rp.bucket_aggregate.launches
    ids, counts, pay = rp.window_tables(pk, pr, base, G, pp, agg_rows=agg_rows)
    assert rp.bucket_aggregate.launches == before + 1
    ok = rk >= 0
    want = torch.zeros(G * rp.SPAN, dtype=torch.int64, device=dev)
    want[rk[ok].long()] = torch.nonzero(ok).squeeze(1) + 1
    assert torch.equal(ids, want) and torch.equal(counts, (want > 0).long())
    bits = torch.zeros_like(want)
    bits[rk[ok].long()] = rp.payload_bits(rv)[ok].long()
    assert torch.equal(pay, bits)
    got = rp._from_bits(pay[rk[ok].long()], pay_dtype)
    assert _same_bits(got, rv[ok])


@pytest.mark.parametrize("K", [1, 100, 4096])
@pytest.mark.parametrize("masked", [False, True])
def test_onehot_columns_match_plain(dev, K, masked):
    """Kernel A's list form: int32, int64, float32 and float64 columns
    (NaN in the floats, integers over a wide range) in one call, min
    and max on three of them, in as many launches as column_launches
    gives (one at K = 1 and 100, two at 4096), with and without a mask."""
    n = 300_003
    g = torch.Generator(device=dev).manual_seed(n + K)
    keys = torch.randint(-2, K + 2, (n,), generator=g, device=dev, dtype=torch.int32)
    vals = _agg_columns(dev, n, MIXED, K)
    for v in vals[2:]:      # NaN in some groups' rows; groups 2, 9, ... only NaN
        v[(keys % 3 == 1) & (torch.rand(n, generator=g, device=dev) < 0.3)] = float("nan")
        v[keys % 7 == 2] = float("nan")
    valid = (torch.rand(n, generator=g, device=dev) > 0.2) if masked else None
    flags = [True, False, True, True]
    before = ha.onehot_groupby_aggregate.launches
    got = ha.onehot_groupby_aggregate(keys, vals, K, valid=valid, with_minmax=flags)
    assert ha.onehot_groupby_aggregate.launches == before + len(ha.column_launches(K, flags))
    assert len(ha.column_launches(K, flags)) == (2 if K == 4096 else 1)
    exp = ha.onehot_groupby_aggregate_plain(keys, vals, K, valid=valid, with_minmax=flags)
    assert torch.equal(got[1], exp[1])
    for part in (0, 2, 3):
        for a, b in zip(got[part], exp[part]):
            assert (a is None) == (b is None)
            if a is not None:
                assert a.dtype == b.dtype and _close(a.cpu(), b.cpu())


def test_onehot_tier_launches_once_per_mask(dev):
    """Through DataFrame.groupby().agg: requests under one mask share a
    kernel A launch, and columns whose null masks differ take one each;
    the result equals the CPU's."""
    import numpy as np
    import pandas as pd
    import cudf_tpu_torch as ct

    rng = np.random.default_rng(3)
    n = 200_000
    pdf = pd.DataFrame({"k": rng.integers(0, 100, n), "x": rng.integers(-9, 9, n),
                        "y": rng.normal(size=n), "f": rng.normal(size=n),
                        "h": rng.normal(size=n).astype(np.float32)})
    pdf.loc[rng.random(n) < 0.2, "f"] = np.nan
    pdf.loc[rng.random(n) < 0.3, "h"] = np.nan
    spec = {"x": ["sum", "max"], "y": "mean", "f": ["sum", "min"], "h": "max"}
    before = ha.onehot_groupby_aggregate.launches
    got = ct.from_pandas(pdf, device=dev).groupby("k").agg(spec).to_pandas()
    assert ha.onehot_groupby_aggregate.launches == before + 3    # x and y; f; h
    exp = ct.from_pandas(pdf, device=torch.device("cpu")).groupby("k").agg(spec).to_pandas()
    pd.testing.assert_frame_equal(got, exp, check_exact=False, rtol=1e-12, atol=1e-9)


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
