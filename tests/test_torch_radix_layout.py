"""The radix route's layout helpers and kernel C's plain version
(``cudf_tpu_torch.kernels.radix_partition``: ``step_table``,
``tile_parts``, ``partition_offsets``, ``choose_tile``,
``radix_scatter_plain``, ``two_pass_scatter``) on the CPU, against numpy
and the one-pass scatter.  The tests against the reference's kernels are
in ``tests/test_torch_radix_partition.py``."""

import numpy as np
import pytest
import torch

from cudf_tpu_torch.kernels import radix_partition as rp
from torch_radix_partition_helpers import rng


@pytest.mark.parametrize("nbits,n,tile", [(1, 3001, 1000), (7, 20_000, 4096),
                                          (7, 20_001, 1024), (14, 20_003, 2048)])
def test_radix_scatter_plain_is_stable(rng, nbits, n, tile):
    """The scatter's contract, row for row: valid row i goes to slot
    offsets[tile, digit] plus the number of earlier valid rows of its tile
    with its digit (runs in input order), negative keys dropped, ragged
    last tile included; computed here with numpy, independently of the
    plain version's argsort."""
    keys = rng.integers(0, 1 << (13 + nbits), n).astype(np.int32)
    keys[::7] = -1
    keys[tile // 2:tile] = 3 << 13 if nbits > 1 else 1 << 13   # a long run in one bucket
    tk = torch.from_numpy(keys)
    rows = torch.arange(n, dtype=torch.int32)
    pay = torch.from_numpy(rng.normal(size=n))
    hist = rp.digit_histogram(tk, nbits, 13, tile)
    offsets, base = rp.partition_offsets(hist)
    ok, (orow, opay) = rp.radix_scatter(tk, [rows, pay], offsets, nbits, 13, tile)
    valid = np.flatnonzero(keys >= 0)
    group = (valid // tile) * (1 << nbits) + ((keys[valid] >> 13) & ((1 << nbits) - 1))
    order = np.argsort(group, kind="stable")
    sorted_group = group[order]
    first = np.searchsorted(sorted_group, sorted_group)
    within = np.empty(valid.size, np.int64)
    within[order] = np.arange(valid.size) - first
    slot = offsets.numpy().ravel()[group] + within
    m = int(base[-1])
    assert m == valid.size and sorted(slot.tolist()) == list(range(m))
    exp_rows = np.empty(m, np.int64)
    exp_rows[slot] = valid
    np.testing.assert_array_equal(orow.numpy()[:m], exp_rows)
    np.testing.assert_array_equal(ok.numpy()[:m], keys[exp_rows])
    np.testing.assert_array_equal(opay.numpy()[:m].view(np.int64),
                                  pay.numpy()[exp_rows].view(np.int64))


@pytest.mark.parametrize("nbits", [8, 11, 14])
def test_two_pass_scatter_equals_one_stable_pass(rng, nbits):
    """Kernel C's wrapper above SCATTER_BITS digit bits (host glue of the
    CUDA path): two stable passes, low bits then high, give the one-pass
    stable partition row for row.  Each pass here is the plain one over
    outputs filled with junk keys, as memory from torch.empty may hold:
    the first pass's rows past its valid ones must still be dropped."""
    def junk_pass(keys, payloads, offsets, nbits, shift, tile, out_keys=None):
        if out_keys is None:
            out_keys = torch.full_like(keys, 12345)
        return rp.radix_scatter_plain(keys, payloads, offsets, nbits, shift, tile, out_keys)

    n = 20_011
    keys = torch.from_numpy(rng.integers(0, 1 << (13 + nbits), n).astype(np.int32))
    keys[::5] = -1
    pays = [torch.arange(n, dtype=torch.int32), torch.from_numpy(rng.normal(size=n))]
    gk, (gr, gp) = rp.two_pass_scatter(keys, pays, nbits, 13, junk_pass)
    offsets, base = rp.partition_offsets(rp.digit_histogram(keys, nbits, 13, 4096))
    ek, (er, ep) = rp.radix_scatter_plain(keys, pays, offsets, nbits, 13, 4096)
    m = int(base[-1])
    assert m == int((keys >= 0).sum())
    assert torch.equal(gk[:m], ek[:m]) and torch.equal(gr[:m], er[:m])
    assert torch.equal(gp[:m].view(torch.int64), ep[:m].view(torch.int64))


@pytest.mark.parametrize("n_tiles,tile,nbits,sms,parts", [
    (191, 1 << 19, 14, 132, 2),        # the scatter route's 2^14 at 1e8 keys
    (6104, 1 << 14, 7, 132, 1),        # the sorted route's supertiles at 1e8 keys
    (4, 1 << 19, 14, 132, 4),          # capped: parts of 8 keys a bucket
    (5, 1024, 7, 132, 1),              # tiles below one chunk are never cut
    (2, 50_001, 4, 132, 12),           # a tile that is no multiple of 4
    (100, 1 << 14, 7, 132, 3)])        # short of 2 blocks an SM: 3 parts
def test_tile_parts_cuts_tiles_that_leave_the_card_idle(n_tiles, tile, nbits, sms, parts):
    """Kernel B's cut of each tile (host glue of the CUDA path):
    parts of whole multiples of 4 keys that cover the tile, none empty."""
    got, part_len = rp.tile_parts(n_tiles, tile, nbits, sms)
    assert got == parts
    assert part_len % 4 == 0 and got * part_len >= tile > (got - 1) * part_len


def test_partition_offsets_and_tile_choice():
    hist = torch.tensor([[3, 0, 2], [1, 4, 0]], dtype=torch.int32)
    offsets, base = rp.partition_offsets(hist)
    assert offsets.tolist() == [[0, 4, 8], [3, 4, 10]]
    assert base.tolist() == [0, 4, 8, 10]
    assert rp.choose_tile(10**8, 7) == 1 << 12
    assert rp.choose_tile(10**8, 14) == 1 << 19
    for n, nbits in [(10**8, 14), (3 * 10**7, 10), (1000, 1)]:
        tile = rp.choose_tile(n, nbits)
        assert -(-n // tile) << nbits <= 2 * rp.MAX_TABLE and tile >= rp.MIN_TILE


@pytest.mark.parametrize("sizes", [[0, 0, 5, 0], [100, 3, 0, 57], [1, 1, 1],
                                   [1000, 0, 0, 0, 1]])
@pytest.mark.parametrize("agg_rows", [1, 7, 64])
def test_step_table_covers_every_row_once(sizes, agg_rows):
    """The CUDA path's step table (torch glue): every partitioned row falls
    in exactly one live step of its own window, none longer than agg_rows."""
    base = torch.tensor([0] + list(np.cumsum(sizes)), dtype=torch.int64)
    n = int(base[-1]) + 3                       # rows past base[-1] unused
    win, lo, hi = rp.step_table(base, n, agg_rows)
    seen = np.zeros(n, int)
    for w, a, b in zip(win.tolist(), lo.tolist(), hi.tolist()):
        if w < 0:
            continue
        assert base[w] <= a < b <= base[w + 1] and b - a <= agg_rows
        seen[a:b] += 1
    assert (seen[:int(base[-1])] == 1).all() and (seen[int(base[-1]):] == 0).all()
