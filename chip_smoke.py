#!/usr/bin/env python3
"""Drive cudf_tpu_torch's main paths once on one CUDA card, and check them.

Run from the repository root:  python3 chip_smoke.py

With --beside DIR it only builds the kernels and times kernels A and D at
the main path's shapes beside those of the checkout in DIR (e.g. the
parent, unpacked by git archive into build/parent), in one process on
the same data, and prints the times as its last line.

Phases (any failure raises; the exit code is then non-zero and no
result line is printed):

1. device: a CUDA device must be present; print its name and power limit.
2. build: compile the CUDA kernels from cudf_tpu_torch/csrc (one nvcc per
   source, all started together, sm_90a).

The G1 groupby (data G1_1e8_1e2_0_0 of h2oai db-benchmark's
groupby-datagen.R: id4 in 1..100, id6 in 1..1e6, v1 in 1..5, v2 in 1..15,
v3 uniform in [0, 100)), 1e8 rows made on the card from a seeded
torch.Generator:

3. kernels: each kernel (A onehot_groupby_aggregate, B digit_histogram,
   C radix_scatter, F tile_sort_data, G merge_scatter, D
   bucket_aggregate) against its plain PyTorch version on the card, at
   the main path's shapes: 1e8 rows, K = 100 for A and K = 1e6 for the
   rest (7-bit digits; F and G with 4096-key tiles, 16384-key
   supertiles, under mask_bits = 20 as the route calls them, and F once
   more without a mask: the full 32-bit order of the contract and of
   E).  A at bench K = 100's one f64 column, and q4's v1, v2, v3 in one
   launch (also timed as one launch a column).  D at q5's v1, v2, v3 in
   one launch over radix_partition's sorted route (also timed as one
   launch a column, and with one step a window: the cost of the
   cross-block combine), over that route with one f64 column, and over
   kernel C's unsorted output with one f64 column; D's outputs are
   checked after the caching allocator was filled with junk, since it
   writes every slot itself.  Tolerances: counts, histograms and integer
   sums exact; float64 sums rtol 1e-12 (atomic order varies); C's output
   holds the same (key, payload) multiset in every bucket; F and G bit
   for bit.  Then radix_partition's two routes, merge_tiles = 1 (B, C)
   and 4 (B, F, G), must give the same windows; both are timed.
4. main path: DataFrame.groupby().agg: q4 (mean of v1, v2, v3 by id4, the
   one-hot tier), q5 (sum of v1, v2, v3 by id6, the radix tier) and
   bench.py's {"v": ["sum", "mean", "count"]} request on v3 by id4
   (K = 100) and by id6 (K = 1e6).  Each result is checked against a
   plain PyTorch groupby on the card, and kernels A, B, F, G and D must
   each have been launched during this run.  Each query is then run
   alone with every count at 0 before it: q4 must launch A once and q5 D
   once.  Then the sum of six value columns by id6 (more than one
   partition launch carries) is checked the same way.
5. timings: median of 7 warm runs of each query and of its plain PyTorch
   counterpart (CUDA events, then synchronize), as rows/s.

The G1 frame is then freed.  The J1 inner join (data J1_1e8_NA_0_0 of
h2oai db-benchmark's join-datagen.R: a fact table of 1e8 rows, id int32
and v1 float64; dim tables of 1e2 (small), 1e5 (medium) and 1e8 (big)
rows, id a random permutation of 1..n and v2 float64; fact ids uniform
over 1..ceil(1.1 n), so about 9% of fact rows find no match), made on the
card from the same generator:

3. kernels, all checked exactly against their plain versions: kernel D's
   id and idpay modes in one launch (window_tables, float64 payload) and
   its id mode alone (the J1 path's) over J1 big's build (1e8 unique
   keys, 16384 windows, a quarter of them empty), over junk; B and C
   over J1 big's probe partition, and B at the sorted route's three J1
   shapes (both J1 big passes, the J1 medium pass); E tile_sort of the
   probe keys with one int32 rider; F and
   G in both passes of the sorted route over the probe side (mask_bits
   27, then 20), and both routes of radix_partition there, which must
   give the same windows; F and G in the single pass of J1 medium's
   probe partition (2^4 digits, mask_bits 17, one int32 payload), the
   shape of three of the five merges; H window_probe at the five shapes
   the J1 path gives it: small (one window), medium and big with one
   table, big with the f64 payload (whose bits must be copied), and
   medium with three stacked tables (each key 1-3 times), and at a
   sparse probe (1e6 rows against J1 big's table), each checked after
   the caching allocator was filled with junk, and timed also with every
   window staged in shared memory and with none.
4. main path: DataFrame.merge(on="id"): q1 small, q2 medium and q5 big
   (the unique tier; small in one window, medium and big partitioned),
   the medium dim with each key 1-3 times (the stacked-table tier,
   m = 3), and dim.merge(fact) at medium (the build on the left).  Each
   result must equal a plain PyTorch join on the card (a dense table for
   a unique build, a stable sort + searchsorted + repeat_interleave
   otherwise): row order, key, v1 and v2.  Kernels B, F, G, D and H must
   each have been launched during this run, with a second pass of the
   sorted route among them (q5 big's 2^27-key domain).
5. timings: median of 7 warm runs of each merge and of models.j1_join
   (gather maps only) at small, medium and big, beside plain PyTorch, as
   probe rows/s.

Each G row says what its timed window holds (the outputs' torch.empty,
and with out_rows G's own fill of the rows no run covers) and G's
resident blocks per SM, threads and shared memory; A's and D's rows
carry theirs and their registers.  The G, D and A rows carry ptxas's
report on their sources (-Xptxas -v, compiled beside the build), and the
A and D rows the shared-memory atomics (ATOMS opcodes, counted in
cuobjdump -sass) of their kernels.

Each kernel's bound is the larger of the bytes it must move (each input
read once, each output written once; for a gather, each table entry the
run's keys touch) over 3.35 TB/s and its operations over 67e12 a second,
the H100 SXM's published HBM rate and scalar float32 rate (a sort of
tiles of T keys: n log2 T comparisons; a merge of M tiles: n log2 M).
Library calls: H's m = 3 row times tables.index_select(1, idx), all
three lookups; no single call gives H's ids and payload together, so
that row has none and records torch.take of each as two_calls_ms.

The last three lines are the card's nvidia-smi name and power limit, a
JSON line of the kernels, and the result line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
"""

import argparse
import concurrent.futures
import json
import statistics
import subprocess
import sys
import time

import torch

N = 100_000_000
K_LOW, K_HIGH = 100, 1_000_000
J1_DIMS = {"small": 100, "medium": 100_000, "big": 100_000_000}
SEED = 20240601
REPS = 7
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def log(*parts):
    print(*parts, flush=True)


def device_ms(fn, reps=REPS):
    """Median device time of fn() over reps warm runs, in ms."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def timed_row(err, kernel, plain, library, moved, ops, **extra):
    """A kernel's numbers: its check's error, its time, its plain
    version's and the library call's (None: no single call), and its bound
    from the bytes it must move and the operations it does."""
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    row = dict(max_abs_err=err, ms=device_ms(kernel),
               plain_ms=device_ms(plain),
               library_ms=None if library is None else device_ms(library),
               bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")
    row.update(extra)
    return row


def show(name, row):
    log(f"kernel {name}: max_abs_err {row['max_abs_err']} ms {row['ms']} plain_ms "
        f"{row['plain_ms']} library_ms {row['library_ms']} bound_ms {row['bound_ms']} "
        f"({row['bound_by']})")


def max_abs_err(got, exp):
    if got.numel() == 0:
        return 0.0
    return float((got.double() - exp.double()).abs().max())


def same(got, exp, what, float_rtol=1e-12):
    """Exact for integers, rtol for floats; returns the max abs error."""
    check(got.dtype == exp.dtype and got.shape == exp.shape,
          f"{what}: {got.dtype}{list(got.shape)} vs {exp.dtype}{list(exp.shape)}")
    if got.dtype.is_floating_point:
        check(bool(torch.isfinite(got).all()), f"{what}: non-finite values")
        check(torch.allclose(got, exp, rtol=float_rtol, atol=0), f"{what}: differs")
    else:
        check(torch.equal(got, exp), f"{what}: differs")
    return max_abs_err(got, exp)


def same_bits(got, exp, what):
    """Bit for bit (NaN and -0.0 included)."""
    check(got.dtype == exp.dtype and got.shape == exp.shape
          and torch.equal(got.view(torch.uint8), exp.view(torch.uint8)), f"{what}: differs")
    return 0.0


def pairs_sorted(keys, vals):
    """(key, val) pairs in lexicographic order."""
    order = torch.argsort(vals, stable=True)
    order = order[torch.argsort(keys[order], stable=True)]
    return keys[order], vals[order]


def tile_sort_row(ts, keys, payloads, tile, mask_bits, shape):
    """Kernel F bit for bit against its plain version, and its row; the
    library call is a stable torch.sort of the keys' whole tiles."""
    sk, sp = ts.tile_sort_data(keys, payloads, tile, alternate=True, mask_bits=mask_bits)
    ek, ep = ts.tile_sort_data_plain(keys, payloads, tile, True, mask_bits)
    same_bits(sk, ek, f"F keys ({shape})")
    for got, exp in zip(sp, ep):
        same_bits(got, exp, f"F payloads ({shape})")
    del ek, ep
    n = keys.numel()
    lib = keys[:n // tile * tile].view(-1, tile)
    row = timed_row(
        0.0,
        lambda: ts.tile_sort_data(keys, payloads, tile, alternate=True, mask_bits=mask_bits),
        lambda: ts.tile_sort_data_plain(keys, payloads, tile, True, mask_bits),
        lambda: torch.sort(lib, dim=1, stable=True), 2 * nbytes(keys, *payloads),
        n * (tile.bit_length() - 1), shape=shape, mask_bits=mask_bits)
    return row, (sk, sp)


def sorted_pass(rp, ts, keys, payloads, nbits, shift, offsets, base, mask_bits, shape,
                out_rows=None):
    """Kernels F and G over one pass of the sorted route, each bit for
    bit against its plain version (G in every row it writes: base[-1],
    or out_rows); (F's row, G's row, G's output)."""
    tile, st = rp.SORT_TILE, rp.MERGE_TILES * rp.SORT_TILE
    f_row, (sk, sp) = tile_sort_row(ts, keys, payloads, tile, mask_bits, shape)
    out = rp.merge_scatter(sk, sp, offsets, nbits, shift, st, tile, mask_bits, out_rows)
    ek, ep = rp.merge_scatter_plain(sk, sp, offsets, nbits, shift, st, tile, mask_bits,
                                    out_rows)
    m = int(base[-1]) if out_rows is None else out_rows
    same_bits(out[0][:m], ek[:m], f"G keys ({shape})")
    for got, exp in zip(out[1], ep):
        same_bits(got[:m], exp[:m], f"G payloads ({shape})")
    del ek, ep
    n = keys.numel()
    g_row = timed_row(
        0.0,
        lambda: rp.merge_scatter(sk, sp, offsets, nbits, shift, st, tile, mask_bits, out_rows),
        lambda: rp.merge_scatter_plain(sk, sp, offsets, nbits, shift, st, tile, mask_bits,
                                       out_rows),
        None, 2 * nbytes(keys, *payloads) + nbytes(offsets),
        n * (rp.MERGE_TILES.bit_length() - 1), shape=shape, mask_bits=mask_bits,
        output_allocation="inside the timed window: torch.empty of the outputs"
        + ("" if out_rows is None else ", and kernel G's own fill of the rows no run covers"),
        occupancy=rp.merge_scatter_occupancy(st, nbits))
    return f_row, g_row, out


def route_phase(dev, rp, keys, vals, bits, what):
    """radix_partition at merge_tiles = 1 (kernels B, C) and 4 (B, F, G):
    the same base and, in every window, the same (key, row, value bits);
    returns both routes' times in ms."""
    rows = torch.arange(keys.numel(), dtype=torch.int32, device=dev)
    outs, times = {}, {}
    for mt in (1, 4):
        pk, pv, base, G = rp.radix_partition(keys, [rows] + vals, bits, merge_tiles=mt)
        m = int(base[-1])
        win = torch.repeat_interleave(torch.arange(G, device=dev), base[1:] - base[:-1])
        check(torch.equal(pk[:m].long() >> rp.WINDOW_BITS, win),
              f"{what} merge_tiles={mt}: a key outside its window")
        order = torch.argsort(pv[0][:m].long() + win * keys.numel())
        outs[mt] = [base, pk[:m][order]] + [p[:m][order] for p in pv]
        del pk, pv, win, order
        times[mt] = device_ms(lambda: rp.radix_partition(keys, vals, bits, merge_tiles=mt))
    for a, b in zip(outs[1], outs[4]):
        same_bits(a, b, f"{what}: the routes' windows")
    log(f"route {what}: merge_tiles=1 (B, C) {times[1]:.3f} ms, merge_tiles=4 (B, F, G) "
        f"{times[4]:.3f} ms; same windows")
    return {"merge_tiles=1": times[1], "merge_tiles=4": times[4]}


def kernel_phase(dev, gen, ha, rp, ts):
    """Each G1 kernel against its plain version at the main path's shapes."""
    rows = {}
    codes_low = torch.randint(0, K_LOW, (N,), generator=gen, device=dev, dtype=torch.int32)
    v_int = torch.randint(1, 16, (N,), generator=gen, device=dev, dtype=torch.int32)
    v_f64 = torch.rand(N, generator=gen, device=dev, dtype=torch.float64) * 100

    v_small = torch.randint(1, 6, (N,), generator=gen, device=dev, dtype=torch.int32)
    err = 0.0
    for vals in (v_int, v_f64):
        got = ha.onehot_groupby_aggregate(codes_low, vals, K_LOW, with_minmax=False)
        exp = ha.onehot_groupby_aggregate_plain(codes_low, vals, K_LOW, with_minmax=False)
        err = max(err, same(got[0], exp[0], "A sums"), same(got[1], exp[1], "A counts"))
    rows["onehot_groupby_aggregate"] = timed_row(
        err,
        lambda: ha.onehot_groupby_aggregate(codes_low, v_f64, K_LOW, with_minmax=False),
        lambda: ha.onehot_groupby_aggregate_plain(codes_low, v_f64, K_LOW, with_minmax=False),
        lambda: torch.zeros(K_LOW, dtype=torch.float64, device=dev).index_add_(
            0, codes_low, v_f64),
        nbytes(codes_low, v_f64) + 16 * K_LOW, 2 * N,
        shape="bench K = 100: 1e8 rows, one f64 column",
        occupancy=ha.onehot_aggregate_occupancy(K_LOW, [False]))
    show("A", rows["onehot_groupby_aggregate"])
    q4 = [v_small, v_int, v_f64]                        # q4's v1, v2, v3 in one launch
    before = ha.onehot_groupby_aggregate.launches
    got = ha.onehot_groupby_aggregate(codes_low, q4, K_LOW, with_minmax=False)
    check(ha.onehot_groupby_aggregate.launches == before + 1, "A: q4's columns in one launch")
    exp = ha.onehot_groupby_aggregate_plain(codes_low, q4, K_LOW, with_minmax=False)
    err = same(got[1], exp[1], "A q4 counts")
    for a, b in zip(got[0], exp[0]):
        err = max(err, same(a, b, "A q4 sums"))
    shape = "q4: 1e8 rows, K = 100, int32 + int32 + f64 columns in one launch"
    row = timed_row(
        err, lambda: ha.onehot_groupby_aggregate(codes_low, q4, K_LOW, with_minmax=False),
        lambda: ha.onehot_groupby_aggregate_plain(codes_low, q4, K_LOW, with_minmax=False),
        None, nbytes(codes_low, *q4) + 32 * K_LOW, 4 * N, shape=shape,
        occupancy=ha.onehot_aggregate_occupancy(K_LOW, [False] * 3))
    row["one_launch_a_column_ms"] = device_ms(lambda: [ha.onehot_groupby_aggregate(
        codes_low, v, K_LOW, with_minmax=False) for v in q4])
    rows["onehot_groupby_aggregate"]["modes"] = {shape: row}
    show("A, q4's three columns in one launch", row)
    log(f"  the same columns in one launch each: {row['one_launch_a_column_ms']} ms")
    del codes_low

    codes = torch.randint(0, K_HIGH, (N,), generator=gen, device=dev, dtype=torch.int32)
    nbits = (K_HIGH - 1).bit_length() - rp.WINDOW_BITS
    tile = rp.choose_tile(N, nbits)
    shift = rp.WINDOW_BITS
    hist = rp.digit_histogram(codes, nbits, shift, tile)
    same(hist, rp.digit_histogram_plain(codes, nbits, shift, tile), "B hist")
    rows["digit_histogram"] = timed_row(
        0.0,
        lambda: rp.digit_histogram(codes, nbits, shift, tile),
        lambda: rp.digit_histogram_plain(codes, nbits, shift, tile), None,
        nbytes(codes, hist), N)
    show(f"B (exact, tile {tile})", rows["digit_histogram"])

    offsets, base = rp.partition_offsets(hist)
    payloads = [v_int, v_f64]
    pk, pv = rp.radix_scatter(codes, payloads, offsets, nbits, shift, tile)
    ek, ev = rp.radix_scatter_plain(codes, payloads, offsets, nbits, shift, tile)
    m = int(base[-1])
    check(m == N, f"C: {m} partitioned rows of {N}")
    window = torch.repeat_interleave(torch.arange(1 << nbits, device=dev),
                                     base[1:] - base[:-1])
    check(torch.equal(pk[:m].long() >> shift, window), "C: a key outside its bucket")
    for got, exp in zip(pv, ev):
        a, b = pairs_sorted(pk[:m], got[:m]), pairs_sorted(ek[:m], exp[:m])
        same(a[0], b[0], "C keys")
        same(a[1], b[1], "C payloads", float_rtol=0.0)
    del ek, ev, a, b
    rows["radix_scatter"] = timed_row(
        0.0,
        lambda: rp.radix_scatter(codes, payloads, offsets, nbits, shift, tile),
        lambda: rp.radix_scatter_plain(codes, payloads, offsets, nbits, shift, tile), None,
        2 * nbytes(codes, *payloads) + nbytes(offsets), N)
    show("C (per-bucket multisets equal)", rows["radix_scatter"])

    st = rp.MERGE_TILES * rp.SORT_TILE
    offsets, base_st = rp.partition_offsets(rp.digit_histogram(codes, nbits, shift, st))
    check(torch.equal(base_st, base), "B at supertile granularity: other windows")
    shape = "G1 K = 1e6: 1e8 keys, int32 + f64 payloads, mask_bits 20 (the route's)"
    rows["tile_sort_data"], rows["merge_scatter"], _ = sorted_pass(
        rp, ts, codes, payloads, nbits, shift, offsets, base, nbits + shift, shape)
    show("F (bit for bit)", rows["tile_sort_data"])
    show("G (bit for bit)", rows["merge_scatter"])
    shape = "G1 K = 1e6 keys and payloads, no mask (the full 32-bit order, E's)"
    unmasked, _ = tile_sort_row(ts, codes, payloads, rp.SORT_TILE, None, shape)
    rows["tile_sort_data"]["modes"] = {shape: unmasked}
    show("F without a mask (bit for bit)", unmasked)
    rows["merge_scatter"]["route_ms_g1"] = route_phase(dev, rp, codes, payloads,
                                                       nbits + shift, "G1 K = 1e6")

    G = 1 << nbits
    modes = {}
    shape = "G1 K = 1e6 over kernel C's output (merge_tiles = 1; unsorted runs), one f64 column"
    err = 0.0
    for vals in pv:
        err = max(err, d_check(rp, pk, vals, base, G, "D over C's output"))
    got = rp.bucket_aggregate(pk, pv[1], base, G)
    modes[shape] = timed_row(
        err,
        lambda: rp.bucket_aggregate(pk, pv[1], base, G),
        lambda: rp.bucket_aggregate_plain(pk, pv[1], base, G),
        lambda: torch.zeros(G * rp.SPAN, dtype=torch.float64, device=dev).index_add_(
            0, pk, pv[1]),
        nbytes(pk, pv[1], *got), 2 * N, shape=shape)
    show("D over C's output, one f64 column", modes[shape])
    del pk, pv, got

    # the main path's D: q5's v1, v2, v3 through the sorted route, one launch
    q5 = [v_small, v_int, v_f64]
    pk, pv, base, G = rp.radix_partition(codes, q5, nbits + shift)
    before = rp.bucket_aggregate.launches
    err = d_check(rp, pk, pv, base, G, "D q5")
    check(rp.bucket_aggregate.launches == before + 1, "D: q5's columns in one launch")
    got = rp.bucket_aggregate(pk, pv, base, G)
    shape = "G1 K = 1e6 over the sorted route's output: q5's int32 + int32 + f64, one launch"
    row = timed_row(
        err, lambda: rp.bucket_aggregate(pk, pv, base, G),
        lambda: rp.bucket_aggregate_plain(pk, pv, base, G), None,
        nbytes(pk, *pv, *got[0], got[1]), 4 * N, shape=shape,
        occupancy=rp.bucket_aggregate_occupancy(3))
    row["three_index_add_ms"] = device_ms(lambda: [torch.zeros(
        G * rp.SPAN, dtype=torch.float64 if v.is_floating_point() else torch.int64,
        device=dev).index_add_(0, pk, v if v.is_floating_point() else v.long()) for v in pv])
    row["one_launch_a_column_ms"] = device_ms(
        lambda: [rp.bucket_aggregate(pk, v, base, G, with_counts=j == 0)
                 for j, v in enumerate(pv)])
    row["one_step_a_window_ms"] = device_ms(         # agg_rows above every window's rows
        lambda: rp.bucket_aggregate(pk, pv, base, G, agg_rows=1 << 21))
    same(rp.bucket_aggregate(pk, pv, base, G, agg_rows=1 << 21)[0][2], got[0][2],
         "D q5, one step a window")
    rows["bucket_aggregate"] = row
    show("D, q5's three columns in one launch", row)
    log(f"  three index_add_ calls {row['three_index_add_ms']} ms; one launch a column "
        f"{row['one_launch_a_column_ms']} ms; one step a window (no global atomics) "
        f"{row['one_step_a_window_ms']} ms")
    shape = "G1 K = 1e6 over the sorted route's output, one f64 column"
    modes[shape] = timed_row(
        0.0, lambda: rp.bucket_aggregate(pk, pv[2], base, G),
        lambda: rp.bucket_aggregate_plain(pk, pv[2], base, G),
        lambda: torch.zeros(G * rp.SPAN, dtype=torch.float64, device=dev).index_add_(
            0, pk, pv[2]),
        nbytes(pk, pv[2], *got[0][2:], got[1]), 2 * N, shape=shape,
        occupancy=rp.bucket_aggregate_occupancy(1))
    show("D over the sorted route, one f64 column", modes[shape])
    row["modes"] = modes
    return rows


def d_check(rp, pk, vals, base, G, what):
    """Kernel D (one column or a list) against its plain version, its
    outputs allocated over junk since it writes every slot itself; counts
    exact, integer sums exact, float sums rtol 1e-12 (atomic order)."""
    size = G * rp.SPAN
    ncols = 1 if isinstance(vals, torch.Tensor) else len(vals)
    fill_junk(*[(2 * size,)] * (ncols + 1))
    got, counts = rp.bucket_aggregate(pk, vals, base, G)
    exp, e_counts = rp.bucket_aggregate_plain(pk, vals, base, G)
    err = same(counts, e_counts, f"{what} counts")
    for a, b in zip([got] if ncols == 1 else got, [exp] if ncols == 1 else exp):
        err = max(err, same(a, b, f"{what} sums"))
    return err


def g1_frame(ct, dev, gen):
    def ints(lo, hi):
        return torch.randint(lo, hi + 1, (N,), generator=gen, device=dev, dtype=torch.int32)

    return ct.DataFrame({
        "id4": ints(1, K_LOW), "id6": ints(1, K_HIGH),
        "v1": ints(1, 5), "v2": ints(1, 15),
        "v3": torch.rand(N, generator=gen, device=dev, dtype=torch.float64) * 100,
    })


QUERIES = {
    "q4": ("id4", {"v1": "mean", "v2": "mean", "v3": "mean"}),
    "q5": ("id6", {"v1": "sum", "v2": "sum", "v3": "sum"}),
    "bench_k100": ("id4", {"v3": ["sum", "mean", "count"]}),
    "bench_k1e6": ("id6", {"v3": ["sum", "mean", "count"]}),
}


def plain_query(df, key, spec):
    """The same groupby in plain PyTorch: (group keys, {name: tensor})."""
    k = df._table[key].data
    lo, hi = (int(x) for x in torch.aminmax(k))
    codes = (k - lo).long()
    counts = torch.bincount(codes, minlength=hi - lo + 1)
    present = torch.nonzero(counts).squeeze(1)
    out = {}
    multi = any(isinstance(a, list) for a in spec.values())
    for col, aggs in spec.items():
        v = df._table[col].data
        acc = torch.float64 if v.dtype.is_floating_point else torch.int64
        sums = torch.zeros(hi - lo + 1, dtype=acc, device=k.device).index_add_(0, codes, v.to(acc))
        for agg in (aggs if isinstance(aggs, list) else [aggs]):
            res = {"sum": sums, "count": counts, "mean": sums.double() / counts}[agg]
            out[(col, agg) if multi else col] = res[present]
    return (present + lo).to(k.dtype), out


def wide_frame(ct, df):
    """id6 and six value columns: more than one scatter launch carries, so
    the radix tier must pair each column with its keys through row ids."""
    t = df._table
    v1, v2, v3 = t["v1"].data, t["v2"].data, t["v3"].data
    return ct.DataFrame({"id6": t["id6"].data, "v1": v1, "v2": v2, "v3": v3,
                         "w1": v1 * v2, "w2": v2 - 7 * v1, "w3": v3 * 0.5 + v1})


def check_query(name, res, exp):
    keys, cols = exp
    idx = res.index.column().data
    check(len(res) == keys.shape[0], f"{name}: {len(res)} groups, expected {keys.shape[0]}")
    same(idx, keys, f"{name} keys")
    check(list(res._table.names) == list(cols), f"{name}: columns {res._table.names}")
    for col, want in cols.items():
        c = res._table[col]
        check(c.validity is None or bool(c.validity.all()), f"{name} {col}: nulls")
        same(c.data, want, f"{name} {col}")


# ----------------------------------------------------------------------
# J1
# ----------------------------------------------------------------------

def fanout_ids(dev, gen, n):
    """int32 codes 0..n-1, each 1-3 times, shuffled."""
    ids = torch.repeat_interleave(torch.randperm(n, generator=gen, device=dev),
                                  torch.randint(1, 4, (n,), generator=gen, device=dev))
    return ids[torch.randperm(ids.numel(), generator=gen, device=dev)].int()


def probe_codes(dev, gen, n_dim):
    """N fact key codes uniform over 0..ceil(1.1 n_dim) - 1; those >= n_dim
    (no dim row) are -1, as the join's code pass leaves them."""
    lk = torch.randint(0, -(-11 * n_dim // 10), (N,), generator=gen, device=dev,
                       dtype=torch.int32)
    return torch.where(lk < n_dim, lk, -1)


def j1_kernel_phase(dev, gen, rp, ts):
    """D's id/idpay modes, B, C and H at J1 shapes, against their plain
    versions.  Returns {kernel: {mode: row}}."""
    modes = {"bucket_aggregate": {}, "digit_histogram": {}, "radix_scatter": {},
             "tile_sort_data": {}, "merge_scatter": {}, "window_probe": {}}
    n_dim = J1_DIMS["big"]
    rk = torch.randperm(n_dim, generator=gen, device=dev, dtype=torch.int32)
    rv = torch.randn(n_dim, generator=gen, device=dev, dtype=torch.float64)
    bits = rp.domain_bits(n_dim)
    rid1 = torch.arange(1, n_dim + 1, dtype=torch.int32, device=dev)
    pk_r, (prid, ppay), base_r, G = rp.radix_partition(rk, [rid1, rp.payload_bits(rv)], bits)
    del rid1
    size = G * rp.SPAN
    fill_junk(*[(2 * size,)] * 3)               # kernel D writes every slot itself
    before = rp.bucket_aggregate.launches
    ids, counts, pay = rp.window_tables(pk_r, prid, base_r, G, ppay)
    check(rp.bucket_aggregate.launches == before + 1, "D: id + idpay in one launch")
    (e_ids, e_pay), e_counts = rp.bucket_aggregate_plain(pk_r, [prid, ppay], base_r, G)
    same(ids, e_ids, "D id mode ids")
    same(counts, e_counts, "D id mode counts")
    same(pay, e_pay, "D idpay mode payload bits")
    check(torch.equal(pay[rk.long()], rp.payload_bits(rv)), "D idpay: payload bits not copied")
    del e_ids, e_counts, e_pay
    want = torch.zeros_like(ids)
    want[rk.long()] = torch.arange(1, n_dim + 1, device=dev)
    same(ids, want, "D id mode: build_row_id + 1 per key")
    check(int(counts.max()) == 1, "D id mode: J1 big's build is unique")
    del want, counts
    name = "id/idpay in one launch, J1 big build (1e8 keys, G = 16384, f64 payload)"
    modes["bucket_aggregate"][name] = timed_row(
        0.0, lambda: rp.window_tables(pk_r, prid, base_r, G, ppay),
        lambda: rp.bucket_aggregate_plain(pk_r, [prid, ppay], base_r, G),
        lambda: torch.zeros(size, dtype=torch.int64, device=dev).index_add_(0, pk_r, ppay),
        nbytes(pk_r, prid, ppay) + 3 * nbytes(ids), 3 * n_dim,
        occupancy=rp.bucket_aggregate_occupancy(2))
    show("D id + idpay in one launch (exact)", modes["bucket_aggregate"][name])
    fill_junk(*[(2 * size,)] * 2)
    ids1, counts1, _ = rp.window_tables(pk_r, prid, base_r, G)
    e_ids, e_counts = rp.bucket_aggregate_plain(pk_r, prid, base_r, G)
    same(ids1, e_ids, "D id mode alone: ids")
    same(counts1, e_counts, "D id mode alone: counts")
    del e_ids, e_counts
    name = "id alone (the J1 path's mode), J1 big build (1e8 keys, G = 16384)"
    modes["bucket_aggregate"][name] = timed_row(
        0.0, lambda: rp.window_tables(pk_r, prid, base_r, G),
        lambda: rp.bucket_aggregate_plain(pk_r, prid, base_r, G), None,
        nbytes(pk_r, prid, ids1, counts1), 2 * n_dim,
        occupancy=rp.bucket_aggregate_occupancy(1))
    show("D id mode alone (exact)", modes["bucket_aggregate"][name])
    del pk_r, prid, ppay, ids1, counts1

    lk = probe_codes(dev, gen, n_dim)
    rows_i = torch.arange(N, dtype=torch.int32, device=dev)
    nbits = bits - rp.WINDOW_BITS
    tile = rp.choose_tile(N, nbits)
    hist = rp.digit_histogram(lk, nbits, rp.WINDOW_BITS, tile)
    same(hist, rp.digit_histogram_plain(lk, nbits, rp.WINDOW_BITS, tile), "B hist (J1)")
    offsets, base_l = rp.partition_offsets(hist)
    pk_l, (pv_l,) = rp.radix_scatter(lk, [rows_i], offsets, nbits, rp.WINDOW_BITS, tile)
    m = int(base_l[-1])
    live = torch.nonzero(lk >= 0).squeeze(1)
    check(m == live.numel(), f"C (J1): {m} partitioned rows of {live.numel()}")
    window = torch.repeat_interleave(torch.arange(G, device=dev), base_l[1:] - base_l[:-1])
    check(torch.equal(pk_l[:m].long() >> rp.WINDOW_BITS, window), "C (J1): a key outside its window")
    check(torch.equal(lk[pv_l[:m].long()], pk_l[:m]), "C (J1): a row id off its key")
    check(torch.equal(torch.sort(pv_l[:m]).values.long(), live), "C (J1): rows lost or repeated")
    del window, live
    shape = f"J1 big probe (1e8 keys, 2^{nbits} buckets, tile {tile})"
    modes["digit_histogram"][shape] = timed_row(
        0.0,
        lambda: rp.digit_histogram(lk, nbits, rp.WINDOW_BITS, tile),
        lambda: rp.digit_histogram_plain(lk, nbits, rp.WINDOW_BITS, tile), None,
        nbytes(lk, hist), N)
    show("B at J1 big", modes["digit_histogram"][shape])
    modes["radix_scatter"][shape + ", one int32 payload"] = timed_row(
        0.0,
        lambda: rp.radix_scatter(lk, [rows_i], offsets, nbits, rp.WINDOW_BITS, tile),
        lambda: rp.radix_scatter_plain(lk, [rows_i], offsets, nbits, rp.WINDOW_BITS, tile),
        None, nbytes(lk, rows_i, offsets) + 2 * 4 * m, N)
    show("C at J1 big (exact partition)", modes["radix_scatter"][shape + ", one int32 payload"])
    del hist, offsets

    tile, st = rp.SORT_TILE, rp.MERGE_TILES * rp.SORT_TILE
    got = ts.tile_sort(lk, rows_i, tile=tile, alternate=True)
    exp = ts.tile_sort_data_plain(lk, [rows_i], tile, True)
    same_bits(got[0], exp[0], "E keys")
    same_bits(got[1], exp[1][0], "E rider")
    del got, exp
    lib = lk[:N // tile * tile].view(-1, tile)
    e_row = timed_row(
        0.0, lambda: ts.tile_sort(lk, rows_i, tile=tile, alternate=True),
        lambda: ts.tile_sort_data_plain(lk, [rows_i], tile, True),
        lambda: torch.sort(lib, dim=1, stable=True), 2 * nbytes(lk, rows_i),
        N * (tile.bit_length() - 1), shape="J1 big probe: 1e8 keys, one int32 rider, "
        "4096-key tiles, alternate, no mask (32 bits)")
    show("E at J1 big (bit for bit)", e_row)

    shift1 = rp.WINDOW_BITS + rp.PASS_BITS                 # the sorted route's two passes
    regions = 1 << (bits - shift1)
    name = f"J1 big probe, sorted route's first pass: 2^{bits - shift1} digits at shift {shift1}"
    modes["digit_histogram"][name] = hist_row(rp, lk, bits - shift1, shift1, st, name)
    off1, base1 = rp.partition_offsets(rp.digit_histogram(lk, bits - shift1, shift1, st),
                                       align=st)
    rows1 = (-(-N // st) + regions) * st
    shape1 = f"J1 big probe, first pass: 1e8 rows, mask_bits {bits}, one int32 payload"
    f_row, g_row, (k1, (r1,)) = sorted_pass(rp, ts, lk, [rows_i], bits - shift1, shift1, off1,
                                            base1, bits, shape1, out_rows=rows1)
    modes["tile_sort_data"][shape1] = f_row
    modes["merge_scatter"][shape1] = g_row
    show("F at J1 big, first pass (bit for bit)", f_row)
    show("G at J1 big, first pass (bit for bit)", g_row)
    region = torch.searchsorted(base1[1:], torch.arange(rows1 // st, device=dev) * st,
                                right=True).clamp_(max=regions - 1)
    name = (f"J1 big probe, sorted route's second pass: {rows1:.3g} keys, 2^{rp.PASS_BITS} "
            f"digits at shift {rp.WINDOW_BITS}")
    modes["digit_histogram"][name] = hist_row(rp, k1, rp.PASS_BITS, rp.WINDOW_BITS, st, name)
    off2, base2 = rp.partition_offsets(rp.digit_histogram(k1, rp.PASS_BITS, rp.WINDOW_BITS, st),
                                       region, regions)
    shape2 = (f"J1 big probe, second pass: {rows1:.3g} rows, mask_bits {shift1}, 2^7 digits "
              "per region, one int32 payload")
    f_row, g_row, _ = sorted_pass(rp, ts, k1, [r1], rp.PASS_BITS, rp.WINDOW_BITS, off2, base2,
                                  shift1, shape2)
    check(torch.equal(base2, base_l), "G (J1 second pass): windows other than C's")
    del k1, r1, off1, off2, region
    modes["tile_sort_data"][shape2] = f_row
    modes["merge_scatter"][shape2] = g_row
    show("F at J1 big, second pass (bit for bit)", f_row)
    show("G at J1 big, second pass (bit for bit)", g_row)
    route_ms = route_phase(dev, rp, lk, [rows_i], bits, "J1 big probe")
    pk_sp, _, base_sp, _ = rp.radix_partition(lk[:N // 100], [], bits)   # a sparse probe
    del lk

    tab = ids.view(1, -1)
    found, bid, _ = probe_check(rp, pk_l, base_l, tab)
    check(torch.equal(rk[bid], pk_l[found]), "H (J1 big): a match off its key")
    idx = pk_l[:m].long()
    main = probe_row(rp, pk_l, base_l, tab, "J1 big: 1e8 probe rows, 16384 windows, one table "
                     "of 1.34e8 slots", lambda: torch.take(ids, idx))
    show("H at J1 big (exact)", main)
    probe_check(rp, pk_sp, base_sp, tab)
    idx_sp = pk_sp[:int(base_sp[-1])].long()
    name = "J1 big's table, 1e6 probe rows (sparse: ~55 rows a window of 8192 slots)"
    modes["window_probe"][name] = probe_row(rp, pk_sp, base_sp, tab, name,
                                            lambda: torch.take(ids, idx_sp))
    show("H, sparse probe of J1 big's table (exact)", modes["window_probe"][name])
    del pk_sp, base_sp, idx_sp
    found, bid, out = probe_check(rp, pk_l, base_l, tab, pay, torch.float64)
    check(torch.equal(rp.payload_bits(out)[found], rp.payload_bits(rv)[bid]),
          "H (J1 big): a payload not copied")
    del out, found, bid
    name = "J1 big with the f64 payload through the table"
    row = probe_row(rp, pk_l, base_l, tab, name, None, pay, torch.float64)
    row["two_calls_ms"] = device_ms(lambda: (torch.take(ids, idx), torch.take(pay, idx)))
    row["two_calls"] = "torch.take(ids, idx) + torch.take(pay, idx): two calls, ids and payload"
    modes["window_probe"][name] = row
    show("H at J1 big with payload (bits copied)", row)
    log(f"  two calls (torch.take of ids, then of the payload): {row['two_calls_ms']} ms")
    del ids, pay, tab, idx, pk_l, pv_l, rk, rv

    n_small = J1_DIMS["small"]
    ids_s, _, unique, _ = rp.build_join_tables(
        torch.randperm(n_small, generator=gen, device=dev, dtype=torch.int32), n_small)
    check(unique, "J1 small's build is unique")
    lk = probe_codes(dev, gen, n_small)                   # one window: not partitioned
    base_s = torch.tensor([0, N], dtype=torch.int64, device=dev)
    probe_check(rp, lk, base_s, ids_s.view(1, -1))
    idx = lk.clamp(min=0).long()
    name = "J1 small: 1e8 probe rows in one window (~1.2e4 rows a slot), one table"
    modes["window_probe"][name] = probe_row(rp, lk, base_s, ids_s.view(1, -1), name,
                                            lambda: torch.take(ids_s, idx))
    show("H at J1 small (exact)", modes["window_probe"][name])
    del lk, idx, ids_s

    n_med = J1_DIMS["medium"]
    ids_m, _, unique, _ = rp.build_join_tables(
        torch.randperm(n_med, generator=gen, device=dev, dtype=torch.int32), n_med)
    check(unique, "J1 medium's build is unique")
    dup = fanout_ids(dev, gen, n_med)
    tables, mult = rp.ordinal_tables(dup, n_med)
    check(mult == 3, f"H m=3: fan-out {mult}")
    lk = probe_codes(dev, gen, n_med)
    bits_m = rp.domain_bits(n_med)                         # 17: one pass at 2^4 digits
    nbits_m = bits_m - rp.WINDOW_BITS
    name = f"J1 medium probe, sorted route's single pass: 2^{nbits_m} digits"
    modes["digit_histogram"][name] = hist_row(rp, lk, nbits_m, rp.WINDOW_BITS, st, name)
    off_m, base_m = rp.partition_offsets(rp.digit_histogram(lk, nbits_m, rp.WINDOW_BITS, st))
    shape = (f"J1 medium probe, single pass: 1e8 rows, 2^{nbits_m} digits, mask_bits {bits_m}, "
             "one int32 payload")
    f_row, g_row, _ = sorted_pass(rp, ts, lk, [rows_i], nbits_m, rp.WINDOW_BITS, off_m, base_m,
                                  bits_m, shape)
    modes["tile_sort_data"][shape] = f_row
    modes["merge_scatter"][shape] = g_row
    show("F at J1 medium (bit for bit)", f_row)
    show("G at J1 medium (bit for bit)", g_row)
    del off_m, base_m
    pk_m, (pv_m,), base_m, _ = rp.radix_partition(lk, [rows_i], bits_m)
    del lk
    idx = pk_m[:int(base_m[-1])].long()
    probe_check(rp, pk_m, base_m, ids_m.view(1, -1))
    name = "J1 medium: 1e8 probe rows, 16 windows (~6.9e2 rows a slot), one table"
    modes["window_probe"][name] = probe_row(rp, pk_m, base_m, ids_m.view(1, -1), name,
                                            lambda: torch.take(ids_m, idx))
    show("H at J1 medium (exact)", modes["window_probe"][name])
    probe_check(rp, pk_m, base_m, tables)
    name = "J1 medium, m = 3 stacked tables (keys 1-3 times)"
    modes["window_probe"][name] = probe_row(rp, pk_m, base_m, tables, name,
                                            lambda: tables.index_select(1, idx))
    show("H m=3 at J1 medium (exact)", modes["window_probe"][name])
    return {"window_probe": main, "tile_sort": e_row}, modes, route_ms


def hist_row(rp, keys, nbits, shift, tile, shape):
    """Kernel B exact against its plain version at one sorted-route shape
    (16384-key tiles), and its row."""
    hist = rp.digit_histogram(keys, nbits, shift, tile)
    same(hist, rp.digit_histogram_plain(keys, nbits, shift, tile), f"B hist ({shape})")
    row = timed_row(0.0, lambda: rp.digit_histogram(keys, nbits, shift, tile),
                    lambda: rp.digit_histogram_plain(keys, nbits, shift, tile), None,
                    nbytes(keys, hist), keys.numel(), shape=shape)
    show(f"B, {shape}", row)
    return row


def fill_junk(*shapes):
    """Allocate int32 tensors of these shapes filled with 0x7f7f7f7f and
    free them, so that the caching allocator hands their blocks, junk and
    all, to the next allocations of the same sizes."""
    junk = [torch.full(sh, 0x7F7F7F7F, dtype=torch.int32, device="cuda") for sh in shapes]
    torch.cuda.synchronize()
    del junk


def probe_check(rp, pk, base, tables, pay=None, pay_dtype=None):
    """Kernel H exact against its plain version, its outputs allocated
    over junk: every row past base[-1] and every row without a match
    reads -1 (payload 0).  Returns (rows found in table 0, their bids,
    the payload)."""
    n, m = pk.numel(), tables.shape[0]
    fill_junk((m, n), (2 * n,))
    bids, out = rp.window_probe(pk, base, tables, pay, pay_dtype)
    eb, eo = rp.window_probe_plain(pk, base, tables, pay, pay_dtype)
    same(bids, eb, f"H bids (m = {m}, {n} rows)")
    check(bool((bids[:, int(base[-1]):] == -1).all()), "H: a row past base[-1] matched")
    if pay is not None:
        same(rp.payload_bits(out), rp.payload_bits(eo), "H payload bits")
        check(bool((out[bids[0] < 0] == 0).all()), "H: a payload without a match")
    found = torch.nonzero(bids[0] >= 0).squeeze(1)
    return found, bids[0][found].long(), out


def probe_row(rp, pk, base, tables, shape, library, pay=None, pay_dtype=None):
    """Kernel H's row at one shape, timed also with every window staged
    (ms_staged) and with none (ms_direct).  Bound: the keys of the
    windows' rows read, bids (and payload) written, and the table (and
    payload) entries the keys touch read once."""
    rows = int(base[-1])
    k = pk[:rows].long()
    touched = torch.zeros(tables.shape[1], dtype=torch.bool, device=pk.device)
    touched[k[k >= 0]] = True
    n_touched = int(touched.sum())
    del touched, k
    m, n = tables.shape[0], pk.numel()
    moved = 4 * rows + 4 * m * n + 8 * m * n_touched
    if pay is not None:
        moved += pay_dtype.itemsize * n + 8 * n_touched
    row = timed_row(0.0, lambda: rp.window_probe(pk, base, tables, pay, pay_dtype),
                    lambda: rp.window_probe_plain(pk, base, tables, pay, pay_dtype),
                    library, moved, m * rows, shape=shape, n_touched=n_touched,
                    stage_min_rows=rp.STAGE_MIN_ROWS)
    row["ms_staged"] = device_ms(
        lambda: rp.window_probe(pk, base, tables, pay, pay_dtype, stage_min_rows=1))
    row["ms_direct"] = device_ms(
        lambda: rp.window_probe(pk, base, tables, pay, pay_dtype, stage_min_rows=1 << 40))
    return row


def j1_frames(ct, dev, gen):
    """{name: DataFrame}: fact_<size> (1e8 rows, keys for that dim) and
    dim_<size> for each J1 dim size, and dim_medium_fanout."""
    v1 = torch.randn(N, generator=gen, device=dev, dtype=torch.float64)
    frames = {}
    for size, n_dim in J1_DIMS.items():
        ids = torch.randint(1, -(-11 * n_dim // 10) + 1, (N,), generator=gen, device=dev,
                            dtype=torch.int32)
        frames[f"fact_{size}"] = ct.DataFrame({"id": ids, "v1": v1})
        frames[f"dim_{size}"] = ct.DataFrame({
            "id": torch.randperm(n_dim, generator=gen, device=dev, dtype=torch.int32) + 1,
            "v2": torch.randn(n_dim, generator=gen, device=dev, dtype=torch.float64)})
    ids = fanout_ids(dev, gen, J1_DIMS["medium"]) + 1
    frames["dim_medium_fanout"] = ct.DataFrame({
        "id": ids, "v2": torch.randn(ids.numel(), generator=gen, device=dev,
                                     dtype=torch.float64)})
    return frames


J1_QUERIES = {          # name: (left frame, right frame, right side unique)
    "q1_small": ("fact_small", "dim_small", True),
    "q2_medium": ("fact_medium", "dim_medium", True),
    "q5_big": ("fact_big", "dim_big", True),
    "medium_fanout3": ("fact_medium", "dim_medium_fanout", False),
    "medium_swapped": ("dim_medium", "fact_medium", False),
}


def plain_join(lk, rk, unique):
    """(li, ri) int64 of an inner join of keys >= 1, in left-row order with
    right-row order inside: a dense table when rk is unique, else a
    stable sort + searchsorted + repeat_interleave."""
    dev = lk.device
    if unique:
        tbl = torch.full((int(torch.maximum(lk.max(), rk.max())),), -1, dtype=torch.int64,
                         device=dev)
        tbl[rk.long() - 1] = torch.arange(rk.numel(), device=dev)
        r = tbl[lk.long() - 1]
        li = torch.nonzero(r >= 0).squeeze(1)
        return li, r[li]
    sk, perm = torch.sort(rk, stable=True)
    lo = torch.searchsorted(sk, lk)
    cnt = torch.searchsorted(sk, lk, right=True) - lo
    M = int(cnt.sum())
    li = torch.repeat_interleave(torch.arange(lk.numel(), device=dev), cnt, output_size=M)
    within = torch.arange(M, device=dev) - torch.repeat_interleave(
        torch.cumsum(cnt, 0) - cnt, cnt, output_size=M)
    return li, perm[torch.repeat_interleave(lo, cnt, output_size=M) + within]


def plain_merge(left, right, unique):
    """The same merge in plain PyTorch: {name: tensor}, key from the left."""
    li, ri = plain_join(left._table["id"].data, right._table["id"].data, unique)
    out = {n: c.data[li] for n, c in left._table.items()}
    out.update({n: c.data[ri] for n, c in right._table.items() if n != "id"})
    return out


def check_merge(name, res, exp):
    check(list(res._table.names) == list(exp), f"{name}: columns {res._table.names}")
    for col, want in exp.items():
        c = res._table[col]
        check(c.validity is None or bool(c.validity.all()), f"{name} {col}: nulls")
        same(c.data, want, f"{name} {col}", float_rtol=0.0)
    return len(res)


def j1_model_inputs(frames, size):
    n_dim = J1_DIMS[size]
    lk = frames[f"fact_{size}"]._table["id"].data
    rk = frames[f"dim_{size}"]._table["id"].data
    return torch.where(lk <= n_dim, lk - 1, -1), rk - 1, n_dim


def plain_probe(lcodes, rcodes, n_dim):
    """Per probe row the build row or -1, with a dense table."""
    tbl = torch.full((n_dim,), -1, dtype=torch.int32, device=lcodes.device)
    tbl[rcodes.long()] = torch.arange(rcodes.numel(), dtype=torch.int32, device=lcodes.device)
    return torch.where(lcodes >= 0, tbl[lcodes.clamp(min=0).long()], -1)


def check_j1_model(j1_join, rows, lcodes, rcodes, n_dim, size):
    _, pv, bid, unique = j1_join(lcodes, rows, rcodes, n_dim)
    check(unique, f"j1_join {size}: build not unique")
    exp = plain_probe(lcodes, rcodes, n_dim)
    found = bid >= 0
    order = torch.argsort(pv[found])
    check(torch.equal(pv[found][order].long(), torch.nonzero(exp >= 0).squeeze(1)),
          f"j1_join {size}: matched probe rows differ")
    check(torch.equal(bid[found][order], exp[exp >= 0]), f"j1_join {size}: build rows differ")


def beside_phase(dev, gen, rp, ha, other_dir):
    """Kernels A and D at the main path's shapes beside another checkout's
    (``--beside DIR``, e.g. the parent unpacked by ``git archive``), in
    this process on the same data: DIR's kernel library is built from its
    own sources and its wrappers are loaded beside this checkout's; four
    rounds in turns, each shape the median of REPS warm runs.  One process
    keeps out kernel D's process-to-process spread (PERF.md §6).
    Where DIR's wrappers take one value column a call, its q4 and q5
    shapes are one call a column."""
    import importlib.util
    from pathlib import Path
    from cudf_tpu_torch.kernels import _build

    def load(name, path):
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

    root = Path(other_dir).resolve() / "cudf_tpu_torch" / "kernels"
    libs = {"this": _build.library(),
            "beside": _build._Library(load("beside_build", root / "_build.py").build(), 0.0)}
    o_rp = load("beside_radix_partition", root / "radix_partition.py")
    o_ha = load("beside_hash_aggregate", root / "hash_aggregate.py")
    q = [torch.randint(lo, hi, (N,), generator=gen, device=dev, dtype=torch.int32)
         for lo, hi in ((1, 6), (1, 16))]
    q.append(torch.rand(N, generator=gen, device=dev, dtype=torch.float64) * 100)
    k100 = torch.randint(0, K_LOW, (N,), generator=gen, device=dev, dtype=torch.int32)
    k6 = torch.randint(0, K_HIGH, (N,), generator=gen, device=dev, dtype=torch.int32)
    pk, pv, base, G = rp.radix_partition(k6, q, 20)
    del k6
    rk = torch.randperm(N, generator=gen, device=dev, dtype=torch.int32)
    rid1 = torch.arange(1, N + 1, dtype=torch.int32, device=dev)
    pay = rp.payload_bits(torch.randn(N, generator=gen, device=dev, dtype=torch.float64))
    jk, (jr, jp), jbase, jG = rp.radix_partition(rk, [rid1, pay], 27)
    del rk, rid1, pay
    torch.cuda.empty_cache()

    def shapes(r, h):
        lists_d, lists_a = hasattr(r, "MAX_AGG_COLUMNS"), hasattr(h, "MAX_COLUMNS")
        return {
            "A, bench K = 100's one f64 column": lambda: h.onehot_groupby_aggregate(
                k100, q[2], K_LOW, with_minmax=False),
            "A, q4's three columns": (
                (lambda: h.onehot_groupby_aggregate(k100, q, K_LOW, with_minmax=False))
                if lists_a else lambda: [h.onehot_groupby_aggregate(
                    k100, v, K_LOW, with_minmax=False) for v in q]),
            "D, q5's three columns over the sorted route": (
                (lambda: r.bucket_aggregate(pk, pv, base, G)) if lists_d else
                lambda: [r.bucket_aggregate(pk, v, base, G, with_counts=j == 0)
                         for j, v in enumerate(pv)]),
            "D, one f64 column over the sorted route": lambda: r.bucket_aggregate(
                pk, pv[2], base, G),
            "D, id alone at J1 big": lambda: r.window_tables(jk, jr, jbase, jG),
            "D, id + idpay at J1 big": lambda: r.window_tables(jk, jr, jbase, jG, jp),
        }

    calls = {"this": shapes(rp, ha), "beside": shapes(o_rp, o_ha)}
    out = {shape: {"this": [], "beside": []} for shape in calls["this"]}
    for rnd in range(4):
        for side in (("this", "beside") if rnd % 2 == 0 else ("beside", "this")):
            _build._library = libs[side]
            for shape, fn in calls[side].items():
                out[shape][side].append(device_ms(fn))
    _build._library = libs["this"]
    for shape, times in out.items():
        log(f"beside {shape}: this {[round(t, 3) for t in times['this']]} ms, "
            f"{other_dir} {[round(t, 3) for t in times['beside']]} ms")
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--beside", metavar="DIR",
                        help="only time kernels A and D beside those of the checkout in DIR "
                             "(e.g. the parent commit), in one process on the same data")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    cards = torch.cuda.device_count()
    check(cards == 1, f"{cards} cards visible; the smoke drives one "
                      "(set CUDA_VISIBLE_DEVICES to a single card)")
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"phase 1 device: {kind}; torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"card: {smi}")

    import cudf_tpu_torch as ct
    from cudf_tpu_torch.kernels import _build
    from cudf_tpu_torch.kernels import hash_aggregate as ha
    from cudf_tpu_torch.kernels import radix_partition as rp
    from cudf_tpu_torch.kernels import tile_sort as ts
    from cudf_tpu_torch.models import j1_join

    t0 = time.perf_counter()
    reported = {"merge_scatter": "merge_scatter.cu", "bucket_aggregate": "radix_partition.cu",
                "onehot_groupby_aggregate": "hash_aggregate.cu"}
    with concurrent.futures.ThreadPoolExecutor(len(reported)) as pool:
        # ptxas -v of G, D and A, and D's and A's shared atomics in SASS, beside the build
        ptxas = {k: pool.submit(_build.ptxas_report, _build.CSRC / src)
                 for k, src in reported.items()}
        fns = {"bucket_aggregate": "bucket_aggregate_kernel",
               "onehot_groupby_aggregate": "onehot_aggregate_kernel"}
        sass = {k: pool.submit(_build.sass_opcodes, _build.CSRC / reported[k], "ATOMS")
                for k in fns}
        lib = _build.library()
        ptxas = {k: [line for line in f.result() if "ptxas info" in line or "stack frame" in line]
                 for k, f in ptxas.items()}
        sass = {k: {fn: ops for fn, ops in f.result().items() if fns[k] in fn}
                for k, f in sass.items()}
    log(f"phase 2 build: {time.perf_counter() - t0:.1f} s ({lib.path.name})")
    for k, lines in ptxas.items():
        for line in lines:
            log(f"  {k} {line}")
    for k, fns in sass.items():
        for fn, ops in fns.items():
            log(f"  {k} SASS shared atomics of {fn}: {ops}")

    gen = torch.Generator(device=dev).manual_seed(SEED)
    if args.beside:
        log(json.dumps({"beside": args.beside, "card": smi,
                        "ms": beside_phase(dev, gen, rp, ha, args.beside)}))
        return 0
    kernels = kernel_phase(dev, gen, ha, rp, ts)
    for k, lines in ptxas.items():
        kernels[k]["ptxas"] = lines
    for k, fns in sass.items():
        kernels[k]["sass_shared_atomics"] = fns
    torch.cuda.empty_cache()
    log("phase 3 G1 kernels: all six agree with their plain versions")

    wrappers = {"onehot_groupby_aggregate": ha.onehot_groupby_aggregate,
                "digit_histogram": rp.digit_histogram,
                "radix_scatter": rp.radix_scatter,
                "tile_sort": ts.tile_sort,
                "tile_sort_data": ts.tile_sort_data,
                "merge_scatter": rp.merge_scatter,
                "bucket_aggregate": rp.bucket_aggregate,
                "window_probe": rp.window_probe}
    paths = {"g1": ["onehot_groupby_aggregate", "digit_histogram", "tile_sort_data",
                    "merge_scatter", "bucket_aggregate"],
             "j1": ["digit_histogram", "tile_sort_data", "merge_scatter", "bucket_aggregate",
                    "window_probe"]}
    launches = {name: {} for name in wrappers}
    second_pass = {}

    def drive(path, run):
        """Run one main path with every count at 0 before, read after."""
        for fn in wrappers.values():
            fn.launches = 0
        rp.radix_partition.second_passes = 0
        out = run()
        torch.cuda.synchronize()
        for name, fn in wrappers.items():
            launches[name][path] = fn.launches
        second_pass[path] = rp.radix_partition.second_passes
        for name in paths[path]:
            check(launches[name][path] > 0, f"kernel {name} was not launched by the {path} path")
        return out

    df = g1_frame(ct, dev, gen)
    results = drive("g1", lambda: {name: df.groupby(key).agg(spec)
                                   for name, (key, spec) in QUERIES.items()})
    for name, (key, spec) in QUERIES.items():
        check_query(name, results[name], plain_query(df, key, spec))
    del results
    log(f"phase 4 G1 main path: q4, q5, bench K=100 and K=1e6 agree with plain torch; "
        f"launches { {k: v['g1'] for k, v in launches.items()} }")
    by_query = {}
    for name, (key, spec) in QUERIES.items():   # each query alone, every count at 0 before
        for fn in wrappers.values():
            fn.launches = 0
        df.groupby(key).agg(spec)
        torch.cuda.synchronize()
        by_query[name] = {k: fn.launches for k, fn in wrappers.items() if fn.launches}
    log(f"phase 4 G1 launches by query: {by_query}")
    check(by_query["q4"].get("onehot_groupby_aggregate") == 1, "q4: one kernel A launch")
    check(by_query["q5"].get("bucket_aggregate") == 1, "q5: one kernel D launch")
    wide = wide_frame(ct, df)
    spec = {name: "sum" for name in wide._table.names if name != "id6"}
    check_query("q5 six values", wide.groupby("id6").agg(spec),
                plain_query(wide, "id6", spec))
    del wide
    torch.cuda.empty_cache()
    log("phase 4 G1 six value columns by id6 (more payloads than one partition "
        "launch carries) agree with plain torch")

    for name, (key, spec) in QUERIES.items():
        ms = device_ms(lambda: df.groupby(key).agg(spec))
        plain = device_ms(lambda: plain_query(df, key, spec))
        log(f"phase 5 G1 {name}: {ms:.3f} ms = {N / ms * 1e3:.4g} rows/s; plain torch "
            f"{plain:.3f} ms = {N / plain * 1e3:.4g} rows/s [{smi}]")
    del df
    torch.cuda.empty_cache()

    j1_rows, j1_modes, route_ms = j1_kernel_phase(dev, gen, rp, ts)
    kernels.update(j1_rows)
    kernels["merge_scatter"]["route_ms_j1_big"] = route_ms
    for name, modes in j1_modes.items():
        if modes:
            kernels[name].setdefault("modes", {}).update(modes)
    torch.cuda.empty_cache()
    log("phase 3 J1 kernels: D's id/idpay modes, B, C, E, F, G and H (five shapes) agree "
        "exactly with their plain versions")

    frames = j1_frames(ct, dev, gen)
    results = drive("j1", lambda: {
        name: frames[left].merge(frames[right], on="id")
        for name, (left, right, _) in J1_QUERIES.items()})
    for name, (left, right, unique) in J1_QUERIES.items():
        rows = check_merge(name, results.pop(name),
                           plain_merge(frames[left], frames[right], unique))
        log(f"phase 4 J1 {name}: {rows} rows, equal to the plain torch join")
    torch.cuda.empty_cache()
    check(second_pass["j1"] > 0, "the J1 path ran no second pass of the sorted route")
    log(f"phase 4 J1 main path: launches { {k: v['j1'] for k, v in launches.items()} }; "
        f"second passes of the sorted route: {second_pass['j1']}")
    rows_i = torch.arange(N, dtype=torch.int32, device=dev)
    for size in J1_DIMS:
        check_j1_model(j1_join, rows_i, *j1_model_inputs(frames, size), size)
    log("phase 4 J1 models.j1_join: small, medium and big agree with plain torch")

    for name, (left, right, unique) in J1_QUERIES.items():
        lf, rf = frames[left], frames[right]
        probe = max(len(lf), len(rf))
        ms = device_ms(lambda: lf.merge(rf, on="id"))
        plain = device_ms(lambda: plain_merge(lf, rf, unique))
        log(f"phase 5 J1 merge {name}: {ms:.3f} ms = {probe / ms * 1e3:.4g} probe rows/s; "
            f"plain torch {plain:.3f} ms = {probe / plain * 1e3:.4g} probe rows/s [{smi}]")
        torch.cuda.empty_cache()
    for size in J1_DIMS:
        lcodes, rcodes, n_dim = j1_model_inputs(frames, size)
        ms = device_ms(lambda: j1_join(lcodes, rows_i, rcodes, n_dim))
        plain = device_ms(lambda: plain_probe(lcodes, rcodes, n_dim))
        log(f"phase 5 J1 j1_join {size}: {ms:.3f} ms = {N / ms * 1e3:.4g} probe rows/s; "
            f"plain torch {plain:.3f} ms = {N / plain * 1e3:.4g} probe rows/s [{smi}]")

    sources = {"onehot_groupby_aggregate": (ha.SOURCE, ha.REPLACES),
               "window_probe": (rp.PROBE_SOURCE, rp.REPLACES["window_probe"]),
               "merge_scatter": (rp.MERGE_SOURCE, rp.REPLACES["merge_scatter"])}
    for name in ("tile_sort", "tile_sort_data"):
        sources[name] = (ts.SOURCE, ts.REPLACES[name])
    for name in ("digit_histogram", "radix_scatter", "bucket_aggregate"):
        sources[name] = (rp.SOURCE, rp.REPLACES[name])
    log(smi)
    keys = ("source", "replaces", "launches", "launches_by_path", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    rows = []
    for name, row in kernels.items():
        row.update(source=sources[name][0], replaces=sources[name][1],
                   launches=sum(launches[name].values()), launches_by_path=launches[name],
                   launches_by_g1_query={q: c.get(name, 0) for q, c in by_query.items()})
        rows.append(dict(name=name, route="cuda", **{k: row[k] for k in keys},
                         **{k: v for k, v in row.items() if k not in keys}))
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": cards}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
