"""Radix partition, windowed aggregation and window probe: kernels B, C,
D, G and H.

Port of ``cudf_tpu/kernels/radix_partition.py`` for the groupby and
join tiers:

- ``digit_histogram`` (kernel B) replaces the Pallas ``digit_histogram``;
- ``radix_scatter`` (kernel C) replaces ``radix_scatter``, the
  reference's ``merge_tiles = 1`` partition route;
- ``merge_scatter`` (kernel G) replaces ``merge_scatter``; after
  ``tile_sort_data`` (kernel F, ``kernels/tile_sort.py``) it is the
  reference's default ``merge_tiles = 4`` route, which the main path runs;
- ``bucket_aggregate`` (kernel D) replaces ``bucket_aggregate`` in its
  ``float`` and ``int`` modes, one launch for up to three value columns
  of mixed dtypes, and serves its ``id`` and ``idpay`` modes too
  (``window_tables``, one launch);
- ``window_probe`` (kernel H) replaces ``window_probe``;
- ``radix_partition`` and ``radix_groupby_sum_count`` chain B, F, G (or
  C) and D for the groupby, ``build_join_tables``,
  ``radix_join_inner_unique`` and ``radix_join_inner_multi`` chain them
  and H for the join.

The CUDA sources' notes (``csrc/radix_partition.cu``,
``csrc/merge_scatter.cu``, ``csrc/window_probe.cu``) say what bounds each
kernel on the H100 and what its design does about that.

Differences from the reference, all because Hopper scatters single
elements and has int64/fp64 atomics:

- Data stays flat: keys ``int32[n]`` and payload tensors ``[n]`` of their
  own dtype, not plane-interleaved ``[P, R, 128]`` int32 rows.
- Partitions are exact.  The valid rows are the first ``base[-1]`` of the
  output, bucket ``b`` holds rows ``[base[b], base[b+1])``, and negative
  keys are dropped.  There is no SENTINEL fill and no run-edge garbage,
  so nothing needs a host sync to size its output.
- The sorted route passes as the reference's: one pass to 2^20 keys, two
  beyond (the second orders by the low 20 bits inside first-pass regions
  padded to whole supertiles), but the single or first pass sorts under
  ``mask_bits = domain_bits`` where the reference sorts the whole key:
  the same order from fewer bits.  The scatter route takes one pass to 2^27:
  its digit is the window id ``key >> 13`` (up to 14 bits), and its tile
  keeps the ``[tiles, buckets]`` histogram within ``MAX_TABLE`` entries
  (see :func:`choose_tile`).
- Sums are int64 for integer values and float64 for float values.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple, Union

import torch

from cudf_tpu_torch.kernels import _build
from cudf_tpu_torch.kernels._build import MAX_PAYLOADS, check_columns, column_arrays
from cudf_tpu_torch.kernels.tile_sort import check_mask_bits, sort_key_plain, tile_sort_data

SOURCE = "cudf_tpu_torch/csrc/radix_partition.cu"
MERGE_SOURCE = "cudf_tpu_torch/csrc/merge_scatter.cu"
PROBE_SOURCE = "cudf_tpu_torch/csrc/window_probe.cu"
REPLACES = {          # the Pallas kernel of the same name, file:line
    "digit_histogram": "cudf_tpu/kernels/radix_partition.py:93",
    "radix_scatter": "cudf_tpu/kernels/radix_partition.py:336",
    "merge_scatter": "cudf_tpu/kernels/radix_partition.py:291",
    # all four modes: float and int directly, id and idpay through
    # window_tables
    "bucket_aggregate": "cudf_tpu/kernels/radix_partition.py:509",
    "window_probe": "cudf_tpu/kernels/radix_partition.py:895",
}

WINDOW_BITS = 13
SPAN = 1 << WINDOW_BITS          # keys per aggregation window
MAX_DOMAIN_BITS = 27
MAX_TABLE = 1 << 22              # histogram entries (16 MB of int32)
MIN_TILE = 1 << 12               # keys per scatter-route tile: one kernel C chunk
AGG_ROWS = 1 << 17               # rows per aggregation step (kernel D)
MAX_AGG_COLUMNS = 3              # value columns per kernel D launch (shared memory)
MERGE_TILES = 4                  # sort tiles per supertile (the reference's default)
SORT_TILE = 1 << 12              # keys per sort tile (kernel F)
PASS_BITS = 7                    # digit bits per pass of the sorted route
MAX_SUPER_TILE = 1 << 14         # keys per merge_scatter supertile (shared memory)
MAX_MERGE_BITS = 10
MAX_TABLES = 4                   # stacked id tables per probe (join fan-out)
STAGE_MIN_ROWS = 512             # kernel H stages a window from this many rows in a block
PART_BLOCKS_PER_SM = 2           # kernel B cuts tiles until this many blocks an SM have rows
SCATTER_BITS = 7                 # digit bits of one kernel C pass (one 8-bit ranking pass)

_HIST_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                  ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
_SCATTER_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                     ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
_MERGE_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
_AGG_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                 ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
                 ctypes.c_void_p]
_PROBE_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]


# ----------------------------------------------------------------------
# kernel B: per-tile digit histogram
# ----------------------------------------------------------------------

def tile_parts(n_tiles: int, tile: int, nbits: int, sms: int) -> Tuple[int, int]:
    """(parts, part_len): the blocks kernel B gives each tile, of
    part_len keys each (parts * part_len >= tile).  A tile is cut only
    while the grid has fewer than PART_BLOCKS_PER_SM blocks for each of
    the ``sms`` SMs, and never into parts below MIN_TILE keys or 8 keys a
    bucket: each part adds its 2^nbits bins into the tile's row once (at
    1e8 keys and 2^14 buckets: 191 tiles of 524,288 keys in 2 parts, one
    wave of kernel B's three blocks an SM).
    part_len is a multiple of 4 keys (B's 16-byte loads)."""
    want = -(-PART_BLOCKS_PER_SM * sms // max(n_tiles, 1))
    parts = max(1, min(want, tile // max(MIN_TILE, 8 << nbits)))
    part_len = -(-tile // parts)
    part_len = -(-part_len // 4) * 4
    return -(-tile // part_len), part_len


def digit_histogram(keys: torch.Tensor, nbits: int, shift: int,
                    tile: int) -> torch.Tensor:
    """hist int32[ceil(n / tile), 2^nbits]: per tile of ``tile`` keys, the
    count of each digit ``(key >> shift) & (2^nbits - 1)``.  Negative keys
    are not counted.  CUDA tensors launch kernel B, counted in
    ``digit_histogram.launches``; a tile is cut over several blocks as
    :func:`tile_parts` says (the kernel zeroes and adds into it then)."""
    n = _build.check_keys(keys)
    if not 1 <= nbits <= MAX_DOMAIN_BITS - WINDOW_BITS or tile < 1:
        raise ValueError(f"nbits {nbits} / tile {tile} out of range")
    if keys.device.type == "cpu":
        return digit_histogram_plain(keys, nbits, shift, tile)
    hist = torch.empty((-(-n // tile), 1 << nbits), dtype=torch.int32,
                       device=keys.device)
    if n:
        sms = torch.cuda.get_device_properties(keys.device).multi_processor_count
        parts, part_len = tile_parts(-(-n // tile), tile, nbits, sms)
        _build.launch("cudf_digit_histogram", _HIST_ARGTYPES, keys.device,
                      keys.data_ptr(), n, shift, nbits, tile, part_len, parts,
                      hist.data_ptr())
        digit_histogram.launches += 1
    return hist


digit_histogram.launches = 0


def digit_histogram_plain(keys, nbits, shift, tile):
    """The same function in plain PyTorch: one bincount over
    (tile, digit) pairs, negative keys in a spill bin."""
    n, B = keys.shape[0], 1 << nbits
    nt = -(-n // tile)
    digit = torch.where(keys >= 0, (keys >> shift) & (B - 1), B).long()
    tile_id = torch.arange(n, device=keys.device) // tile
    flat = torch.bincount(tile_id * (B + 1) + digit, minlength=nt * (B + 1))
    return flat.view(nt, B + 1)[:, :B].to(torch.int32)


# ----------------------------------------------------------------------
# layout glue (plain torch on both devices; replaces layout_device)
# ----------------------------------------------------------------------

def partition_offsets(hist: torch.Tensor, region_of_tile: Optional[torch.Tensor] = None,
                      n_regions: int = 1, align: int = 1
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(offsets int32[NT, B], base int64[n_regions * B + 1]) from a
    histogram (the reference's ``layout_device``, exact).

    Tile t's digit b goes to window g = region_of_tile[t] * B + b (one
    region when region_of_tile is None; a second pass's tiles each lie in
    one first-pass region, in region order).  Window g's rows are
    ``[base[g], base[g+1])``, its size rounded up to a multiple of
    ``align``, and hold its tiles' runs in tile order: offsets[t, b] is
    the first slot of tile t's run of digit b.
    """
    nt, B = hist.shape
    h = hist.long()
    # over the tiles before, scanned along the inner dim of the transpose:
    # torch scans dim 0 of [tiles, buckets] as an outer dim, far slower on
    # the card (PERF.md, section 6)
    excl = torch.cumsum(h.t().contiguous(), 1).t() - h
    if region_of_tile is None:
        totals = h.sum(dim=0)
        corr = 0
        g = torch.arange(B, device=hist.device).expand(nt, B)
    else:
        region = region_of_tile.long()
        totals = torch.zeros(n_regions, B, dtype=torch.int64,
                             device=hist.device).index_add_(0, region, h).view(-1)
        first = torch.searchsorted(region, torch.arange(n_regions, device=hist.device))
        corr = excl[first.clamp(max=max(nt - 1, 0))[region]]   # scan at the region's start
        g = region.unsqueeze(1) * B + torch.arange(B, device=hist.device)
    if align > 1:
        totals = (totals + align - 1) // align * align
    base = torch.cat([totals.new_zeros(1), torch.cumsum(totals, 0)])
    offsets = (base[g] + excl - corr).to(torch.int32).contiguous()
    return offsets, base


def choose_tile(n: int, nbits: int) -> int:
    """Keys per scatter-route tile: at least MIN_TILE (one kernel C chunk,
    so that the blocks working at once write neighbouring runs of each
    bucket), and large enough that the [tiles, 2^nbits] histogram has at
    most MAX_TABLE entries (for n = 1e8: 4096 keys at 2^7 buckets,
    K = 1e6; 524288 at 2^14, K = 2^27).  A power of two."""
    need = max(MIN_TILE, -(-n * (1 << nbits) // MAX_TABLE))
    return 1 << (need - 1).bit_length()


# ----------------------------------------------------------------------
# kernel C: scatter each tile's elements to their bucket's region
# ----------------------------------------------------------------------

def radix_scatter(keys: torch.Tensor, payloads: Sequence[torch.Tensor],
                  offsets: torch.Tensor, nbits: int, shift: int,
                  tile: int) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(out_keys int32[n], out_payloads) partitioned by digit.

    ``offsets`` comes from :func:`partition_offsets` of the same keys'
    histogram at the same ``tile``.  Payloads are 4- or 8-byte tensors
    [n] that travel with their keys (at most MAX_PAYLOADS).  Rows with a
    negative key are dropped; the valid rows are the first
    ``offsets``-total of each output.  The scatter is stable: each
    (tile, bucket) run holds its rows in input order, so the valid rows
    equal :func:`radix_scatter_plain`'s bit for bit.

    CUDA tensors launch kernel C, counted in ``radix_scatter.launches``:
    one block a tile, and up to SCATTER_BITS digit bits one launch at
    ``offsets``.  Wider digits take two stable passes, as an LSD radix
    sort does: the low half of the digit bits, then the high half, each
    with its own histogram (two :func:`digit_histogram` launches) at
    :func:`choose_tile`'s tile, so that each pass writes runs that
    coalesce; the result is the same stable order, and ``offsets`` is
    only checked."""
    payloads = list(payloads)
    n = check_columns(keys, payloads)
    if not 1 <= nbits <= MAX_DOMAIN_BITS - WINDOW_BITS or tile < 1:
        raise ValueError(f"nbits {nbits} / tile {tile} out of range")
    nt = -(-n // tile)
    _build.check_vector("offsets", offsets.view(-1), torch.int32, nt << nbits,
                        keys.device)
    if keys.device.type == "cpu":
        return radix_scatter_plain(keys, payloads, offsets, nbits, shift, tile)
    if nbits <= SCATTER_BITS:
        return _scatter_pass(keys, payloads, offsets, nbits, shift, tile)
    return two_pass_scatter(keys, payloads, nbits, shift, _scatter_pass)


def two_pass_scatter(keys, payloads, nbits, shift, one_pass):
    """The stable partition by a digit of nbits bits as two stable passes
    of ``one_pass`` (kernel C's launch, or radix_scatter_plain), low bits
    first, each at its own histogram and choose_tile's tile.  The first
    pass writes into keys prefilled with -1, so that the rows past its
    valid ones are dropped by the second."""
    n = keys.shape[0]
    low = nbits // 2
    tile = choose_tile(n, nbits - low)
    offsets, _ = partition_offsets(digit_histogram(keys, low, shift, tile))
    keys, payloads = one_pass(keys, payloads, offsets, low, shift, tile,
                              torch.full_like(keys, -1))
    offsets, _ = partition_offsets(digit_histogram(keys, nbits - low, shift + low, tile))
    return one_pass(keys, payloads, offsets, nbits - low, shift + low, tile)


def _scatter_pass(keys, payloads, offsets, nbits, shift, tile, out_keys=None):
    """One launch of kernel C (nbits <= SCATTER_BITS)."""
    n = keys.shape[0]
    out_keys = torch.empty_like(keys) if out_keys is None else out_keys
    outs = [torch.empty_like(p) for p in payloads]
    if n:
        src, dst, widths = column_arrays(payloads, outs)
        _build.launch("cudf_radix_scatter", _SCATTER_ARGTYPES, keys.device,
                      keys.data_ptr(), n, shift, nbits, tile, offsets.data_ptr(),
                      out_keys.data_ptr(), len(payloads), ctypes.addressof(src),
                      ctypes.addressof(dst), ctypes.addressof(widths))
        radix_scatter.launches += 1
    return out_keys, outs


radix_scatter.launches = 0


def partition_occupancy(kernel: str, nbits: int, payload_bytes: int = 0) -> dict:
    """Kernel B's (``"digit_histogram"``) or C's (``"radix_scatter"``, with
    payloads of ``payload_bytes`` a row in all) registers, resident blocks
    per SM, threads and shared memory per block (static and dynamic,
    bytes) on the current CUDA device at 2^nbits buckets (C: at most
    SCATTER_BITS, one pass)."""
    out = [ctypes.c_int(0) for _ in range(4)]
    dev = torch.device("cuda", torch.cuda.current_device())
    which = ("digit_histogram", "radix_scatter").index(kernel)
    _build.launch("cudf_partition_occupancy", [ctypes.c_int] * 3
                  + [ctypes.c_void_p] * 4, dev, which, nbits, payload_bytes,
                  *[ctypes.addressof(v) for v in out])
    return dict(zip(("registers", "blocks_per_sm", "threads", "smem_bytes"),
                    (v.value for v in out)))


def radix_scatter_plain(keys, payloads, offsets, nbits, shift, tile, out_keys=None):
    """The same partition in plain PyTorch: a stable argsort of the valid
    rows by digit places each (tile, bucket) run at its offset, in input
    order.  The keys go into ``out_keys`` when it is given."""
    B = 1 << nbits
    keep = torch.nonzero(keys >= 0).squeeze(1)
    order = keep[torch.argsort((keys[keep] >> shift) & (B - 1), stable=True)]
    m = order.shape[0]
    out_keys = torch.empty_like(keys) if out_keys is None else out_keys
    out_keys[:m] = keys[order]
    outs = []
    for p in payloads:
        o = torch.empty_like(p)
        o[:m] = p[order]
        outs.append(o)
    return out_keys, outs


# ----------------------------------------------------------------------
# kernel G: merge sorted tiles into supertiles and write their runs
# ----------------------------------------------------------------------

def _check_merge(nbits, shift, super_tile, tile, mask_bits):
    if not 1 <= nbits <= MAX_MERGE_BITS or shift < 0 or shift + nbits > 31:
        raise ValueError(f"nbits {nbits} / shift {shift} out of range")
    if not 1 <= tile <= super_tile <= MAX_SUPER_TILE or super_tile % tile:
        raise ValueError(f"super_tile {super_tile} must be a multiple of tile {tile}, "
                         f"at most {MAX_SUPER_TILE}")
    if mask_bits is not None and mask_bits != shift + nbits:
        raise ValueError(f"mask_bits {mask_bits}: the digit must be the mask's top "
                         f"bits (shift + nbits = {shift + nbits})")


def merge_scatter(keys: torch.Tensor, payloads: Sequence[torch.Tensor],
                  offsets: torch.Tensor, nbits: int, shift: int, super_tile: int,
                  tile: int, mask_bits: Optional[int] = None,
                  out_rows: Optional[int] = None
                  ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(out_keys int32[rows], out_payloads) partitioned by digit (kernel G).

    ``keys`` and ``payloads`` come from ``tile_sort_data(..., tile,
    alternate=True, mask_bits)``; ``offsets`` from :func:`partition_offsets`
    of the same keys' histogram at ``super_tile`` (a multiple of ``tile``)
    granularity.  Each supertile's rows are merged into one stable order
    by the sort's key (ties by tile, then position) and its run of each
    bucket ``(key >> shift) & (2^nbits - 1)`` is written, in that order, at
    its offset.  Negative keys are dropped.  The bucket must be the top
    bits of the order key: keys below 2^(shift + nbits), or mask_bits =
    shift + nbits.  rows = ``out_rows`` or n; rows no run covers hold key
    -1 and zero payloads when ``out_rows`` is given (a first pass's padded
    regions, whose offsets are a single-region layout: partition_offsets
    without region_of_tile) and are unspecified otherwise.  CUDA tensors
    launch kernel G, counted in ``merge_scatter.launches``; its outputs
    are allocated empty, and with ``out_rows`` the kernel writes -1 and 0
    over the rows no run covers (each region's tail, the rows past the
    last region) itself."""
    payloads = list(payloads)
    n = check_columns(keys, payloads)
    _check_merge(nbits, shift, super_tile, tile, mask_bits)
    mask = check_mask_bits(mask_bits)
    ns = -(-n // super_tile)
    _build.check_vector("offsets", offsets.view(-1), torch.int32, ns << nbits, keys.device)
    if out_rows is not None and not n <= out_rows < 1 << 31:
        raise ValueError(f"out_rows {out_rows} outside [n, 2^31)")
    if keys.device.type == "cpu":
        return merge_scatter_plain(keys, payloads, offsets, nbits, shift, super_tile, tile,
                                   mask_bits, out_rows)
    out_keys, outs = _merge_outputs(keys, payloads, out_rows, prefill=n == 0)
    if n:
        src, dst, widths = column_arrays(payloads, outs)
        _build.launch("cudf_merge_scatter", _MERGE_ARGTYPES, keys.device, keys.data_ptr(), n,
                      shift, nbits, super_tile, tile, mask, offsets.data_ptr(),
                      out_keys.data_ptr(), out_keys.shape[0], int(out_rows is not None),
                      len(payloads), ctypes.addressof(src), ctypes.addressof(dst),
                      ctypes.addressof(widths))
        merge_scatter.launches += 1
    return out_keys, outs


merge_scatter.launches = 0


def merge_scatter_occupancy(super_tile: int, nbits: int) -> dict:
    """Kernel G's resident blocks per SM, threads per block and dynamic
    shared memory per block (bytes) on the current CUDA device at this
    supertile and digit width."""
    out = [ctypes.c_int(0) for _ in range(3)]
    dev = torch.device("cuda", torch.cuda.current_device())
    _build.launch("cudf_merge_scatter_occupancy", [ctypes.c_int, ctypes.c_int]
                  + [ctypes.c_void_p] * 3, dev, super_tile, nbits,
                  *[ctypes.addressof(v) for v in out])
    return dict(zip(("blocks_per_sm", "threads", "smem_bytes"), (v.value for v in out)))


def _merge_outputs(keys, payloads, out_rows, prefill=True):
    """merge_scatter's outputs: n rows, or out_rows rows, prefilled with
    key -1 and zero payloads when ``prefill`` (kernel G writes those rows
    itself)."""
    if out_rows is None:
        return torch.empty_like(keys), [torch.empty_like(p) for p in payloads]
    if not prefill:
        return (torch.empty(out_rows, dtype=torch.int32, device=keys.device),
                [torch.empty(out_rows, dtype=p.dtype, device=keys.device) for p in payloads])
    return (torch.full((out_rows,), -1, dtype=torch.int32, device=keys.device),
            [torch.zeros(out_rows, dtype=p.dtype, device=keys.device) for p in payloads])


def merge_scatter_plain(keys, payloads, offsets, nbits, shift, super_tile, tile,
                        mask_bits=None, out_rows=None):
    """The same function in plain PyTorch: odd tiles flipped back, a
    stable sort of each supertile by the order key, then each valid row
    placed at its run's offset plus its rank in the run."""
    n, B = keys.shape[0], 1 << nbits
    dev = keys.device
    pos = torch.arange(n, device=dev)
    t0 = pos // tile * tile
    tlen = (n - t0).clamp(max=tile)
    asc = torch.where((pos // tile) % 2 == 1, 2 * t0 + tlen - 1 - pos, pos)
    st = pos // super_tile
    order = (st << 32) + sort_key_plain(keys[asc], mask_bits) + (1 << 31)
    merged = asc[torch.argsort(order, stable=True)]
    k = keys[merged]
    valid = torch.nonzero(k >= 0).squeeze(1)
    rows, k = merged[valid], k[valid].long()
    run = st[valid] * B + ((k >> shift) & (B - 1))
    by_run = torch.argsort(run, stable=True)
    rows, run = rows[by_run], run[by_run]
    first = torch.searchsorted(run, run)
    to = offsets.view(-1).long()[run] + torch.arange(run.shape[0], device=dev) - first
    out_keys, outs = _merge_outputs(keys, payloads, out_rows)
    out_keys[to] = keys[rows]
    for o, p in zip(outs, payloads):
        o[to] = p[rows]
    return out_keys, outs


# ----------------------------------------------------------------------
# the partition: the sorted route (B, F, G) or the scatter route (B, C)
# ----------------------------------------------------------------------

def _scatter_route(keys, vals, domain_bits, tile):
    """One pass of kernel C at nbits = domain_bits - 13."""
    nbits = domain_bits - WINDOW_BITS
    tile = choose_tile(keys.shape[0], nbits) if tile is None else tile
    hist = digit_histogram(keys, nbits, WINDOW_BITS, tile)
    offsets, base = partition_offsets(hist)
    pkeys, pvals = radix_scatter(keys, vals, offsets, nbits, WINDOW_BITS, tile)
    return pkeys, pvals, base


def _sorted_pass(keys, vals, nbits, shift, tile, super_tile, offsets, mask_bits=None,
                 out_rows=None):
    sk, sv = tile_sort_data(keys, vals, tile, alternate=True, mask_bits=mask_bits)
    return merge_scatter(sk, sv, offsets, nbits, shift, super_tile, tile, mask_bits,
                         out_rows)


def _sorted_route(keys, vals, domain_bits, tile, merge_tiles):
    """The reference's route: one pass of F and G to 2^20 keys; beyond,
    a first pass on the top bits into regions padded to whole supertiles
    (pad keys -1), then 7 bits per region ordered by the low 20 bits.

    The single pass and the first pass sort under ``mask_bits =
    domain_bits``: keys lie below 2^domain_bits, so the order, and every
    window, is the signed key's, from domain_bits + 1 bits instead of 32
    (the reference sorts them unmasked)."""
    n = keys.shape[0]
    st = merge_tiles * tile
    if domain_bits <= WINDOW_BITS + PASS_BITS:
        nbits = domain_bits - WINDOW_BITS
        offsets, base = partition_offsets(digit_histogram(keys, nbits, WINDOW_BITS, st))
        pkeys, pvals = _sorted_pass(keys, vals, nbits, WINDOW_BITS, tile, st, offsets,
                                    mask_bits=domain_bits)
        return pkeys, pvals, base
    shift1 = WINDOW_BITS + PASS_BITS
    nbits1 = domain_bits - shift1
    regions = 1 << nbits1
    off1, base1 = partition_offsets(digit_histogram(keys, nbits1, shift1, st), align=st)
    rows1 = (-(-n // st) + regions) * st          # >= base1[-1], without a host sync
    k1, v1 = _sorted_pass(keys, vals, nbits1, shift1, tile, st, off1, mask_bits=domain_bits,
                          out_rows=rows1)
    starts = torch.arange(rows1 // st, device=keys.device) * st
    region = torch.searchsorted(base1[1:], starts, right=True).clamp_(max=regions - 1)
    off2, base = partition_offsets(digit_histogram(k1, PASS_BITS, WINDOW_BITS, st),
                                   region, regions)
    pkeys, pvals = _sorted_pass(k1, v1, PASS_BITS, WINDOW_BITS, tile, st, off2,
                                mask_bits=shift1)
    radix_partition.second_passes += 1
    return pkeys[:n], [v[:n] for v in pvals], base


def radix_partition(keys: torch.Tensor, vals: Sequence[torch.Tensor],
                    domain_bits: int, tile: Optional[int] = None,
                    merge_tiles: int = MERGE_TILES):
    """Partition rows into SPAN-key windows.

    Returns (pkeys int32[n], pvals, base int64[G + 1], G) with
    G = 2^(domain_bits - 13) windows: window g's rows are
    ``[base[g], base[g+1])`` and hold keys in ``[g * SPAN, (g+1) * SPAN)``.
    Keys must lie below 2^domain_bits; rows with negative keys are
    dropped, and rows past ``base[-1]`` are unspecified.

    ``merge_tiles`` (a power of two) picks the reference's route.  At 1,
    kernel C with ``tile`` keys per tile (default :func:`choose_tile`;
    two stable passes above SCATTER_BITS digit bits); each window holds
    its rows in input order.  Above 1
    (default 4), the sorted route: kernel F sorts tiles of ``tile`` keys
    (default SORT_TILE) and kernel G merges ``merge_tiles`` of them per
    supertile and writes its runs, each sorted by key; one pass to 2^20
    keys, two beyond.

    The keys are partitioned once.  Beyond MAX_PAYLOADS values, that
    partition carries the row ids, and the values that do not fit in it
    are gathered through them."""
    if not WINDOW_BITS < domain_bits <= MAX_DOMAIN_BITS:
        raise ValueError(f"domain_bits {domain_bits} outside "
                         f"({WINDOW_BITS}, {MAX_DOMAIN_BITS}]")
    if merge_tiles < 1 or merge_tiles & (merge_tiles - 1):
        raise ValueError(f"merge_tiles {merge_tiles}: a power of two")
    n = keys.shape[0]
    vals = list(vals)
    carry = vals
    if len(vals) > MAX_PAYLOADS:
        rows = torch.arange(n, dtype=torch.int32, device=keys.device)
        carry = [rows] + vals[:MAX_PAYLOADS - 1]
    if merge_tiles == 1:
        pkeys, pvals, base = _scatter_route(keys, carry, domain_bits, tile)
    else:
        pkeys, pvals, base = _sorted_route(keys, carry, domain_bits,
                                           SORT_TILE if tile is None else tile, merge_tiles)
    if len(vals) > MAX_PAYLOADS:
        prows, *pvals = pvals
        prows.clamp_(0, n - 1)           # rows past base[-1] hold garbage ids
        pvals += [v.index_select(0, prows) for v in vals[MAX_PAYLOADS - 1:]]
    return pkeys, pvals, base, 1 << (domain_bits - WINDOW_BITS)


radix_partition.second_passes = 0    # sorted-route second passes run (two-pass domains)


# ----------------------------------------------------------------------
# kernel D: per-window sum and count
# ----------------------------------------------------------------------

def step_table(base: torch.Tensor, n_rows: int, agg_rows: int):
    """(step_win int32[S], step_lo int64[S], step_hi int64[S]): window g's
    rows cut into chunks of agg_rows, one step each (counterpart of
    step_table_device).  S = ceil(n_rows / agg_rows) + G bounds the step
    count without a host sync; steps past the end have window -1."""
    G = base.shape[0] - 1
    nst = (base[1:] - base[:-1] + agg_rows - 1) // agg_rows
    cum = torch.cumsum(nst, 0)
    s = torch.arange(-(-n_rows // agg_rows) + G, device=base.device)
    g = torch.searchsorted(cum, s, right=True)
    live = g < G
    g = g.clamp(max=G - 1)
    lo = base[g] + (s - (cum[g] - nst[g])) * agg_rows
    hi = torch.minimum(lo + agg_rows, base[g + 1])
    return torch.where(live, g, -1).to(torch.int32), lo, hi


Values = Union[torch.Tensor, Sequence[torch.Tensor]]


def bucket_aggregate(pkeys: torch.Tensor, pvals: Values, base: torch.Tensor,
                     num_windows: int, agg_rows: int = AGG_ROWS, with_counts: bool = True):
    """(sums, counts[G * SPAN] int64 or None) per key over partitioned
    rows: window g's rows ``[base[g], base[g+1])`` add into keys
    ``[g * SPAN, (g+1) * SPAN)``; keys outside their row's window are
    dropped.  ``pvals`` is one value tensor (sums is then one tensor
    [G * SPAN]) or a non-empty list of them, dtypes mixed (sums is then a
    list): the rows are read once for all, and counted once.  Sums are
    int64 for integer values, float64 for floats.

    CUDA tensors launch kernel D, counted in ``bucket_aggregate.launches``:
    one launch for up to MAX_AGG_COLUMNS columns (the rest in more
    launches of as many, which count nothing).  Its outputs are allocated
    empty: the launch writes every slot.  Windows are cut into steps of
    ``agg_rows`` rows (``step_table``); a window of one step is summed by
    one block, which stores its slots."""
    n = _build.check_keys(pkeys)
    single = isinstance(pvals, torch.Tensor)
    vals = [pvals] if single else list(pvals)
    if not vals:
        raise ValueError("bucket_aggregate needs at least one value tensor")
    for v in vals:
        _build.check_vector("pvals", v, v.dtype, n, pkeys.device)
    _build.check_vector("base", base, torch.int64, num_windows + 1, pkeys.device)
    if agg_rows < 1:
        raise ValueError(f"agg_rows {agg_rows}: at least 1")
    if pkeys.device.type == "cpu":
        return bucket_aggregate_plain(pkeys, pvals, base, num_windows, with_counts)
    kvs = [_build.kernel_values(v) for v in vals]
    size = num_windows * SPAN
    sums = [torch.empty(size, dtype=acc, device=pkeys.device) for _, _, acc in kvs]
    counts = (torch.empty(size, dtype=torch.int64, device=pkeys.device)
              if with_counts else None)
    win, lo, hi = step_table(base, n, agg_rows)
    for start in range(0, len(vals), MAX_AGG_COLUMNS):
        part = range(start, min(start + MAX_AGG_COLUMNS, len(vals)))
        src = (ctypes.c_void_p * MAX_AGG_COLUMNS)(*[kvs[j][0].data_ptr() for j in part])
        kinds = (ctypes.c_int * MAX_AGG_COLUMNS)(*[kvs[j][1] for j in part])
        dst = (ctypes.c_void_p * MAX_AGG_COLUMNS)(*[sums[j].data_ptr() for j in part])
        _build.launch("cudf_bucket_aggregate", _AGG_ARGTYPES, pkeys.device,
                      pkeys.data_ptr(), len(part), ctypes.addressof(src),
                      ctypes.addressof(kinds), win.data_ptr(), lo.data_ptr(), hi.data_ptr(),
                      win.shape[0], base.data_ptr(), num_windows, agg_rows,
                      ctypes.addressof(dst), _build.ptr(counts) if start == 0 else None)
        bucket_aggregate.launches += 1
    return (sums[0] if single else sums), counts


bucket_aggregate.launches = 0


def bucket_aggregate_occupancy(n_cols: int) -> dict:
    """Kernel D's registers a thread, resident blocks per SM, threads per
    block and dynamic shared memory per block (bytes) on the current CUDA
    device at ``n_cols`` value columns a launch."""
    out = [ctypes.c_int(0) for _ in range(4)]
    dev = torch.device("cuda", torch.cuda.current_device())
    _build.launch("cudf_bucket_aggregate_occupancy", [ctypes.c_int] + [ctypes.c_void_p] * 4,
                  dev, n_cols, *[ctypes.addressof(v) for v in out])
    return dict(zip(("registers", "blocks_per_sm", "threads", "smem_bytes"),
                    (v.value for v in out)))


def bucket_aggregate_plain(pkeys, pvals, base, num_windows, with_counts=True):
    """The same function in plain PyTorch (index_add_ / bincount), for one
    value tensor or a list of them, as ``bucket_aggregate``."""
    single = isinstance(pvals, torch.Tensor)
    m = int(base[-1])
    rows_per_window = base[1:] - base[:-1]
    win = torch.repeat_interleave(torch.arange(num_windows, device=pkeys.device),
                                  rows_per_window)
    k = pkeys[:m].long()
    ok = (k >= 0) & ((k >> WINDOW_BITS) == win)
    k = k[ok]
    size = num_windows * SPAN
    sums = []
    for v in ([pvals] if single else pvals):
        kv, _, acc = _build.kernel_values(v)
        sums.append(torch.zeros(size, dtype=acc, device=pkeys.device).index_add_(
            0, k, kv[:m][ok].to(acc)))
    counts = torch.bincount(k, minlength=size) if with_counts else None
    return (sums[0] if single else sums), counts


# ----------------------------------------------------------------------
# end-to-end dense-key groupby
# ----------------------------------------------------------------------

def radix_groupby_sum_count(keys: torch.Tensor, vals: Values, num_keys: int,
                            tile: Optional[int] = None, agg_rows: int = AGG_ROWS):
    """(sums, counts int64[num_keys]) for int32 keys in [0, num_keys),
    num_keys <= 2^27; negative keys are dropped.

    ``vals`` is one tensor (sums is then one tensor) or a non-empty list
    of value tensors that share the keys (sums is then a list): the keys
    are partitioned once for all of them, and one kernel D call sums them
    all.  Domains within one window aggregate the raw rows; larger ones
    are partitioned first.
    """
    if not 1 <= num_keys <= 1 << MAX_DOMAIN_BITS:
        raise ValueError(f"num_keys {num_keys} outside [1, 2^{MAX_DOMAIN_BITS}]")
    single = isinstance(vals, torch.Tensor)
    vlist = [_build.kernel_values(v)[0] for v in ([vals] if single else vals)]
    if not vlist:
        raise ValueError("radix_groupby_sum_count needs at least one value tensor")
    bits = domain_bits(num_keys)
    if bits <= WINDOW_BITS:
        pkeys, pvals, G = keys, vlist, 1
        base = torch.tensor([0, keys.shape[0]], dtype=torch.int64, device=keys.device)
    else:
        pkeys, pvals, base, G = radix_partition(keys, vlist, bits, tile)
    sums, counts = bucket_aggregate(pkeys, pvals, base, G, agg_rows)
    sums = [s[:num_keys] for s in sums]
    return (sums[0] if single else sums), counts[:num_keys]


# ----------------------------------------------------------------------
# join build side: kernel D's id and idpay modes
# ----------------------------------------------------------------------

def domain_bits(key_domain: int) -> int:
    """Bits of a key domain [0, key_domain): ceil(log2), at least 1."""
    return max((max(key_domain, 1) - 1).bit_length(), 1)


def payload_bits(payload: torch.Tensor) -> torch.Tensor:
    """A 4- or 8-byte payload's bits as int32 or int64 (no copy)."""
    if payload.element_size() == 4:
        return payload.view(torch.int32)
    if payload.element_size() == 8:
        return payload.view(torch.int64)
    raise TypeError(f"join payload dtype {payload.dtype}: 4 or 8 bytes per element")


def _from_bits(bits: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of payload_bits over a table's int64 entries."""
    return (bits.to(torch.int32) if dtype.itemsize == 4 else bits).view(dtype)


def window_tables(pkeys: torch.Tensor, rid1: torch.Tensor, base: torch.Tensor,
                  num_windows: int, pay_bits: Optional[torch.Tensor] = None,
                  agg_rows: int = AGG_ROWS):
    """Kernel D's ``id`` and ``idpay`` modes (the reference's ``_agg_kernel``
    with ``mode="id"`` / ``"idpay"``): per key over partitioned build rows,
    (ids int64[G * SPAN] = sum of build_row_id + 1, counts int64[G * SPAN],
    pay int64[G * SPAN] = sum of the payload's bits, or None).

    These are kernel D's int mode over ``rid1`` (int32 build_row_id + 1)
    with counts and, for idpay, over ``pay_bits`` (``payload_bits`` of the
    payload) too: one launch either way.  Where a key has one build row
    the sums are that row's id + 1 and its payload's bits exactly, so a
    lookup copies the payload (NaN and -0.0 included); an empty slot holds
    0, since kernel D writes every slot."""
    vals = [rid1] if pay_bits is None else [rid1, pay_bits]
    sums, counts = bucket_aggregate(pkeys, vals, base, num_windows, agg_rows)
    return sums[0], counts, (None if pay_bits is None else sums[1])


def _build_tables(rk: torch.Tensor, key_domain: int, rv: Optional[torch.Tensor],
                  tile: Optional[int], agg_rows: int):
    """(ids, counts, pay or None, G) of window_tables over the build keys,
    partitioned first when the domain spans more than one window."""
    n = _build.check_keys(rk)
    rid1 = torch.arange(1, n + 1, dtype=torch.int32, device=rk.device)
    vals = [rid1] if rv is None else [rid1, payload_bits(rv)]
    bits = domain_bits(key_domain)
    if bits <= WINDOW_BITS:
        pk, pv, G = rk, vals, 1
        base = torch.tensor([0, n], dtype=torch.int64, device=rk.device)
    else:
        pk, pv, base, G = radix_partition(rk, vals, bits, tile)
    ids, counts, pay = window_tables(pk, pv[0], base, G,
                                     None if rv is None else pv[1], agg_rows)
    return ids, counts, pay, G


def build_join_tables(rk: torch.Tensor, key_domain: int,
                      rv: Optional[torch.Tensor] = None, tile: Optional[int] = None,
                      agg_rows: int = AGG_ROWS):
    """The build side of a join (reference ``build_join_tables``):
    (ids int64[G * SPAN], pay int64[G * SPAN] or None, unique, G).

    rk: int32 build key codes in [0, key_domain), key_domain <= 2^27;
    negative codes (nulls) are left out.  rv: an optional 4- or 8-byte
    build payload.  ids[k] is build_row_id + 1 of key k, 0 where no row
    has it; pay[k] the payload's bits.  Both are exact only when
    ``unique``: one host sync for counts.max() <= 1, as the reference's
    probe_tables makes.

    The tables are kernel D's outputs, which hold 0 in every slot no row
    reaches, so an empty window reads as "no match": the reference's
    zero_empty_windows,
    probe_tables_raw's occupancy mask and occupancy_step_tab (the probe's
    occupancy bit) have no counterpart here."""
    ids, counts, pay, G = _build_tables(rk, key_domain, rv, tile, agg_rows)
    unique = int(counts.max()) <= 1
    return ids, pay, unique, G


# ----------------------------------------------------------------------
# kernel H: look partitioned probe keys up in the window tables
# ----------------------------------------------------------------------

def _check_tables(pkeys, base, tables, pay, pay_dtype):
    if (tables.dtype != torch.int64 or tables.dim() != 2 or tables.device != pkeys.device
            or not tables.is_contiguous() or not 1 <= tables.shape[0] <= MAX_TABLES
            or tables.shape[1] == 0 or tables.shape[1] % SPAN):
        raise ValueError(f"tables: expected contiguous int64[m <= {MAX_TABLES}, G * {SPAN}] "
                         f"on {pkeys.device}, got {tables.dtype}{list(tables.shape)} "
                         f"on {tables.device}")
    m, size = tables.shape
    _build.check_vector("base", base, torch.int64, size // SPAN + 1, pkeys.device)
    if pay is not None:
        _build.check_vector("pay", pay, torch.int64, size, pkeys.device)
        if m != 1 or pay_dtype is None or pay_dtype.itemsize not in (4, 8):
            raise ValueError("a payload table goes with one id table and a 4- or "
                             "8-byte pay_dtype")


def window_probe(pkeys: torch.Tensor, base: torch.Tensor, tables: torch.Tensor,
                 pay: Optional[torch.Tensor] = None, pay_dtype: Optional[torch.dtype] = None,
                 stage_min_rows: int = STAGE_MIN_ROWS):
    """(bids int32[m, n], payload[n] of pay_dtype or None) for partitioned
    probe keys (the reference's ``window_probe``).

    pkeys: int32[n], window g's rows ``[base[g], base[g+1])`` holding keys
    in ``[g * SPAN, (g+1) * SPAN)``.  tables: int64[m, G * SPAN], m <= 4
    stacked ``window_tables`` ids (one per duplicate ordinal).  pay:
    ``window_tables``' payload bits, with m == 1 and the payload's dtype.
    bids[t, i] = tables[t, key] - 1: the build row, or -1 where the slot
    is empty, the key is out of its window or the row lies past
    ``base[-1]``; the payload is copied where bids[0] >= 0, else 0.  CUDA
    tensors launch kernel H, counted in ``window_probe.launches``; it
    writes every output row and looks a window up in shared memory when
    at least ``stage_min_rows`` of its rows fall in one block's chunk
    (the result does not depend on it)."""
    n = _build.check_keys(pkeys)
    _check_tables(pkeys, base, tables, pay, pay_dtype)
    if stage_min_rows < 1:
        raise ValueError(f"stage_min_rows {stage_min_rows}: at least 1")
    if pkeys.device.type == "cpu":
        return window_probe_plain(pkeys, base, tables, pay, pay_dtype)
    m, size = tables.shape
    bids = torch.empty((m, n), dtype=torch.int32, device=pkeys.device)
    out = None if pay is None else torch.empty(n, dtype=pay_dtype, device=pkeys.device)
    _build.launch("cudf_window_probe", _PROBE_ARGTYPES, pkeys.device,
                  pkeys.data_ptr(), n, base.data_ptr(), size // SPAN, tables.data_ptr(), m,
                  _build.ptr(pay), 0 if pay is None else pay_dtype.itemsize, stage_min_rows,
                  bids.data_ptr(), _build.ptr(out))
    window_probe.launches += 1
    return bids, out


window_probe.launches = 0


def window_probe_plain(pkeys, base, tables, pay=None, pay_dtype=None):
    """The same lookup in plain PyTorch: where(in_window, table[key], 0) - 1
    over the rows of base's windows, and the payload gather."""
    m, n = tables.shape[0], pkeys.shape[0]
    G = base.shape[0] - 1
    rows = int(base[-1])
    win = torch.repeat_interleave(torch.arange(G, device=pkeys.device), base[1:] - base[:-1])
    k = pkeys[:rows].long()
    in_window = (k >= 0) & ((k >> WINDOW_BITS) == win)
    entry = torch.where(in_window, tables[:, k.clamp(0, tables.shape[1] - 1)], 0)
    bids = torch.full((m, n), -1, dtype=torch.int32, device=pkeys.device)
    bids[:, :rows] = (entry - 1).to(torch.int32)
    if pay is None:
        return bids, None
    out = torch.zeros(n, dtype=pay_dtype, device=pkeys.device)
    found = torch.nonzero(entry[0] > 0).squeeze(1)
    out[found] = _from_bits(pay[k[found]], pay_dtype)
    return bids, out


# ----------------------------------------------------------------------
# joins
# ----------------------------------------------------------------------

def _probe_side(lk: torch.Tensor, lv: torch.Tensor, key_domain: int,
                tile: Optional[int]):
    """(pkeys, pvals, base): the probe rows partitioned like the build
    side's, or as they are when the domain fits one window."""
    _build.check_vector("lv", lv, lv.dtype, _build.check_keys(lk), lk.device)
    bits = domain_bits(key_domain)
    if bits <= WINDOW_BITS:
        return lk, lv, torch.tensor([0, lk.shape[0]], dtype=torch.int64, device=lk.device)
    pk, (pv,), base, _ = radix_partition(lk, [lv], bits, tile)
    return pk, pv, base


def radix_join_inner_unique(lk: torch.Tensor, lv: torch.Tensor, rk: torch.Tensor,
                            key_domain: int, rv: Optional[torch.Tensor] = None,
                            tile: Optional[int] = None, agg_rows: int = AGG_ROWS):
    """Inner join against a unique-key build side (db-benchmark J1 shape;
    the reference's ``radix_join_inner_unique``).

    lk, rk: int32 key codes in [0, key_domain), key_domain <= 2^27;
    negative codes never match.  lv: a 4- or 8-byte probe payload that
    travels with the probe keys (typically the probe row ids).  rv: an
    optional 4- or 8-byte build payload, retrieved through the tables.
    Returns (probe_keys, probe_vals, bid[, pay], unique) in partitioned
    row order: the valid rows are the first ``base[-1]`` (all rows when
    the domain fits one window), and bid is the matched build row, -1 for
    no match and for every row past ``base[-1]``; pay the matched build
    payload, 0 where there is none.  Domains within one window skip the
    partition pass.  When the build side is not unique, the probe is
    skipped: bid and pay are None and unique is False."""
    ids, pay_tab, unique, _ = build_join_tables(rk, key_domain, rv, tile, agg_rows)
    if not unique:
        return (lk, lv, None, False) if rv is None else (lk, lv, None, None, False)
    pk, pv, base = _probe_side(lk, lv, key_domain, tile)
    bids, pay = window_probe(pk, base, ids.view(1, -1), pay_tab,
                             None if rv is None else rv.dtype)
    if rv is None:
        return pk, pv, bids[0], True
    return pk, pv, bids[0], pay, True


def radix_join_inner_multi(lk: torch.Tensor, lv: torch.Tensor, rk: torch.Tensor,
                           key_domain: int, m_max: int = MAX_TABLES,
                           tile: Optional[int] = None, agg_rows: int = AGG_ROWS):
    """Inner join against a build side with at most m_max rows per key
    (the reference's ``radix_join_inner_multi``).

    Each build row's ordinal among the rows of its key comes from one
    stable sort of the build keys plus searchsorted; table j holds the
    j-th row of each key, and one probe looks all of them up.  Returns
    (probe_keys, probe_vals, bids int32[mult, n], mult) in partitioned row
    order as radix_join_inner_unique; a probe row with c matches finds
    them in bids[0..c-1], in build-row order.  When the largest fan-out
    mult exceeds m_max, returns (None, None, None, mult)."""
    tables, mult = ordinal_tables(rk, key_domain, m_max, tile, agg_rows)
    if tables is None:
        return None, None, None, mult
    pk, pv, base = _probe_side(lk, lv, key_domain, tile)
    bids, _ = window_probe(pk, base, tables)
    return pk, pv, bids, mult


def ordinal_tables(rk: torch.Tensor, key_domain: int, m_max: int = MAX_TABLES,
                   tile: Optional[int] = None, agg_rows: int = AGG_ROWS):
    """(tables int64[mult, G * SPAN], mult): table j holds build_row_id + 1
    of the j-th build row of each key (build-row order), or (None, mult)
    when the largest fan-out mult exceeds m_max.  Null (negative) keys
    are left out; one host sync for mult."""
    if not 1 <= m_max <= MAX_TABLES:
        raise ValueError(f"m_max {m_max} outside [1, {MAX_TABLES}]")
    n_r = _build.check_keys(rk)
    sk, perm = torch.sort(rk, stable=True)
    ords = torch.arange(n_r, device=rk.device) - torch.searchsorted(sk, sk)
    mult = int(torch.where(sk >= 0, ords, 0).max()) + 1 if n_r else 1
    if mult > m_max:
        return None, mult
    ordinal = torch.empty_like(ords)
    ordinal[perm] = ords
    tables = []
    for j in range(mult):
        rk_j = torch.where((ordinal == j) & (rk >= 0), rk, -1)
        tables.append(_build_tables(rk_j, key_domain, None, tile, agg_rows)[0])
    return torch.stack(tables), mult
