"""The hashing, partitioning, bloom, pack, t-digest, text, window,
resample, as-of and expression requests on the card, each beside a plain
PyTorch version written apart from the port.

- ``frames`` holds ``g1`` (db-benchmark G1: ``id1``-``id3`` DICTIONARY32
  over "id001".."id100" / "id0000000001"..., ``id4``, ``id5`` in 1..100,
  ``id6`` in 1..1e6, ``v1`` in 1..5, ``v2`` in 1..15, ``v3`` in [0, 100)),
  ``id3s`` (``id3`` as 12-byte text) and ``text`` (``id1 + " " + id2 +
  " " + id3``: 24 bytes a row, three tokens), built by ``prepare``; or
  ``fact`` and ``dim`` (J1 big's int32 ids); or ``lineitem`` (TPC-H's,
  sorted by ``l_shipdate`` in ``prepare``: midnight ns timestamps).
- ``REQUESTS[name](frames)`` is the call a user writes;
  ``ANSWERS[name](result, frames)`` and ``PLAIN[name](frames)`` give the
  same ``{key: tensor}``, compared at ``RTOL[name]`` (0: exact).  The
  plain versions lean on the data's shapes: every text row is 24 bytes
  (an [n, 24] byte matrix), every ship date a midnight (days).
- ``NEEDS[name]`` are the kernels of A-H a request launches: the
  resamples' bins reach the one-hot tier (A); nothing else launches one
  (partitions take a stable argsort, the rest are sorts, scans, searches
  and elementwise ops).  ``ROUTE[name]`` is "device", "vmap" (a vmapped
  UDF, ``frame/series.py`` ``UDF_ROUTES``) or "host" (the reference's host
  tier: a checksum and the host text functions, counted in
  ``ops/_utils.py`` ``HOST_ROUTES``), and a host request reads the
  ``HOST_ROWS`` first rows.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

from cudf_tpu_torch.ops import partitioning
from cudf_tpu_torch.ops import text as text_ops

TEXT_ROWS_SMALL = 10_000_000          # the n-gram, minhash and Jaccard requests
HOST_ROWS = {"hash_md5": 100_000, "edit_distance": 10_000, "porter_measure": 100_000,
             "wordpiece": 100_000, "byte_pair_encoding": 100_000}
WINDOW = 1000
TDIGEST_DELTA = 100
MINHASH_SEEDS = [0, 1, 2 ** 40 + 7, 2 ** 63 + 11]
VOCAB = {"id": 0, **{f"##{d}": 1 + d for d in range(10)}, "[UNK]": 11}
MERGES = [("i", "d")]
ASOF_TOLERANCE_DAYS = 7
ENGINE_PERIOD = 30
DAY_NS = 86_400 * 10 ** 9
M32, M64 = 0xFFFFFFFF, (1 << 64) - 1
SIGN = -(1 << 63)


def _s64(u: int) -> int:
    u &= M64
    return u - (1 << 64) if u >= 1 << 63 else u


def _lshr(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x >> r) & ((1 << (64 - r)) - 1)


def prepare(frames) -> dict:
    """G1's text columns, and lineitem sorted by its ship date."""
    from cudf_tpu_torch.models import strings_dt

    if "g1" in frames and "text" not in frames:
        strings_dt.prepare(frames)
        g1 = frames["g1"]
        frames["text"] = g1["id1"].astype(str) + " " + g1["id2"].astype(str) + " " + \
            frames["id3s"]
    if "lineitem" in frames and "lineitem_sorted" not in frames:
        li = frames["lineitem"][["l_shipdate", "l_commitdate", "l_suppkey", "l_extendedprice"]]
        frames["lineitem_sorted"] = li.sort_values("l_shipdate")
    return frames


# ----------------------------------------------------------------------
# requests
# ----------------------------------------------------------------------

def _head(series, rows):
    return series.iloc[:rows]


def _small_text(f):
    return _head(f["text"], TEXT_ROWS_SMALL)._column


def _reversed_id3(f):
    from cudf_tpu_torch.ops import copying

    return copying.reverse(_head(f["id3s"], TEXT_ROWS_SMALL)._column)


def _pack_round_trip(f):
    from cudf_tpu_torch.ops import pack

    packed = pack.pack(f["g1"]._table)
    return packed, pack.unpack(packed)


def _split_round_trip(f):
    from cudf_tpu_torch.ops import pack

    n = len(f["g1"])
    parts = pack.contiguous_split(f["g1"]._table, [n * i // 8 for i in range(1, 8)])
    return [pack.unpack(p) for p in parts]


def _resample(rule, agg, rows=None):
    def run(f):
        li = f["lineitem_sorted"][["l_shipdate", "l_extendedprice"]]
        if rows is not None:
            li = li.iloc[:rows]
        return getattr(li.resample(rule, on="l_shipdate").l_extendedprice, agg)()
    return run


def _by_ship(f):
    return f["lineitem_sorted"][["l_shipdate", "l_extendedprice"]].set_index(
        "l_shipdate")["l_extendedprice"]


def _asof_sides(f):
    import cudf_tpu_torch as ct

    li = f["lineitem_sorted"]
    by_commit = li[["l_commitdate", "l_suppkey"]].sort_values("l_commitdate")
    left = ct.DataFrame({"t": by_commit["l_commitdate"], "l_suppkey": by_commit["l_suppkey"]})
    right = ct.DataFrame({"t": li["l_shipdate"], "l_suppkey": li["l_suppkey"],
                          "l_extendedprice": li["l_extendedprice"]})
    return left, right


def _merge_asof(direction):
    def run(f):
        import cudf_tpu_torch as ct

        left, right = _asof_sides(f)
        tol = np.timedelta64(ASOF_TOLERANCE_DAYS, "D") if direction == "nearest" else None
        return ct.merge_asof(left, right, on="t", by="l_suppkey", direction=direction,
                             tolerance=tol)
    return run


def _days(f):
    return f["lineitem_sorted"]["l_shipdate"].astype("datetime64[D]")


def _engine_rolling(f):
    from cudf_tpu_torch.engine import ir as IRs

    table = f["lineitem_sorted"]._table.select(["l_shipdate", "l_extendedprice"])
    node = IRs.Rolling(IRs.DataFrameScan(table), "l_shipdate", ENGINE_PERIOD,
                       [("rev", "l_extendedprice", "sum")])
    return node.evaluate()


def _bloom(f):
    from cudf_tpu_torch.ops.bloom import BloomFilter

    bloom = BloomFilter(num_bits=2 ** 30, num_hashes=4)
    bloom.add([f["dim"]._table["id"]])
    return bloom, bloom.maybe_contains([f["fact"]._table["id"]])


def _v3(f):
    return f["g1"]["v3"]


REQUESTS = {
    # G1
    "hash_murmur3_id4_id6": lambda f: f["g1"][["id4", "id6"]].hash_values(),
    "hash_xxhash64_id3": lambda f: f["id3s"].hash_values("xxhash64"),
    "hash_md5": lambda f: _head(f["id3s"], HOST_ROWS["hash_md5"]).hash_values("md5"),
    "hash_partition_id6_64": lambda f: partitioning.hash_partition(f["g1"]._table, ["id6"], 64),
    "round_robin_8": lambda f: partitioning.round_robin_partition(f["g1"]._table, 8),
    "pack_unpack": _pack_round_trip,
    "contiguous_split_8": _split_round_trip,
    "tdigest_id1": lambda f: f["g1"].groupby("id1")["v3"].agg("tdigest"),
    "rolling_sum": lambda f: _v3(f).rolling(WINDOW).sum(),
    "rolling_mean": lambda f: _v3(f).rolling(WINDOW).mean(),
    "rolling_std": lambda f: _v3(f).rolling(WINDOW).std(),
    "rolling_min": lambda f: _v3(f).rolling(WINDOW).min(),
    "rolling_max": lambda f: _v3(f).rolling(WINDOW).max(),
    "rolling_count": lambda f: _v3(f).rolling(WINDOW).count(),
    "rolling_center_sum": lambda f: _v3(f).rolling(WINDOW, min_periods=1, center=True).sum(),
    "grouped_rolling_mean_id4": lambda f: f["g1"].groupby("id4")["v3"].rolling(100).mean(),
    "ewm_mean": lambda f: _v3(f).ewm(alpha=0.1).mean(),
    "rolling_apply_64": lambda f: _v3(f).rolling(64).apply(lambda x: x.max() - x.min(),
                                                           raw=True),
    "query_id4_v3": lambda f: f["g1"].query("id4 > 50 and v3 < 10"),
    "eval_v1_v2": lambda f: f["g1"].eval("v1 * 2 + v2"),
    "count_tokens": lambda f: text_ops.count_tokens(f["text"]._column),
    "tokenize": lambda f: text_ops.tokenize(f["text"]._column),
    "normalize_spaces": lambda f: text_ops.normalize_spaces(f["text"]._column),
    "character_ngrams_3": lambda f: text_ops.character_ngrams(_small_text(f), 3),
    "ngrams_tokenize_2": lambda f: text_ops.ngrams_tokenize(_small_text(f), 2, "_"),
    "minhash_4": lambda f: text_ops.minhash(_small_text(f), MINHASH_SEEDS, 4),
    "jaccard_id3_reversed": lambda f: text_ops.jaccard_index(_small_text(f),
                                                             _reversed_id3(f), 4),
    "edit_distance": lambda f: text_ops.edit_distance(
        _head(f["text"], HOST_ROWS["edit_distance"])._column,
        _head(f["id3s"], HOST_ROWS["edit_distance"])._column),
    "porter_measure": lambda f: text_ops.porter_stemmer_measure(
        _head(f["text"], HOST_ROWS["porter_measure"])._column),
    "wordpiece": lambda f: text_ops.wordpiece_tokenize(
        _head(f["text"], HOST_ROWS["wordpiece"])._column, VOCAB),
    "byte_pair_encoding": lambda f: text_ops.byte_pair_encoding(
        _head(f["text"], HOST_ROWS["byte_pair_encoding"])._column, MERGES),
    # J1 big
    "bloom_j1_big": _bloom,
    # TPC-H SF10 lineitem
    "resample_D_sum": _resample("D", "sum"),
    "resample_D_mean": _resample("D", "mean"),
    "resample_h_sum_1e6": _resample("h", "sum", rows=1_000_000),
    "rolling_7D_sum": lambda f: _by_ship(f).rolling("7D").sum(),
    "rolling_7D_max": lambda f: _by_ship(f).rolling("7D").max(),
    "asof_backward": _merge_asof("backward"),
    "asof_forward": _merge_asof("forward"),
    "asof_nearest_7d": _merge_asof("nearest"),
    "days_year": lambda f: _days(f).dt.year,
    "days_back_ns": lambda f: _days(f).astype("datetime64[ns]"),
    "strftime_weeks": lambda f: f["lineitem_sorted"]["l_shipdate"].dt.strftime(
        "%U %W %u %w %G-%V"),
    "strftime_c": lambda f: f["lineitem_sorted"]["l_shipdate"].dt.strftime("%c"),
    "engine_rolling": _engine_rolling,
}


# ----------------------------------------------------------------------
# answers
# ----------------------------------------------------------------------

def _col(res):
    return res if not hasattr(res, "_column") else res._column


def _values(res, frames) -> dict:
    c = _col(res)
    out = {"values": c.data}
    if c.validity is not None and not bool(c.validity.all()):
        out["valid"] = c.validity
    return out


def _hash_bits(res, frames) -> dict:
    c = _col(res)
    return {"bits": c.data.view(torch.int32 if c.data.element_size() == 4 else torch.int64)}


def _text(res, frames) -> dict:
    c = _col(res)
    return {"chars": c.data, "offsets": c.offsets}


def _lists(res, frames) -> dict:
    c = _col(res)
    child = c.children[0]
    out = {"offsets": c.offsets}
    if child.dtype.is_string:
        out.update(chars=child.data, child_offsets=child.offsets)
    else:
        out["values"] = child.data.view(torch.int64) if child.data.dtype == torch.uint64 \
            else child.data
    return out


def _partition(res, frames) -> dict:
    table, offsets = res
    return {"offsets": offsets, "id6": table["id6"].data, "v3": table["v3"].data}


def _buffers(table) -> dict:
    return {f"{n}_{k}": t for n, c in table.items()
            for k, t in (("data", c.data), ("valid", c.validity)) if t is not None}


def _pack(res, frames) -> dict:
    packed, table = res
    return {"blob": packed.gpu_data, **_buffers(table)}


def _split(res, frames) -> dict:
    """The pieces' buffers, each column's concatenated."""
    out = {}
    for n, c in res[0].items():
        for k, attr in (("data", "data"), ("valid", "validity")):
            if getattr(c, attr) is not None:
                out[f"{n}_{k}"] = torch.cat([getattr(t[n], attr) for t in res])
    return out


def _tdigest_answer(res, frames) -> dict:
    c = res._column
    cent = c.children[0]
    return {"offsets": cent.offsets, "means": cent.children[0].children[0].data,
            "weights": cent.children[0].children[1].data, "min": c.children[1].data,
            "max": c.children[2].data}


def _grouped(res, frames) -> dict:
    """The values, and each row's label (the MultiIndex's last level)."""
    return {"values": res._column.data, "rows": res.index.get_level_values(-1)._column.data}


def _query(res, frames) -> dict:
    return {"v3": res._table["v3"].data, "rows": res.index.column(res.device).data}


def _masked(out: dict, key: str, col, fill) -> dict:
    """``col``'s values under ``key``, ``fill`` at its nulls, and its
    validity under ``<key>_valid`` where it has a null."""
    out[key] = col.data
    if col.validity is not None and not bool(col.validity.all()):
        out[key] = torch.where(col.validity, col.data, fill)
        out[f"{key}_valid"] = col.validity
    return out


def _frame(names):
    def answer(res, frames):
        out = {}
        table = res._table if hasattr(res, "_table") else res
        for n in names:
            _masked(out, n, table[n], 0.0 if n != "rev" else math.nan)
        return out
    return answer


def _series_index(res, frames) -> dict:
    out = _masked({}, "values", res._column, math.nan)
    if "values_valid" in out:
        out["valid"] = out.pop("values_valid")
    out["index"] = res.index.column(res.device).data
    return out


def _bloom_answer(res, frames) -> dict:
    return {"bits": res[0].bits, "maybe": res[1]}


ANSWERS = {name: _values for name in REQUESTS}
ANSWERS.update({
    "hash_murmur3_id4_id6": _hash_bits, "hash_xxhash64_id3": _hash_bits, "hash_md5": _text,
    "hash_partition_id6_64": _partition, "round_robin_8": _partition, "pack_unpack": _pack,
    "contiguous_split_8": _split, "tdigest_id1": _tdigest_answer,
    "grouped_rolling_mean_id4": _grouped, "query_id4_v3": _query, "tokenize": _text,
    "normalize_spaces": _text, "character_ngrams_3": _lists, "ngrams_tokenize_2": _lists,
    "minhash_4": _lists, "wordpiece": _lists, "byte_pair_encoding": _text,
    "bloom_j1_big": _bloom_answer, "strftime_weeks": _text, "strftime_c": _text,
    "resample_D_sum": _series_index,
    "resample_D_mean": _series_index, "resample_h_sum_1e6": _series_index,
    "asof_backward": _frame(["l_extendedprice"]), "asof_forward": _frame(["l_extendedprice"]),
    "asof_nearest_7d": _frame(["l_extendedprice"]), "engine_rolling": _frame(["rev"]),
})


# ----------------------------------------------------------------------
# plain versions
# ----------------------------------------------------------------------

def _murmur_words(words: torch.Tensor, nbytes: int, seed: int = 0) -> torch.Tensor:
    """MurmurHash3_x86_32 (Appleby's published algorithm) of each 4- or
    8-byte value given as int64 bits, in int64 arithmetic."""
    def rotl(x, r):
        return ((x << r) | (x >> (32 - r))) & M32

    h = torch.full_like(words, seed)
    for j in range(nbytes // 4):
        k = (words >> (32 * j)) & M32
        k = (rotl((k * 0xCC9E2D51) & M32, 15) * 0x1B873593) & M32
        h = (rotl(h ^ k, 13) * 5 + 0xE6546B64) & M32
    h ^= nbytes
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & M32
    return h ^ (h >> 16)


def plain_murmur(frames) -> dict:
    t = frames["g1"]._table
    a = _murmur_words(t["id4"].data.long() & M32, 4)
    b = _murmur_words(t["id6"].data.long() & M32, 4)
    h = a ^ ((b + 0x9E3779B9 + ((a << 6) & M32) + (a >> 2)) & M32)
    return {"bits": h.to(torch.int32)}


_X1, _X2, _X3 = _s64(0x9E3779B185EBCA87), _s64(0xC2B2AE3D27D4EB4F), _s64(0x165667B19E3779F9)
_X4, _X5 = _s64(0x85EBCA77C2B2AE63), _s64(0x27D4EB2F165667C5)


def _rotl64(x, r):
    return (x << r) | _lshr(x, 64 - r)


def _xxh64_12(mat: torch.Tensor) -> torch.Tensor:
    """xxHash64 (seed 0, Collet's published algorithm) of 12-byte rows:
    one 8-byte lane, one 4-byte lane, the avalanche."""
    b = mat.long()
    lane8 = sum(b[:, i] << (8 * i) for i in range(8))
    lane4 = sum(b[:, 8 + i] << (8 * i) for i in range(4))
    acc = torch.full_like(lane8, _X5 + 12)
    acc = _rotl64(acc ^ (_rotl64(lane8 * _X2, 31) * _X1), 27) * _X1 + _X4
    acc = _rotl64(acc ^ (lane4 * _X1), 23) * _X2 + _X3
    acc = (acc ^ _lshr(acc, 33)) * _X2
    acc = (acc ^ _lshr(acc, 29)) * _X3
    return acc ^ _lshr(acc, 32)


def _matrix(col) -> torch.Tensor:
    """A text column whose rows are all of one width as [rows, width]."""
    return col.data.view(col.length, -1)


def plain_xxhash(frames) -> dict:
    return {"bits": _xxh64_12(_matrix(frames["id3s"]._column))}


def _text_of(strings, device) -> dict:
    raw = [s.encode() for s in strings]
    offsets = torch.tensor(np.concatenate([[0], np.cumsum([len(r) for r in raw])]),
                           dtype=torch.int64, device=device)
    return {"chars": torch.frombuffer(bytearray(b"".join(raw)), dtype=torch.uint8).to(device),
            "offsets": offsets}


def plain_md5(frames) -> dict:
    col = frames["id3s"]._column
    rows = _matrix(col)[:HOST_ROWS["hash_md5"]].cpu().numpy()
    return _text_of([hashlib.md5(r.tobytes()).hexdigest() for r in rows], col.device)


def _splitmix_int(values: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """The row hash of one non-null integer column: splitmix64's
    finaliser of the value, boost-combined into the seeded start."""
    def mix(x):
        x = x ^ _lshr(x, 33)
        x = x * _s64(0xFF51AFD7ED558CCD)
        x = x ^ _lshr(x, 33)
        x = x * _s64(0xC4CEB9FE1A85EC53)
        return x ^ _lshr(x, 33)

    h = torch.full_like(values, _s64(seed ^ 0x243F6A8885A308D3))
    return h ^ (mix(values) + _s64(0x9E3779B97F4A7C15) + (h << 6) + _lshr(h, 2))


def _partitioned(frames, pids, parts) -> dict:
    t = frames["g1"]._table
    order = torch.argsort(pids, stable=True)
    counts = torch.bincount(pids, minlength=parts)
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    return {"offsets": offsets, "id6": t["id6"].data[order], "v3": t["v3"].data[order]}


def plain_hash_partition(frames) -> dict:
    h = _splitmix_int(frames["g1"]._table["id6"].data.long())
    # the hash's uint64 value modulo 64 is its low six bits
    return _partitioned(frames, h & 63, 64)


def plain_round_robin(frames) -> dict:
    n = len(frames["g1"])
    return _partitioned(frames, torch.arange(n, device=frames["g1"].device) % 8, 8)


def _table_buffers(table):
    """Every buffer of the table in pack's order: data, validity, offsets,
    then the children's."""
    def walk(c):
        for t in (c.data, c.validity, c.offsets):
            if t is not None:
                yield t
        for child in c.children:
            yield from walk(child)
    for c in table.columns:
        yield from walk(c)


def plain_pack(frames) -> dict:
    parts = []
    for t in _table_buffers(frames["g1"]._table):
        raw = t.contiguous().view(torch.uint8)
        parts += [raw, raw.new_zeros(-raw.numel() % 8)]
    return {"blob": torch.cat(parts), **_buffers(frames["g1"]._table)}


def plain_split(frames) -> dict:
    return _buffers(frames["g1"]._table)


def _codes_id1(frames) -> torch.Tensor:
    return frames["g1"]._table["id1"].data.long()


def plain_tdigest(frames) -> dict:
    """Each id1's v3 sorted, each value's centroid floor(k1(q) * delta) of
    its mid-rank quantile, the centroids' sums by index_add_."""
    codes, x = _codes_id1(frames), _v3(frames)._column.data
    order = torch.argsort(x, stable=True)
    order = order[torch.argsort(codes[order], stable=True)]
    g, xs = codes[order], x[order]
    sizes = torch.bincount(g, minlength=int(codes.max()) + 1)
    starts = torch.cumsum(sizes, 0) - sizes
    rank = torch.arange(g.numel(), device=g.device) - starts[g]
    q = (rank.double() + 0.5) / sizes[g].double()
    k = torch.asin(2 * q - 1) / math.pi + 0.5
    cid = g * TDIGEST_DELTA + torch.clamp(torch.floor(k * TDIGEST_DELTA).long(), 0,
                                          TDIGEST_DELTA - 1)
    slots = sizes.numel() * TDIGEST_DELTA
    w = torch.zeros(slots, dtype=torch.float64, device=g.device).index_add_(
        0, cid, torch.ones_like(xs))
    s = torch.zeros(slots, dtype=torch.float64, device=g.device).index_add_(0, cid, xs)
    keep = w > 0
    per = keep.view(-1, TDIGEST_DELTA).sum(1)
    return {"offsets": torch.cat([per.new_zeros(1), torch.cumsum(per, 0)]),
            "means": s[keep] / w[keep], "weights": w[keep],
            "min": xs[starts], "max": xs[starts + sizes - 1]}


def _window_sums(x: torch.Tensor, w: int, shift: float = 0.0):
    """(sums of x - shift, of its squares, rows) over each row's trailing w
    rows: prefix-sum differences in float64."""
    y = x - shift
    pre = torch.cat([y.new_zeros(1), torch.cumsum(y, 0)])
    pre2 = torch.cat([y.new_zeros(1), torch.cumsum(y * y, 0)])
    hi = torch.arange(1, x.numel() + 1, device=x.device)
    lo = torch.clamp(hi - w, min=0)
    return pre[hi] - pre[lo], pre2[hi] - pre2[lo], (hi - lo).double()


def _full(values: torch.Tensor, rows: torch.Tensor, w: int) -> dict:
    return {"values": torch.where(rows >= w, values, math.nan)}


def plain_rolling(kind):
    def run(frames):
        x = _v3(frames)._column.data
        if kind in ("min", "max"):
            sign = -1.0 if kind == "min" else 1.0
            best = torch.nn.functional.max_pool1d((sign * x)[None, None], WINDOW, 1)[0, 0]
            return {"values": torch.cat([x.new_full((WINDOW - 1,), math.nan), sign * best])}
        s, s2, rows = _window_sums(x, WINDOW, shift=50.0)
        if kind == "sum":
            return _full(s + 50.0 * rows, rows, WINDOW)
        if kind == "mean":
            return _full(s / rows + 50.0, rows, WINDOW)
        if kind == "count":
            return _full(rows, rows, WINDOW)
        return _full(torch.sqrt((s2 - s * s / rows) / (rows - 1)), rows, WINDOW)
    return run


def plain_center_sum(frames) -> dict:
    """Prefix-sum differences of v3 - 50 (v3's mean: the prefix sums stay
    small), the windows clipped at the ends."""
    x = _v3(frames)._column.data
    n, off = x.numel(), (WINDOW - 1) // 2
    pre = torch.cat([x.new_zeros(1), torch.cumsum(x - 50.0, 0)])
    end = torch.arange(n, device=x.device) + 1 + off
    hi, lo = torch.clamp(end, max=n), torch.clamp(end - WINDOW, min=0)
    return {"values": pre[hi] - pre[lo] + 50.0 * (hi - lo)}


def plain_grouped_mean(frames) -> dict:
    k, x = frames["g1"]._table["id4"].data, _v3(frames)._column.data
    order = torch.argsort(k, stable=True)
    ks, xs = k[order], x[order]
    pos = torch.arange(xs.numel(), device=xs.device)
    first = torch.searchsorted(ks, ks)
    lo = torch.maximum(pos - 99, first)
    pre = torch.cat([xs.new_zeros(1), torch.cumsum(xs - 50.0, 0)])      # v3's mean off
    mean = (pre[pos + 1] - pre[lo]) / (pos + 1 - lo) + 50.0
    return {"values": torch.where(pos - first >= 99, mean, math.nan), "rows": order}


def plain_ewm(frames) -> dict:
    """adjust=True: sum of 0.9^k x[t - k] over sum of 0.9^k, k <= t, as a
    convolution of 400 taps (0.9^400 is below 2^-60)."""
    x = _v3(frames)._column.data
    taps = 400
    wts = 0.9 ** torch.arange(taps - 1, -1, -1, dtype=torch.float64, device=x.device)
    num = torch.nn.functional.conv1d(torch.nn.functional.pad(x[None, None], (taps - 1, 0)),
                                     wts[None, None])[0, 0]
    t = torch.arange(x.numel(), device=x.device).double()
    den = (1 - 0.9 ** torch.clamp(t + 1, max=taps)) / 0.1
    return {"values": num / den}


def plain_apply(frames) -> dict:
    x = _v3(frames)._column.data
    pool = torch.nn.functional.max_pool1d
    spread = pool(x[None, None], 64, 1)[0, 0] + pool(-x[None, None], 64, 1)[0, 0]
    return {"values": torch.cat([x.new_full((63,), math.nan), spread])}


def plain_query(frames) -> dict:
    t = frames["g1"]._table
    keep = (t["id4"].data > 50) & (t["v3"].data < 10)
    return {"v3": t["v3"].data[keep], "rows": torch.nonzero(keep).squeeze(1)}


def plain_eval(frames) -> dict:
    t = frames["g1"]._table
    # a Python int operand is int64, as the port's binaryop (and the reference) take it
    return {"values": t["v1"].data.long() * 2 + t["v2"].data}


def _text_matrix(frames, rows=None) -> torch.Tensor:
    mat = _matrix(frames["text"]._column)
    return mat if rows is None else mat[:rows]


def plain_count_tokens(frames) -> dict:
    mat = _text_matrix(frames)
    word = mat != 32
    start = word.clone()
    start[:, 1:] &= ~word[:, :-1]
    return {"values": start.sum(1)}


# the text's pieces: id1 [0, 5), id2 [6, 11), id3 [12, 24)
_TOKENS = ((0, 5), (6, 11), (12, 24))


def _rows_text(mat: torch.Tensor) -> dict:
    n, w = mat.shape
    return {"chars": mat.reshape(-1),
            "offsets": torch.arange(0, (n + 1) * w, w, device=mat.device)}


def plain_tokenize(frames) -> dict:
    mat = _text_matrix(frames)
    n = mat.shape[0]
    lens = torch.tensor([b - a for a, b in _TOKENS], device=mat.device).repeat(n)
    return {"chars": torch.cat([mat[:, a:b] for a, b in _TOKENS], 1).reshape(-1),
            "offsets": torch.cat([lens.new_zeros(1), torch.cumsum(lens, 0)])}


def plain_normalize(frames) -> dict:
    return _rows_text(_text_matrix(frames))      # single inner spaces, none at the ends


def _fixed_lists(items: torch.Tensor) -> dict:
    """A [rows, k, width] byte block as LIST<STRING> (k strings a row)."""
    n, k, w = items.shape
    dev = items.device
    return {"offsets": torch.arange(0, (n + 1) * k, k, device=dev),
            "chars": items.reshape(-1),
            "child_offsets": torch.arange(0, (n * k + 1) * w, w, device=dev)}


def plain_char_ngrams(frames) -> dict:
    return _fixed_lists(_text_matrix(frames, TEXT_ROWS_SMALL).unfold(1, 3, 1))


def plain_ngrams_tokenize(frames) -> dict:
    mat = _text_matrix(frames, TEXT_ROWS_SMALL)
    n, dev = mat.shape[0], mat.device
    under = torch.full((n, 1), ord("_"), dtype=torch.uint8, device=dev)
    first = torch.cat([mat[:, 0:5], under, mat[:, 6:11]], 1)          # 11 bytes
    second = torch.cat([mat[:, 6:11], under, mat[:, 12:24]], 1)       # 18 bytes
    lens = torch.tensor([11, 18], device=dev).repeat(n)
    return {"offsets": torch.arange(0, 2 * n + 1, 2, device=dev),
            "chars": torch.cat([first, second], 1).reshape(-1),
            "child_offsets": torch.cat([lens.new_zeros(1), torch.cumsum(lens, 0)])}


def plain_minhash(frames) -> dict:
    """FNV-prime polynomial hashes of every 4-byte shingle, each seed's
    remix, the unsigned minimum a row (sign-flipped signed minimum)."""
    mat = _text_matrix(frames, TEXT_ROWS_SMALL).long()
    sh = mat.unfold(1, 4, 1)                          # [n, 21, 4]
    p = 1099511628211
    h = ((sh[..., 0] * p + sh[..., 1]) * p + sh[..., 2]) * p + sh[..., 3]
    mins = []
    for s in MINHASH_SEEDS:
        x = (h ^ _s64(s)) * p
        x = x ^ _lshr(x, 33)
        mins.append(((x ^ SIGN).min(1).values) ^ SIGN)
    n = mat.shape[0]
    return {"offsets": torch.arange(0, (n + 1) * 4, 4, device=mat.device),
            "values": torch.stack(mins, 1).reshape(-1)}


def _distinct_rows(keys: torch.Tensor) -> torch.Tensor:
    s = torch.sort(keys, 1).values
    return 1 + (s[:, 1:] != s[:, :-1]).sum(1)


def plain_jaccard(frames) -> dict:
    a = _text_matrix(frames, TEXT_ROWS_SMALL).long()
    b = _matrix(frames["id3s"]._column)[:TEXT_ROWS_SMALL].flip(0).long()

    def shingles(m):
        u = m.unfold(1, 4, 1)
        return u[..., 0] | (u[..., 1] << 8) | (u[..., 2] << 16) | (u[..., 3] << 24)

    sa, sb = shingles(a), shingles(b)
    na, nb, nu = _distinct_rows(sa), _distinct_rows(sb), _distinct_rows(torch.cat([sa, sb], 1))
    return {"values": (na + nb - nu).double() / nu.double()}


def plain_edit_distance(frames) -> dict:
    """Levenshtein distance of each row pair, the dynamic program over the
    second string vectorised across rows."""
    rows = HOST_ROWS["edit_distance"]
    x = _text_matrix(frames, rows).long()
    y = _matrix(frames["id3s"]._column)[:rows].long()
    m = y.shape[1]
    prev = torch.arange(m + 1, device=x.device).repeat(rows, 1)
    for i in range(x.shape[1]):
        cur = [torch.full((rows,), i + 1, device=x.device)]
        for j in range(m):
            cost = (x[:, i] != y[:, j]).long()
            cur.append(torch.minimum(torch.minimum(prev[:, j + 1] + 1, cur[j] + 1),
                                     prev[:, j] + cost))
        prev = torch.stack(cur, 1)
    return {"values": prev[:, -1]}


def plain_porter(frames) -> dict:
    """The VC sequences of "idDDD idDDD idDDDDDDDDDD": a vowel is i (no y),
    so each token holds one V followed by C: three a row."""
    mat = _text_matrix(frames, HOST_ROWS["porter_measure"])
    vowel = torch.zeros(256, dtype=torch.bool, device=mat.device)
    vowel[[ord(c) for c in "aeiouAEIOU"]] = True
    v = vowel[mat.long()]
    return {"values": (v[:, :-1] & ~v[:, 1:]).sum(1).int()}


def plain_wordpiece(frames) -> dict:
    """"id" then "##d" for each digit: ids 0 and 1 + d, three tokens a row."""
    mat = _text_matrix(frames, HOST_ROWS["wordpiece"])
    n = mat.shape[0]
    digits = torch.cat([mat[:, 2:5], mat[:, 8:11], mat[:, 14:24]], 1).int() - 48 + 1
    zero = digits.new_zeros(n, 1)
    ids = torch.cat([zero, digits[:, :3], zero, digits[:, 3:6], zero, digits[:, 6:]], 1)
    return {"offsets": torch.arange(0, (n + 1) * 19, 19, device=mat.device),
            "values": ids.reshape(-1)}


def plain_bpe(frames) -> dict:
    """Merging ("i", "d") alone: each token is "id" and its digits, all
    joined by spaces: 40 bytes a row."""
    mat = _text_matrix(frames, HOST_ROWS["byte_pair_encoding"])
    n, dev = mat.shape[0], mat.device
    space = torch.full((n, 1), 32, dtype=torch.uint8, device=dev)
    pieces = []
    for a, b in _TOKENS:
        pieces.append(mat[:, a:a + 2])
        for j in range(a + 2, b):
            pieces += [space, mat[:, j:j + 1]]
        pieces.append(space)
    return _rows_text(torch.cat(pieces[:-1], 1))


def plain_bloom(frames) -> dict:
    """Positions (h1 + i h2) mod 2^32 mod m of two murmur3 seeds."""
    m = 2 ** 30

    def positions(ids):
        words = ids.long() & M32
        h1, h2 = _murmur_words(words, 4, 0), _murmur_words(words, 4, 0x9747B28C)
        return [((h1 + i * h2) & M32) % m for i in range(4)]

    bits = torch.zeros(m, dtype=torch.bool, device=frames["dim"].device)
    for p in positions(frames["dim"]._table["id"].data):
        bits[p] = True
    maybe = None
    for p in positions(frames["fact"]._table["id"].data):
        maybe = bits[p] if maybe is None else maybe & bits[p]
    return {"bits": bits, "maybe": maybe}


def _ship_days(frames, rows=None) -> torch.Tensor:
    t = frames["lineitem_sorted"]._table["l_shipdate"].data
    return t if rows is None else t[:rows]


def _resample_plain(step_ns: int, agg: str, rows=None):
    def run(frames):
        t = _ship_days(frames, rows)
        price = frames["lineitem_sorted"]._table["l_extendedprice"].data
        price = price if rows is None else price[:rows]
        origin = int(t.min()) // DAY_NS * DAY_NS
        b = (t - origin) // step_ns
        lo, hi = int(b.min()), int(b.max())
        sums = torch.zeros(hi - lo + 1, dtype=torch.float64, device=t.device).index_add_(
            0, b - lo, price)
        index = origin + (lo + torch.arange(hi - lo + 1, device=t.device)) * step_ns
        if agg == "sum":
            return {"values": sums, "index": index}
        cnt = torch.bincount(b - lo, minlength=hi - lo + 1)
        out = {"values": sums / cnt}
        if bool((cnt == 0).any()):
            out["valid"] = cnt > 0
        out["index"] = index
        return out
    return run


def _by_days(frames):
    t = frames["lineitem_sorted"]._table
    return t["l_shipdate"].data // DAY_NS, t["l_extendedprice"].data


def plain_rolling_7d_sum(frames) -> dict:
    """The rows whose day is within 7 days before a row's (the row and those
    before it): prefix-sum differences from each row's first such row."""
    days, x = _by_days(frames)
    lo = torch.searchsorted(days, days - 7, right=True)
    pre = torch.cat([x.new_zeros(1), torch.cumsum(x, 0)])
    return {"values": pre[torch.arange(1, x.numel() + 1, device=x.device)] - pre[lo]}


def plain_rolling_7d_max(frames) -> dict:
    """The maximum of the 7 days' maxima before a row's day, and of its own
    day's running maximum."""
    days, x = _by_days(frames)
    d0 = int(days[0])
    d = days - d0
    nd = int(d[-1]) + 1
    day_max = torch.full((nd,), -math.inf, dtype=torch.float64, device=x.device)
    day_max.scatter_reduce_(0, d, x, "amax")
    first = torch.searchsorted(d, d)
    # running maximum within each day: a cummax restarted at the day's first row
    running = x.clone()
    step = 1
    n = x.numel()
    pos = torch.arange(n, device=x.device)
    while step < int((pos - first).max()) + 1:
        prev = torch.cat([x.new_full((step,), -math.inf), running[:-step]])
        running = torch.where(pos - step >= first, torch.maximum(running, prev), running)
        step *= 2
    before = torch.full((n,), -math.inf, dtype=torch.float64, device=x.device)
    for k in range(1, 7):
        dk = d - k
        before = torch.maximum(before, torch.where(dk >= 0, day_max[torch.clamp(dk, min=0)],
                                                   -math.inf))
    return {"values": torch.maximum(before, running)}


def _asof_plain(direction):
    """One int64 key a row, supplier * 2^20 + day (both fit), and one
    searchsorted over the right side's keys sorted."""
    def run(frames):
        t = frames["lineitem_sorted"]._table
        lk_t = t["l_commitdate"].data
        l_order = torch.argsort(lk_t, stable=True)
        l_key = t["l_suppkey"].data.long()[l_order] * (1 << 20) + lk_t[l_order] // DAY_NS
        r_key = t["l_suppkey"].data.long() * (1 << 20) + t["l_shipdate"].data // DAY_NS
        r_order = torch.argsort(r_key, stable=True)
        rk = r_key[r_order]
        nr = rk.numel()
        back = torch.searchsorted(rk, l_key, right=True) - 1
        fwd = torch.searchsorted(rk, l_key)
        supp = l_key >> 20
        ok_b = (back >= 0) & ((rk[torch.clamp(back, min=0)] >> 20) == supp)
        ok_f = (fwd < nr) & ((rk[torch.clamp(fwd, max=nr - 1)] >> 20) == supp)
        if direction == "backward":
            pos, ok = back, ok_b
        elif direction == "forward":
            pos, ok = fwd, ok_f
        else:
            db = l_key - rk[torch.clamp(back, min=0)]
            df = rk[torch.clamp(fwd, max=nr - 1)] - l_key
            use_b = ok_b & (~ok_f | (db <= df))
            pos = torch.where(use_b, back, fwd)
            ok = (ok_b | ok_f) & (torch.where(use_b, db, df) <= ASOF_TOLERANCE_DAYS)
        price = t["l_extendedprice"].data[r_order[torch.clamp(pos, 0, nr - 1)]]
        out = {"l_extendedprice": torch.where(ok, price, 0.0)}
        if not bool(ok.all()):
            out["l_extendedprice_valid"] = ok
        return out
    return run


def plain_days_year(frames) -> dict:
    """Each ship date's year through the days of Python's calendar for the
    distinct days."""
    days = _ship_days(frames) // DAY_NS
    uniq, inv = torch.unique(days, return_inverse=True)
    years = torch.tensor([(np.datetime64(int(d), "D").astype(object)).year
                          for d in uniq.tolist()], dtype=torch.int32, device=days.device)
    return {"values": years[inv]}


def plain_days_back(frames) -> dict:
    return {"values": _ship_days(frames) // DAY_NS * DAY_NS}


def _strftime_plain(fmt: str):
    """Python's strftime of each distinct day (the dates are midnights),
    gathered back: every text the same width."""
    def run(frames):
        days = _ship_days(frames) // DAY_NS
        uniq, inv = torch.unique(days, return_inverse=True)
        texts = [np.datetime64(int(d), "D").astype(object).strftime(fmt)
                 for d in uniq.tolist()]
        width = len(texts[0])
        table = torch.tensor([list(s.encode()) for s in texts], dtype=torch.uint8,
                             device=days.device)
        n = days.numel()
        return {"chars": table[inv].reshape(-1),
                "offsets": torch.arange(0, (n + 1) * width, width, device=days.device)}
    return run


def plain_engine_rolling(frames) -> dict:
    x = frames["lineitem_sorted"]._table["l_extendedprice"].data
    sums = x.unfold(0, ENGINE_PERIOD, 1).sum(1)
    out = torch.cat([x.new_full((ENGINE_PERIOD - 1,), math.nan), sums])
    return {"rev": out}


PLAIN = {
    "hash_murmur3_id4_id6": plain_murmur, "hash_xxhash64_id3": plain_xxhash,
    "hash_md5": plain_md5, "hash_partition_id6_64": plain_hash_partition,
    "round_robin_8": plain_round_robin, "pack_unpack": plain_pack,
    "contiguous_split_8": plain_split, "tdigest_id1": plain_tdigest,
    "rolling_sum": plain_rolling("sum"), "rolling_mean": plain_rolling("mean"),
    "rolling_std": plain_rolling("std"), "rolling_min": plain_rolling("min"),
    "rolling_max": plain_rolling("max"), "rolling_count": plain_rolling("count"),
    "rolling_center_sum": plain_center_sum, "grouped_rolling_mean_id4": plain_grouped_mean,
    "ewm_mean": plain_ewm, "rolling_apply_64": plain_apply, "query_id4_v3": plain_query,
    "eval_v1_v2": plain_eval, "count_tokens": plain_count_tokens, "tokenize": plain_tokenize,
    "normalize_spaces": plain_normalize, "character_ngrams_3": plain_char_ngrams,
    "ngrams_tokenize_2": plain_ngrams_tokenize, "minhash_4": plain_minhash,
    "jaccard_id3_reversed": plain_jaccard, "edit_distance": plain_edit_distance,
    "porter_measure": plain_porter, "wordpiece": plain_wordpiece,
    "byte_pair_encoding": plain_bpe, "bloom_j1_big": plain_bloom,
    "resample_D_sum": _resample_plain(DAY_NS, "sum"),
    "resample_D_mean": _resample_plain(DAY_NS, "mean"),
    "resample_h_sum_1e6": _resample_plain(DAY_NS // 24, "sum", rows=1_000_000),
    "rolling_7D_sum": plain_rolling_7d_sum, "rolling_7D_max": plain_rolling_7d_max,
    "asof_backward": _asof_plain("backward"), "asof_forward": _asof_plain("forward"),
    "asof_nearest_7d": _asof_plain("nearest"), "days_year": plain_days_year,
    "days_back_ns": plain_days_back, "strftime_weeks": _strftime_plain("%U %W %u %w %G-%V"),
    "strftime_c": _strftime_plain("%c"), "engine_rolling": plain_engine_rolling,
}
RTOL = {name: 0.0 for name in REQUESTS}
RTOL.update({name: 1e-9 for name in ("rolling_sum", "rolling_mean", "rolling_std",
                                     "rolling_center_sum", "grouped_rolling_mean_id4",
                                     "ewm_mean", "rolling_7D_sum", "engine_rolling")})
RTOL.update({name: 1e-12 for name in ("tdigest_id1", "resample_D_sum", "resample_D_mean",
                                      "resample_h_sum_1e6")})
NEEDS = {name: [] for name in REQUESTS}
NEEDS.update({name: ["onehot_groupby_aggregate"] for name in
              ("resample_D_sum", "resample_D_mean", "resample_h_sum_1e6")})
ROUTE = {name: "device" for name in REQUESTS}
ROUTE.update({name: "host" for name in HOST_ROWS})
ROUTE["rolling_apply_64"] = "vmap"
GROUPS = {
    "g1": [n for n in REQUESTS if n not in ("bloom_j1_big",) and not n.startswith(
        ("resample", "rolling_7D", "asof", "days", "strftime", "engine"))],
    "j1": ["bloom_j1_big"],
    "lineitem": [n for n in REQUESTS if n.startswith(
        ("resample", "rolling_7D", "asof", "days", "strftime", "engine"))],
}
