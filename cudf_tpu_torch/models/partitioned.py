"""The partitioned executor's paths on the card (``engine/streaming.py``,
``utils/spill.py``), each answer held to the in-memory executor's over
the same data.

Data, made on the device from a seed:

- TPC-H (``models/tpch.py`` ``generate_device``) written as a Parquet
  dataset by the port's writer: lineitem and orders sorted by their date
  and cut into ``FILES`` files of consecutive rows each (a date-clustered
  warehouse table in files), the other tables one file each
  (``write_tpch_dataset``); ``tpch_dataset`` scans them (``scan_parquet``
  of the file list: one partition a file);
- G1 (db-benchmark's ``groupby-datagen.R`` columns id4 in 1..100, id6 in
  1..n/100, v1, v2, v3; ``g1_frame``);
- J1 big (``join-datagen.R``: a fact of n rows with ids uniform over
  1..1.1n and a dim of n rows whose ids are a permutation of 1..n;
  ``j1_frames``).

``REQUESTS[name](frames)`` is what a user calls: the nine TPC-H queries
with ``streaming=True`` over the dataset, with spilling off
(``tpch_<q>``) and on under ``SPILL_BUDGET`` (``tpch_<q>_spill``); the
G1 groupby with sum, mean, count, var and std of v1-v3 by id4 (K = 100)
and by id6 (K = n/100) with ``collect(mesh=8)``; the J1 inner join with
``collect(mesh=8)``, its right side broadcast (``executor.broadcast_limit``
at its bytes) and shuffled after a bloom filter (the limit at half its
bytes).  ``IN_MEMORY[name](frames)`` is the same plan's in-memory
``collect()`` over the resident tables, and ``PLAIN[name](frames,
result)`` holds the result to it: rows compared after a sort on all
columns (dictionaries decoded: the files give STRING columns where memory
holds dictionaries), integers, counts and strings exact, floats within
rtol 1e-9; it returns the max abs error.  ``NEEDS[name]`` are the kernels
of A-H a request must launch: A for the G1 groupby at K = 100 (its
partial aggregations), B, F, G and D at K = n/100, B, F, G, D and H for
the J1 joins and the inner joins of TPC-H q3, q5, q9, q10, q12 and q14
(each partition's join on the radix tier; q4's semi join takes the
sort-merge tier, and the groupbys over the files' STRING keys the sort
tier).
"""

from __future__ import annotations

import os
from contextlib import nullcontext

import torch

FILES = 16
PARTITIONS = 8
SPILL_BUDGET = 16 << 20
G1_ROWS = 100_000_000
J1_ROWS = 100_000_000
ONEHOT = ["onehot_groupby_aggregate"]
RADIX = ["digit_histogram", "tile_sort_data", "merge_scatter", "bucket_aggregate"]
JOIN = RADIX + ["window_probe"]
# the split tables and the date each one's files are clustered by
CLUSTER = {"lineitem": "l_shipdate", "orders": "o_orderdate"}
TPCH_QUERIES = ("q1", "q3", "q4", "q5", "q6", "q9", "q10", "q12", "q14")
# the queries with an inner join: each partition's join on the radix tier
TPCH_JOINS = ("q3", "q5", "q9", "q10", "q12", "q14")


# ----------------------------------------------------------------------
# data
# ----------------------------------------------------------------------

def write_tpch_dataset(tables, directory: str, files: int = FILES) -> dict:
    """The tables as Parquet files under ``directory``: lineitem and orders
    sorted by their date (``CLUSTER``: date-clustered warehouse files, whose
    row-group statistics let a scan skip what a date filter rules out) and
    cut into ``files`` files of consecutive rows each, the rest one file
    each.  Returns {table: [paths]}."""
    paths = {}
    for name, df in tables.items():
        n = len(df)
        k = files if name in CLUSTER else 1
        if name in CLUSTER:
            df = df.sort_values(CLUSTER[name]).reset_index(drop=True)
        per = -(-n // k)
        paths[name] = []
        for i in range(k):
            path = os.path.join(directory, f"{name}-{i:02d}.parquet")
            df.iloc[i * per:min((i + 1) * per, n)].to_parquet(path, index=False)
            paths[name].append(path)
    return paths


def tpch_dataset(paths: dict, device) -> dict:
    """{table: LazyFrame}: a scan of each table's files."""
    from cudf_tpu_torch.engine import scan_parquet

    return {name: scan_parquet(p, device=device) for name, p in paths.items()}


def g1_frame(n: int = G1_ROWS, seed: int = 7, device="cuda"):
    """G1's integer and float columns: id4, id6, v1, v2 (int32), v3."""
    from cudf_tpu_torch.frame.dataframe import DataFrame

    gen = torch.Generator(device=device).manual_seed(seed)

    def ints(lo, hi):
        return torch.randint(lo, hi + 1, (n,), generator=gen, device=device, dtype=torch.int32)

    return DataFrame({"id4": ints(1, 100), "id6": ints(1, max(n // 100, 1)), "v1": ints(1, 5),
                      "v2": ints(1, 15),
                      "v3": torch.rand(n, generator=gen, device=device,
                                       dtype=torch.float64) * 100})


def j1_frames(n: int = J1_ROWS, seed: int = 9, device="cuda"):
    """(fact, dim) of J1 big: fact ids uniform over 1..1.1n (about 9% find
    no match), dim ids a permutation of 1..n; v1, v2 standard normal."""
    from cudf_tpu_torch.frame.dataframe import DataFrame

    gen = torch.Generator(device=device).manual_seed(seed)
    fact = DataFrame({
        "id": torch.randint(1, -(-11 * n // 10) + 1, (n,), generator=gen, device=device,
                            dtype=torch.int32),
        "v1": torch.randn(n, generator=gen, device=device, dtype=torch.float64)})
    dim = DataFrame({
        "id": torch.randperm(n, generator=gen, device=device, dtype=torch.int32) + 1,
        "v2": torch.randn(n, generator=gen, device=device, dtype=torch.float64)})
    return fact, dim


# ----------------------------------------------------------------------
# requests
# ----------------------------------------------------------------------

def g1_plan(df, key: str):
    """sum, mean, count, var and std of v1, v2 and v3 by ``key``."""
    from cudf_tpu_torch.engine import col, from_dataframe

    aggs = []
    for v in ("v1", "v2", "v3"):
        c = col(v)
        aggs += [c.sum().alias(f"{v}_sum"), c.mean().alias(f"{v}_mean"),
                 c.count().alias(f"{v}_count"), c.var().alias(f"{v}_var"),
                 c.std().alias(f"{v}_std")]
    return from_dataframe(df).group_by(key).agg(*aggs)


def j1_plan(fact, dim):
    from cudf_tpu_torch.engine import from_dataframe

    return from_dataframe(fact).join(from_dataframe(dim), on="id")


def broadcast_limit(frames, how: str) -> int:
    """The broadcast limit of a J1 request: the right side's bytes (the
    broadcast), or half of them (a shuffle after a bloom filter, which
    the executor builds for a right side up to 8x the limit)."""
    right = frames["dim"]._table.nbytes
    return right if how == "broadcast" else right // 2


def _g1(key):
    def run(frames, mesh=PARTITIONS):
        return g1_plan(frames["g1"], key).collect(mesh=mesh)
    return run


def _j1(how):
    def run(frames, mesh=PARTITIONS):
        from cudf_tpu_torch.utils.config import option_context

        with option_context("executor.broadcast_limit", broadcast_limit(frames, how)):
            return j1_plan(frames["fact"], frames["dim"]).collect(mesh=mesh)
    return run


def _tpch(q, spill):
    def run(frames):
        from cudf_tpu_torch.models import tpch
        from cudf_tpu_torch.utils.config import option_context

        ctx = option_context("spill", True, "spill.device_limit_bytes", SPILL_BUDGET) \
            if spill else nullcontext()
        with ctx:
            return tpch.QUERIES[q](frames["dataset"], streaming=True)
    return run


def _tpch_memory(q):
    def run(frames):
        from cudf_tpu_torch.models import tpch

        return tpch.QUERIES[q](frames["tpch"])
    return run


REQUESTS = {
    **{f"tpch_{q}": _tpch(q, False) for q in TPCH_QUERIES},
    **{f"tpch_{q}_spill": _tpch(q, True) for q in TPCH_QUERIES},
    "g1_k100": _g1("id4"),
    "g1_k1e6": _g1("id6"),
    "j1_big_broadcast": _j1("broadcast"),
    "j1_big_shuffle": _j1("shuffle"),
}
IN_MEMORY = {
    **{f"tpch_{q}": _tpch_memory(q) for q in TPCH_QUERIES},
    **{f"tpch_{q}_spill": _tpch_memory(q) for q in TPCH_QUERIES},
    "g1_k100": lambda frames: g1_plan(frames["g1"], "id4").collect(),
    "g1_k1e6": lambda frames: g1_plan(frames["g1"], "id6").collect(),
    "j1_big_broadcast": lambda frames: j1_plan(frames["fact"], frames["dim"]).collect(),
    "j1_big_shuffle": lambda frames: j1_plan(frames["fact"], frames["dim"]).collect(),
}
GROUPS = {
    "tpch": [f"tpch_{q}" for q in TPCH_QUERIES],
    "tpch_spill": [f"tpch_{q}_spill" for q in TPCH_QUERIES],
    "g1": ["g1_k100", "g1_k1e6"],
    "j1": ["j1_big_broadcast", "j1_big_shuffle"],
}
# a query whose plan has a GroupBy or a Join: with spilling on, the
# budget must bite (SpillStatistics.spills > 0)
SPILLS = {f"tpch_{q}_spill" for q in TPCH_QUERIES if q != "q6"}


# ----------------------------------------------------------------------
# checks
# ----------------------------------------------------------------------

class Mismatch(AssertionError):
    pass


def _need(cond, what):
    if not cond:
        raise Mismatch(what)


def sorted_rows(t):
    """The table's rows sorted on all its columns (dictionaries decoded)."""
    from cudf_tpu_torch.core.table import Table
    from cudf_tpu_torch.ops import copying
    from cudf_tpu_torch.ops.row_ops import lex_sort_indices

    t = Table.from_pairs(t.names, [c.decode_dictionary() for c in t.columns])
    if t.num_rows == 0:
        return t
    return copying.gather_table(t, lex_sort_indices(list(t.columns)), bounds_check=False)


def same_column(got, exp, what: str) -> float:
    """Values, nulls and row count equal (floats within rtol 1e-9, NaN
    equal to NaN); a STRING by its bytes, integers by value whatever their
    width; returns the max abs float error."""
    _need(got.length == exp.length, f"{what}: {got.length} rows vs {exp.length}")
    gv = None if got.validity is None else got.validity
    ev = None if exp.validity is None else exp.validity
    valid = torch.ones(exp.length, dtype=torch.bool, device=exp.device) if ev is None else ev
    _need(torch.equal(valid, torch.ones_like(valid) if gv is None else gv),
          f"{what}: nulls differ")
    if exp.dtype.is_string:
        _need(got.dtype.is_string, f"{what}: {got.dtype!r} vs {exp.dtype!r}")
        go, eo = got.offsets - got.offsets[0], exp.offsets - exp.offsets[0]
        _need(torch.equal(go, eo), f"{what}: string lengths differ")
        gs, es = int(got.offsets[0]), int(exp.offsets[0])
        _need(torch.equal(got.data[gs:gs + int(go[-1])], exp.data[es:es + int(eo[-1])]),
              f"{what}: string bytes differ")
        return 0.0
    g, e = got.data, exp.data
    if e.is_floating_point():
        g, e = g.double()[valid], e.double()[valid]
        nan = torch.isnan(e)
        _need(torch.equal(nan, torch.isnan(g)), f"{what}: NaN rows differ")
        g, e = g[~nan], e[~nan]
        _need(torch.allclose(g, e, rtol=1e-9, atol=0.0), f"{what}: differs beyond rtol 1e-9")
        return float((g - e).abs().max()) if e.numel() else 0.0
    _need(not g.is_floating_point(), f"{what}: {got.dtype!r} vs {exp.dtype!r}")
    _need(torch.equal(g.long()[valid], e.long()[valid]), f"{what}: differs")
    return 0.0


def same_rows(got, exp, what: str) -> float:
    """Two tables with the same columns and, after a sort on all columns,
    the same rows; the max abs float error."""
    _need(list(got.names) == list(exp.names), f"{what}: columns {list(got.names)} vs "
                                              f"{list(exp.names)}")
    g, e = sorted_rows(got), sorted_rows(exp)
    return max([same_column(g[n], e[n], f"{what} {n}") for n in e.names] or [0.0])


def agree(frames, name: str, res, exp=None) -> float:
    """``res`` of request ``name`` against its in-memory result (run now
    when ``exp`` is not given)."""
    exp = IN_MEMORY[name](frames) if exp is None else exp
    if isinstance(exp, float):
        _need(abs(res - exp) <= 1e-9 * abs(exp), f"{name}: {res} vs {exp}")
        return abs(res - exp)
    return same_rows(res._table, exp._table, name)


PLAIN = {name: (lambda frames, res, name=name: agree(frames, name, res)) for name in REQUESTS}
NEEDS = {name: [] for name in REQUESTS}
NEEDS.update({"g1_k100": ONEHOT, "g1_k1e6": RADIX, "j1_big_broadcast": JOIN,
              "j1_big_shuffle": JOIN})
NEEDS.update({f"tpch_{q}{s}": JOIN for q in TPCH_JOINS for s in ("", "_spill")})
