"""The multi-rank paths on the card (``engine/spmd.py``, ``parallel/*``),
each answer held to the in-memory executor's over the same data.

``REQUESTS[name](frames, mesh)`` is what a user calls on every rank of
``mesh`` (a ``parallel.Mesh``); each returns the whole answer on every
rank as a DataFrame:

- G1 (``groupby-datagen.R``: id4 and id5 in 1..100, id6 in 1..n/100, v1,
  v2, v3): ``distributed_groupby_agg`` of v1-v3 by id4 (K = 100) and by
  id6 (K = n/100), and the LazyFrame groupby of ``partitioned.g1_plan``
  (sum, mean, count, var, std of v1-v3) by each, through
  ``collect(mesh=mesh)``;
- J1 big (``partitioned.j1_frames``): the inner join through
  ``collect(mesh=mesh)``, shuffled (``executor.broadcast_limit`` 0) and
  broadcast (the limit at the dim's bytes; the default, 32 MiB, would
  shuffle a dim of 1e8 rows);
- TPC-H q1, q3, q5 and q6 over the in-memory tables, ``mesh=mesh``;
- ``dist_sort`` of G1's rows by (id4, id5) with v1 riding, and
  ``dist_distinct`` of (id4, id5, v1).

``IN_MEMORY[name](frames)`` is the same question through the in-memory
executor (or the frame API), ``ORDERED`` the requests whose row order is
the answer's (the sort), and ``agree`` holds a result to it as
``models/partitioned.py`` does (sorted rows, dictionaries decoded;
integers, counts and strings exact, floats rtol 1e-9).  ``NEEDS[name]``
are the kernels of A-H a request must launch: A for the groupbys at
K = 100 (the partials and the merge on the one-hot tier), B, F, G and D at
K = n/100, B, F, G, D and H for the joins (each rank's join on the radix
tier, TPC-H q3 and q5 too); q1 and q6 and the sort and distinct, none.
"""

from __future__ import annotations

from cudf_tpu_torch.models import partitioned as pm

ONEHOT = pm.ONEHOT
RADIX = pm.RADIX
JOIN = pm.JOIN
TPCH_QUERIES = ("q1", "q3", "q5", "q6")
VALUES = ("v1", "v2", "v3")


def g1_frame(n: int = pm.G1_ROWS, seed: int = 7, device="cuda"):
    """``partitioned.g1_frame`` with id5 (1..100) beside id4."""
    import torch

    df = pm.g1_frame(n, seed, device)
    gen = torch.Generator(device=device).manual_seed(seed + 5)
    df["id5"] = torch.randint(1, 101, (n,), generator=gen, device=device, dtype=torch.int32)
    return df


# ----------------------------------------------------------------------
# requests
# ----------------------------------------------------------------------

def _frame_agg(key):
    def run(frames, mesh):
        from cudf_tpu_torch.parallel import distributed_groupby_agg

        df = frames["g1"][[key, *VALUES]]
        return distributed_groupby_agg(df, key, list(VALUES), mesh,
                                       aggs=("sum", "count", "mean"))
    return run


def _frame_agg_memory(key):
    def run(frames):
        from cudf_tpu_torch.engine import col, from_dataframe

        aggs = []
        for v in VALUES:
            aggs += [col(v).sum().alias(f"{v}_sum"), col(v).mean().alias(f"{v}_mean")]
        aggs.append(col(VALUES[0]).count().alias("count"))
        return from_dataframe(frames["g1"]).group_by(key).agg(*aggs).sort(key).collect()
    return run


def _lazy_g1(key):
    def run(frames, mesh):
        return pm.g1_plan(frames["g1"], key).collect(mesh=mesh)
    return run


def _j1(how):
    def run(frames, mesh):
        from cudf_tpu_torch.utils.config import option_context

        limit = pm.broadcast_limit(frames, "broadcast") if how == "broadcast" else 0
        with option_context("executor.broadcast_limit", limit):
            return pm.j1_plan(frames["fact"], frames["dim"]).collect(mesh=mesh)
    return run


def _tpch(q):
    def run(frames, mesh):
        from cudf_tpu_torch.models import tpch

        return tpch.QUERIES[q](frames["tpch"], mesh=mesh)
    return run


def _tpch_memory(q):
    def run(frames):
        from cudf_tpu_torch.models import tpch

        return tpch.QUERIES[q](frames["tpch"])
    return run


def _whole(mesh, names, cols):
    """This rank's share of an op's columns gathered to every rank."""
    from cudf_tpu_torch.core.column import Column
    from cudf_tpu_torch.core.table import Table
    from cudf_tpu_torch.frame.dataframe import DataFrame
    from cudf_tpu_torch.frame.index import default_index
    from cudf_tpu_torch.parallel.mesh import gather_table

    whole = gather_table(mesh, Table.from_pairs(names, [Column.from_tensor(c) for c in cols]))
    return DataFrame._from(whole, default_index(whole.num_rows))


def _sort(frames, mesh):
    from cudf_tpu_torch.parallel import dist_sort
    from cudf_tpu_torch.parallel.mesh import row_range

    t = frames["g1"]._table
    lo, hi = row_range(t.num_rows, mesh.rank, mesh.size)
    keys, pays, _, _ = dist_sort(mesh, [t["id4"].data[lo:hi], t["id5"].data[lo:hi]],
                                 [t["v1"].data[lo:hi]])
    return _whole(mesh, ["id4", "id5", "v1"], [*keys, pays[0]])


def _sort_memory(frames):
    from cudf_tpu_torch.engine import from_dataframe

    return from_dataframe(frames["g1"][["id4", "id5", "v1"]]).sort(["id4", "id5"]).collect()


def _distinct(frames, mesh):
    from cudf_tpu_torch.parallel import dist_distinct
    from cudf_tpu_torch.parallel.mesh import row_range

    t = frames["g1"]._table
    lo, hi = row_range(t.num_rows, mesh.rank, mesh.size)
    keys, _, _ = dist_distinct(mesh, [t[n].data[lo:hi] for n in ("id4", "id5", "v1")])
    return _whole(mesh, ["id4", "id5", "v1"], keys)


def _distinct_memory(frames):
    from cudf_tpu_torch.engine import from_dataframe

    return from_dataframe(frames["g1"][["id4", "id5", "v1"]]).unique().collect()


REQUESTS = {
    "g1_k100_agg": _frame_agg("id4"),
    "g1_k1e6_agg": _frame_agg("id6"),
    "g1_k100": _lazy_g1("id4"),
    "g1_k1e6": _lazy_g1("id6"),
    "j1_big_shuffle": _j1("shuffle"),
    "j1_big_broadcast": _j1("broadcast"),
    **{f"tpch_{q}": _tpch(q) for q in TPCH_QUERIES},
    "g1_sort": _sort,
    "g1_distinct": _distinct,
}
IN_MEMORY = {
    "g1_k100_agg": _frame_agg_memory("id4"),
    "g1_k1e6_agg": _frame_agg_memory("id6"),
    "g1_k100": lambda frames: pm.g1_plan(frames["g1"], "id4").collect(),
    "g1_k1e6": lambda frames: pm.g1_plan(frames["g1"], "id6").collect(),
    "j1_big_shuffle": lambda frames: pm.j1_plan(frames["fact"], frames["dim"]).collect(),
    "j1_big_broadcast": lambda frames: pm.j1_plan(frames["fact"], frames["dim"]).collect(),
    **{f"tpch_{q}": _tpch_memory(q) for q in TPCH_QUERIES},
    "g1_sort": _sort_memory,
    "g1_distinct": _distinct_memory,
}
ORDERED = {"g1_sort", "g1_k100_agg", "g1_k1e6_agg"}
# the requests that are plans: REQUESTS[name](frames, 8) runs the same plan
# on the one-process partitioned executor, 8 partitions
ENGINE = {"g1_k100", "g1_k1e6", "j1_big_shuffle", "j1_big_broadcast",
          *(f"tpch_{q}" for q in TPCH_QUERIES)}
GROUPS = {
    "g1": ["g1_k100_agg", "g1_k1e6_agg", "g1_k100", "g1_k1e6", "g1_sort", "g1_distinct"],
    "j1": ["j1_big_shuffle", "j1_big_broadcast"],
    "tpch": [f"tpch_{q}" for q in TPCH_QUERIES],
}
NEEDS = {name: [] for name in REQUESTS}
NEEDS.update({"g1_k100_agg": ONEHOT, "g1_k100": ONEHOT, "g1_k1e6_agg": RADIX,
              "g1_k1e6": RADIX, "j1_big_shuffle": JOIN, "j1_big_broadcast": JOIN,
              "tpch_q3": JOIN, "tpch_q5": JOIN})


def agree(frames, name: str, res, exp=None) -> float:
    """``res`` of request ``name`` against its in-memory answer (run now
    when ``exp`` is not given): the same rows (in order for ``ORDERED``,
    else after a sort on all columns); the max abs float error."""
    exp = IN_MEMORY[name](frames) if exp is None else exp
    if isinstance(exp, float):
        pm._need(abs(res - exp) <= 1e-9 * abs(exp), f"{name}: {res} vs {exp}")
        return abs(res - exp)
    if name not in ORDERED:
        return pm.same_rows(res._table, exp._table, name)
    g, e = res._table, exp._table
    pm._need(list(g.names) == list(e.names), f"{name}: columns {list(g.names)} vs "
                                             f"{list(e.names)}")
    return max([pm.same_column(g[n].decode_dictionary(), e[n].decode_dictionary(),
                               f"{name} {n}") for n in e.names] or [0.0])


PLAIN = {name: (lambda frames, res, name=name: agree(frames, name, res)) for name in REQUESTS}
