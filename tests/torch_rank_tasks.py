"""What each gloo rank runs for ``tests/test_torch_parallel.py`` and
``tests/test_torch_spmd.py`` (``cudf_tpu_torch.parallel.dryrun.RankPool``
unpickles these functions by name in its spawned processes, which import
torch and the port, never jax).

Every task gets the whole input as numpy arrays (every rank the same, as
every rank of a mesh builds the same plan from the same data), takes its
rows where an op wants them, and returns host values: numpy arrays, lists
or pandas frames.
"""

import warnings

import numpy as np
import torch

from cudf_tpu_torch.parallel import dist, shuffle
from cudf_tpu_torch.parallel.mesh import make_mesh, row_range


def _mesh():
    return make_mesh(device="cpu")


def _mine(mesh, *arrays):
    lo, hi = row_range(len(arrays[0]), mesh.rank, mesh.size)
    return [torch.from_numpy(np.ascontiguousarray(a[lo:hi])) for a in arrays]


def _np(xs):
    return [x.numpy() if isinstance(x, torch.Tensor) else x.data.numpy() for x in xs]


# ----------------------------------------------------------------------
# parallel/*
# ----------------------------------------------------------------------

def groupby_sum(keys, vals):
    mesh = _mesh()
    mine = _mine(mesh, *keys, *vals)
    k, s, c, v, d = dist.dist_groupby_sum_multi(mesh, mine[:len(keys)], mine[len(keys):])
    return _np(k), _np(s), c.numpy(), bool(v.all()), int(d.sum())


def groupby_moments(key, val):
    mesh = _mesh()
    k, v = _mine(mesh, key, val)
    ks, aggs, cnt, _, _ = dist.dist_groupby_agg(
        mesh, [k], [(v, "min"), (v, "max"), (v, "mean"), (v, "var"), (v, "std")])
    return ks[0].numpy(), [a.data.numpy() for a in aggs], cnt.numpy()


def frame_groupby(pdf, key, values, aggs):
    import cudf_tpu_torch as ct

    mesh = _mesh()
    df = ct.DataFrame.from_pandas(pdf, device="cpu")
    return dist.distributed_groupby_agg(df, key, values, mesh, aggs=aggs).to_pandas()


def join(lk, lv, rk, rv, how):
    mesh = _mesh()
    lks, lvs = _mine(mesh, *lk, lv)[:-1], _mine(mesh, lv)[0]
    rks, rvs = _mine(mesh, *rk, rv)[:-1], _mine(mesh, rv)[0]
    out = dist.dist_join(mesh, lks, [lvs], None, rks, [rvs], None, how=how)
    return [_np(x) if isinstance(x, list) else x.numpy() for x in out]


def inner_join(lk, lv, rk, rv, broadcast):
    mesh = _mesh()
    a, b, c, d = _mine(mesh, lk, lv) + _mine(mesh, rk, rv)
    fn = dist.broadcast_inner_join if broadcast else dist.dist_inner_join
    k, ol, orr, ok = fn(mesh, a, [b], None, c, [d], None)
    return k.numpy(), ol[0].numpy(), orr[0].numpy(), bool(ok.all())


def sort(keys, v, descending):
    mesh = _mesh()
    mine = _mine(mesh, *keys, v)
    k, p, ok, d = dist.dist_sort(mesh, mine[:-1], [mine[-1]], None, descending=descending)
    return _np(k), p[0].numpy(), int(d.sum())


def distinct(keys):
    mesh = _mesh()
    k, ok, d = dist.dist_distinct(mesh, _mine(mesh, *keys))
    return _np(k)


def quantile(x, valid, pcts):
    mesh = _mesh()
    xs, vs = _mine(mesh, x, valid)
    return dist.dist_quantile(mesh, xs, vs, pcts, delta=200)


def shuffled_rows(key, v):
    """The rows this rank receives from a shuffle by ``key``, beside the
    rows the one-process executor's ``_shuffle`` puts in this partition
    (of the same rows cut into the same row ranges)."""
    from cudf_tpu_torch.core.column import Column
    from cudf_tpu_torch.core.table import Table
    from cudf_tpu_torch.engine import streaming
    from cudf_tpu_torch.ops.partitioning import partition_ids

    mesh = _mesh()
    k, vv = _mine(mesh, key, v)
    got_k, got_p, ok, dropped = shuffle.shuffle_by_key(mesh, k, [vv])
    parts = [Table({"k": Column.from_tensor(torch.from_numpy(key[lo:hi])),
                    "v": Column.from_tensor(torch.from_numpy(v[lo:hi]))})
             for lo, hi in (row_range(len(key), r, mesh.size) for r in range(mesh.size))]
    ids = [partition_ids([p["k"]], mesh.size) for p in parts]
    one = streaming._assemble(streaming._shuffle(parts, ids, mesh.size), parts[0])[mesh.rank]
    return (got_k.numpy(), got_p[0].numpy(), one["k"].data.numpy(), one["v"].data.numpy(),
            bool(ok.all()), int(dropped.sum()))


def multislice(keys, v):
    from cudf_tpu_torch.parallel.mesh import make_multislice_mesh

    mesh = make_multislice_mesh(2)
    mine = _mine(mesh, *keys, v)
    k, s, c, ok, d = dist.dist_groupby_sum_multislice(mesh, mine[:-1], [mine[-1]])
    return _np(k), s[0].numpy(), c.numpy()


def layouts_round_trip():
    """A table of every layout (nullable ints, floats, bools, STRING with
    nulls and multi-byte rows, a dictionary, LIST) on every rank, gathered
    (``gather_table``) and exchanged (row i to rank i % size): the rows as
    lists, beside what they must be."""
    from cudf_tpu_torch.core.column import Column
    from cudf_tpu_torch.core.table import Table
    from cudf_tpu_torch.ops.lists import make_list_column
    from cudf_tpu_torch.parallel.mesh import gather_table
    from cudf_tpu_torch.parallel.shuffle import exchange_by_ids

    mesh = _mesh()
    n = 6
    t = Table({
        "i": Column.from_tensor(torch.arange(n, dtype=torch.int32) + 10 * mesh.rank,
                                torch.tensor([True, False, True, True, False, True])),
        "f": Column.from_tensor(torch.linspace(0, 1, n, dtype=torch.float64)),
        "b": Column.from_tensor(torch.tensor([True, False] * 3)),
        "s": Column.from_strings(["a", None, "ccc", "", "dd", "é"], device="cpu"),
        "d": Column.from_dictionary(torch.tensor([2, 0, 1, 1, 0, 2], dtype=torch.int32),
                                    Column.from_strings(["x", "y", "z"], device="cpu")),
        "l": make_list_column(torch.tensor([0, 2, 2, 3, 6, 6, 7]),
                              Column.from_tensor(torch.arange(7.0)), None)})
    rows = {name: t[name].to_pylist() for name in t.names}
    whole = gather_table(mesh, t)
    mine = exchange_by_ids(mesh, t, (torch.arange(n) % mesh.size).to(torch.int32))
    return ({name: whole[name].to_pylist() for name in t.names},
            {name: mine[name].to_pylist() for name in t.names}, rows)


def frames_round_trip(pdf):
    """``partition_frame`` then ``collect_frame``: the whole frame back, its
    STRING column over one dictionary on every rank."""
    import cudf_tpu_torch as ct
    from cudf_tpu_torch.parallel import bootstrap, collect_frame, partition_frame

    mesh = _mesh()
    part = partition_frame(ct.DataFrame.from_pandas(pdf, device="cpu"), mesh)
    keys = part._table["s"].keys.host_strings()
    whole = collect_frame(part, mesh).to_pandas()
    return (whole, keys, len(part), bootstrap.process_info(),
            bootstrap.host_local_slice(len(pdf)))


# ----------------------------------------------------------------------
# engine/spmd.py: plans over every rank
# ----------------------------------------------------------------------

def collect_plan(build, frames, options=(), spmd=True):
    """``build(engine, frames)`` collected over the mesh: (the whole
    result as pandas, the fallback count)."""
    import cudf_tpu_torch as ct
    from cudf_tpu_torch import engine as pe
    from cudf_tpu_torch.utils.config import option_context

    mesh = _mesh()
    port = {n: ct.DataFrame.from_pandas(f, device="cpu") for n, f in frames.items()}
    pe.reset_fallback_stats()
    with option_context("executor.spmd_lowering", spmd, "executor.fallback_mode", "silent",
                        *options):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            out = build(pe, port).collect(mesh=mesh).to_pandas()
    return out, pe.get_fallback_stats()["count"]


def scan_files(paths):
    """A groupby over a Scan of several Parquet files: (the whole answer,
    the files this rank read)."""
    from cudf_tpu_torch import engine as pe
    from cudf_tpu_torch.engine import spmd

    mesh = _mesh()
    lf = pe.scan_parquet(paths, device="cpu").group_by("k").agg(pe.col("v").sum().alias("s"))
    out = lf.collect(mesh=mesh).to_pandas()
    return out, spmd.LAST_RUN["files"]


def unlowerable(build, frames):
    """``evaluate_spmd`` of an unlowerable plan raises on every rank; its
    ``collect`` counts one fallback and answers."""
    import cudf_tpu_torch as ct
    from cudf_tpu_torch import engine as pe
    from cudf_tpu_torch.engine.spmd import Unlowerable, evaluate_spmd
    from cudf_tpu_torch.utils.config import option_context

    mesh = _mesh()
    port = {n: ct.DataFrame.from_pandas(f, device="cpu") for n, f in frames.items()}
    lf = build(pe, port)
    try:
        evaluate_spmd(lf.optimized(), mesh)
        raised = None
    except Unlowerable as exc:
        raised = str(exc)
    pe.reset_fallback_stats()
    with option_context("executor.fallback_mode", "silent"):
        out = lf.collect(mesh=mesh).to_pandas()
    stats = pe.get_fallback_stats()
    with option_context("executor.fallback_mode", "raise"):
        try:
            lf.collect(mesh=mesh)
            raised_again = False
        except Unlowerable:
            raised_again = True
    return raised, out, stats, raised_again


# ----------------------------------------------------------------------
# the plans, over either engine (``e``: cudf_tpu_torch.engine or
# cudf_tpu.engine) and a dict of that package's frames
# ----------------------------------------------------------------------

def _lf(e, f, name):
    return e.from_dataframe(f[name])


def plan_q1(e, f):
    c = e.col
    return (_lf(e, f, "q1").with_columns((c("price") * c("qty")).alias("gross"))
            .group_by("flag").agg(c("qty").sum().alias("sum_qty"),
                                  c("gross").sum().alias("sum_gross"),
                                  c("price").mean().alias("avg_price"),
                                  c("qty").count().alias("n")))


def plan_q5(e, f):
    c = e.col
    return (_lf(e, f, "fact").filter(c("qty") < 25)
            .join(_lf(e, f, "dim"), on="suppkey", how="inner")
            .group_by("nation").agg(c("price").sum().alias("revenue"))
            .sort("revenue", descending=True))


def plan_minmax(e, f):
    c = e.col
    return _lf(e, f, "kv").group_by("k").agg(c("v").min().alias("lo"), c("v").max().alias("hi"),
                                             c("v").std().alias("sd"))


def plan_strings(e, f):
    return _lf(e, f, "countries").group_by("country").agg(e.col("v").sum().alias("total"))


def plan_semi_distinct(e, f):
    return _lf(e, f, "semi").join(_lf(e, f, "keep"), on="k", how="semi").unique()


def plan_q13(e, f):
    return (_lf(e, f, "cust").join(_lf(e, f, "orders"), left_on="custkey",
                                   right_on="o_custkey", how="left")
            .group_by("custkey").agg(e.col("o_orderkey").count().alias("c_count")))


def plan_q13_seg(e, f):
    c = e.col
    return (_lf(e, f, "cust").join(_lf(e, f, "orders"), left_on="custkey",
                                   right_on="o_custkey", how="left")
            .group_by("seg").agg(c("o_orderkey").mean().alias("m"),
                                 c("o_orderkey").sum().alias("s")))


def plan_left_nulls(e, f):
    return _lf(e, f, "left").join(_lf(e, f, "right"), on="k", how="left")


def plan_full(e, f):
    return _lf(e, f, "fl").join(_lf(e, f, "fr"), on="k", how="full")


def plan_multisort(e, f):
    return _lf(e, f, "sortme").sort(["a", "b", "c"], descending=[False, True, False])


def plan_nullable(e, f):
    c = e.col
    return _lf(e, f, "nulls").group_by("k").agg(c("v").sum().alias("s"),
                                                c("v").mean().alias("m"),
                                                c("v").count().alias("c"))


def plan_over(e, f):
    c = e.col
    return _lf(e, f, "win").with_columns(c("v").sum().over("k").alias("gsum"),
                                         c("v").mean().over("k").alias("gmean"),
                                         c("w").max().over("k").alias("gmax"),
                                         (c("v") * 2.0).alias("v2"))


def plan_over_filter(e, f):
    c = e.col
    return (_lf(e, f, "win").with_columns(c("v").sum().over("k").alias("t"))
            .filter(c("v") > c("t") * 0.1))


def plan_float_key(e, f):
    return _lf(e, f, "fkl").join(_lf(e, f, "fkr"), on="x", how="inner")


def plan_masked_probe(e, f):
    from importlib import import_module

    c = e.col
    x = import_module(e.__name__ + ".expr")
    w = x.when(c("v") > 0).then(c("v")).otherwise(x.lit(None)).alias("w")
    return (_lf(e, f, "kv").with_columns(w)
            .group_by("k").agg(c("w").sum().alias("s"), c("w").count().alias("n")))


def plan_median(e, f):
    return _lf(e, f, "kv").group_by("k").agg(e.col("v").median().alias("med"))


PLANS = {name[5:]: fn for name, fn in dict(globals()).items() if name.startswith("plan_")}


def run_plan(name, frames, options=(), spmd=True):
    return collect_plan(PLANS[name], frames, options, spmd)


def run_unlowerable(name, frames):
    return unlowerable(PLANS[name], frames)
