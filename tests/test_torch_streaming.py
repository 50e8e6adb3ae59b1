"""The partitioned executor (``engine/streaming.py``: ``collect(mesh=n)``,
``collect(mesh="auto")``, ``collect(streaming=True)``), the engine's
``MapFunction`` and ``PythonScan`` and ``testing.assert_eq`` against the
reference's (the JAX CPU backend), the port's in-memory executor and
pandas, on the same seeded numpy data.

The shuffle join, the ``Over`` repartition and the Distinct change row
order, as the reference's do: those results are compared after a sort on
all columns (``tests/test_engine.py``'s practice).  Tolerances: integers,
counts and strings exact, floats rtol 1e-9.  Where the reference is wrong
(its streaming var/std merge cancels, ROADMAP.md §3) the port is held to
the in-memory executor and numpy's two-pass variance, and the reference's
answer is shown to differ.
"""

import warnings

import numpy as np
import pandas as pd
import pytest
import torch

import cudf_tpu as rct
from cudf_tpu import engine as ref_engine
from cudf_tpu.engine import ir as ref_ir
from cudf_tpu.engine import streaming as ref_streaming
from cudf_tpu.utils import testing as ref_testing
import cudf_tpu_torch as ct
from cudf_tpu_torch import engine as pe
from cudf_tpu_torch import testing
from cudf_tpu_torch.engine import ir as IRs
from cudf_tpu_torch.engine import streaming
from cudf_tpu_torch.utils.config import option_context

torch.set_num_threads(1)

N = 3000


@pytest.fixture(scope="module")
def data():
    """(pandas, port, reference) frames: a float over 40 values with NaN,
    a float with NaN, an int32 key, a STRING with nulls."""
    rng = np.random.default_rng(11)
    k = rng.integers(0, 40, N).astype(float)
    k[rng.random(N) < 0.05] = np.nan
    v = rng.normal(10, 3, N)
    v[rng.random(N) < 0.05] = np.nan
    s = rng.choice(["ab", "b", "", "zzz"], N).astype(object)
    s[rng.random(N) < 0.05] = None
    pdf = pd.DataFrame({"k": k, "v": v, "w": rng.integers(-50, 50, N).astype(np.int32),
                        "s": s})
    return pdf, ct.DataFrame.from_pandas(pdf, device="cpu"), rct.DataFrame.from_pandas(pdf)


def rows(df):
    """A pandas frame sorted on all its columns, index dropped."""
    return df.sort_values(list(df.columns), kind="stable").reset_index(drop=True)


def same(got, exp, sort=True):
    got, exp = (rows(got), rows(exp)) if sort else (got, exp)
    pd.testing.assert_frame_equal(got, exp, check_dtype=False, rtol=1e-9, atol=0)


def groupby_plan(e, src, extra=True):
    c = e.col
    aggs = [c("v").sum().alias("s"), c("v").mean().alias("m"), c("v").count().alias("n"),
            c("v").var().alias("var"), c("v").std().alias("std")]
    if extra:
        aggs += [c("k").min().alias("kmin"), c("k").max().alias("kmax"),
                 c("s").count().alias("sc")]
    return e.from_dataframe(src).group_by("w").agg(*aggs)


@pytest.fixture(scope="module")
def ref_groupby(data):
    """The reference's answer (its in-memory executor: its partitioned one
    compiles for every partition's shape)."""
    return groupby_plan(ref_engine, data[2], extra=False).collect().to_pandas()


@pytest.mark.parametrize("mesh", [1, 3, 8])
def test_groupby_with_var_and_std_matches_memory_and_the_reference(data, ref_groupby, mesh):
    pdf, port, ref = data
    got = groupby_plan(pe, port).collect(mesh=mesh).to_pandas()
    same(got, groupby_plan(pe, port).collect().to_pandas())
    same(got[ref_groupby.columns], ref_groupby)


def test_the_streaming_var_merge_is_exact_where_the_references_cancels():
    """4000 rows of 1e9 + U(0, 1) in 5 groups: the in-memory executor and
    numpy's two-pass variance give ~0.082; the reference's
    ``collect(mesh=4)`` merges (sum, sum of squares, count) partials and
    gives hundreds, of either sign (``cudf_tpu/engine/streaming.py:366-378,
    :414-430``).  The port merges (count, mean, M2, residual) partials."""
    rng = np.random.default_rng(0)
    pdf = pd.DataFrame({"g": rng.integers(0, 5, 4000), "x": 1e9 + rng.random(4000)})
    exact = pdf.groupby("g")["x"].apply(lambda x: np.var(x.to_numpy(), ddof=1)).to_numpy()

    def plan(e, src):
        return e.from_dataframe(src).group_by("g").agg(
            e.col("x").var().alias("var"), e.col("x").std().alias("std")).sort("g")

    port = ct.DataFrame.from_pandas(pdf, device="cpu")
    mem = plan(pe, port).collect().to_pandas()
    got = plan(pe, port).collect(mesh=4).to_pandas()
    np.testing.assert_allclose(got["var"], mem["var"], rtol=1e-9)
    np.testing.assert_allclose(got["std"], mem["std"], rtol=1e-9)
    np.testing.assert_allclose(got["var"], exact, rtol=1e-9)
    ref = plan(ref_engine, rct.DataFrame.from_pandas(pdf)).collect(mesh=4).to_pandas()
    assert not np.allclose(ref["var"].to_numpy(), exact, rtol=1e-3)


@pytest.mark.parametrize("how", ["inner", "left", "semi", "anti"])
@pytest.mark.parametrize("path", ["broadcast", "bloom_shuffle", "shuffle"])
def test_both_join_paths_match_memory(data, how, path):
    """Broadcast (the right side under the limit), the bloom-filtered
    shuffle (over it, under 8x it; inner and semi) and the plain shuffle."""
    pdf, port, ref = data
    dim = ct.DataFrame({"w": torch.arange(-50, 60, 3, dtype=torch.int32),
                        "z": torch.arange(-50, 60, 3, dtype=torch.float64) / 7})
    lf = pe.from_dataframe(port).join(pe.from_dataframe(dim), on="w", how=how)
    limit = {"broadcast": 1 << 20, "bloom_shuffle": dim._table.nbytes // 2,
             "shuffle": 0}[path]
    with option_context("executor.broadcast_limit", limit):
        got = lf.collect(mesh=5).to_pandas()
    same(got, lf.collect().to_pandas())


def test_a_shuffle_join_on_string_keys_meets_equal_values(data):
    """Each partition's STRING keys go over one dictionary before the hash:
    equal strings meet whatever partition they come from."""
    pdf, port, _ = data
    dim = ct.DataFrame({"s": ct.Series(["b", "zzz", "", "nope"], device="cpu"),
                        "z": torch.tensor([1.0, 2.0, 3.0, 4.0])})
    lf = pe.from_dataframe(port).join(pe.from_dataframe(dim), on="s")
    with option_context("executor.broadcast_limit", 0):
        same(lf.collect(mesh=4).to_pandas(), lf.collect().to_pandas())
    grouped = pe.from_dataframe(port).group_by("s").agg(pe.col("w").sum().alias("t"))
    same(grouped.collect(mesh=6).to_pandas(), grouped.collect().to_pandas())


def test_the_non_decomposable_fallback_matches_the_reference_and_counts(data):
    pdf, port, ref = data

    def plan(e, src):
        return e.from_dataframe(src).group_by("w").agg(
            e.col("v").median().alias("med")).sort("w")

    pe.reset_fallback_stats()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = plan(pe, port).collect(mesh=4).to_pandas()
    assert any(issubclass(w.category, streaming.PerformanceWarning) for w in caught)
    assert pe.get_fallback_stats() == {
        "count": 1, "reasons": {"GroupBy: median is not decomposable": 1}}
    same(got, plan(ref_engine, ref).collect(mesh=4).to_pandas(), sort=False)
    same(got, plan(pe, port).collect().to_pandas(), sort=False)
    with option_context("executor.fallback_mode", "raise"):
        with pytest.raises(streaming.NotDecomposable, match="median"):
            plan(pe, port).collect(mesh=4)
    with option_context("executor.fallback_mode", "silent"):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            plan(pe, port).collect(mesh=4)
    assert pe.get_fallback_stats()["count"] == 3
    pe.reset_fallback_stats()
    assert pe.get_fallback_stats() == {"count": 0, "reasons": {}}


def test_the_range_partitioned_sort_is_the_stable_global_order():
    """The reference's ``test_streaming_sort_range_partitioned``: heavy ties,
    a descending second key, and exact stable order."""
    rng = np.random.default_rng(42)
    n = 5000
    pdf = pd.DataFrame({"k": rng.integers(0, 50, n), "v": rng.normal(size=n),
                        "tag": np.arange(n)})
    pdf.loc[rng.random(n) < 0.05, "v"] = np.nan
    lf = pe.from_dataframe(ct.DataFrame.from_pandas(pdf, device="cpu")).sort(
        ["k", "v"], descending=[False, True])
    got = lf.collect(streaming=True, mesh=6).to_pandas()
    exp = pdf.sort_values(["k", "v"], ascending=[True, False], kind="stable",
                          na_position="last").reset_index(drop=True)
    same(got, exp, sort=False)
    same(got, lf.collect().to_pandas(), sort=False)
    ref = ref_engine.from_dataframe(rct.DataFrame.from_pandas(pdf)).sort(
        ["k", "v"], descending=[False, True]).collect().to_pandas()
    same(got, ref, sort=False)


@pytest.mark.parametrize("by,descending,nulls_last", [
    (["s", "w"], [False, True], False),      # STRING keys with nulls first
    (["k"], [True], True),                   # heavy ties, NaN
    (["v", "w"], [False, False], True),      # nearly unique keys
])
def test_sampled_range_partitions_are_the_in_memory_order(data, by, descending, nulls_last):
    """Splitters from a sample of each partition's keys: every key run in
    one range partition, and the concatenation is the in-memory sort."""
    pdf, port, _ = data
    lf = pe.from_dataframe(port).sort(by, descending=descending, nulls_last=nulls_last)
    exp = lf.collect().to_pandas()
    for mesh in (3, 8):
        same(lf.collect(mesh=mesh).to_pandas(), exp, sort=False)
    parts = streaming._eval(lf._node, 8)
    assert sum(p.num_rows for p in parts) == N
    seen = set()
    for p in parts:
        runs = set(zip(*(map(str, p[b].to_pylist()) for b in by)))
        assert not runs & seen
        seen |= runs
    if by[0] == "v":
        assert max(p.num_rows for p in parts) < 2 * N / 8


def test_setting_spmd_lowering_raises_naming_item_10(data):
    """The option chooses how a plan over a ``parallel.Mesh`` runs: on,
    rank by rank with collectives (``engine/spmd.py``); off, the
    partition-list executor over the mesh's size in partitions.  Over a
    Mesh of one rank (gloo) both give the in-memory answer; a value that is
    not a bool raises."""
    from cudf_tpu_torch.parallel import bootstrap, make_mesh
    from cudf_tpu_torch.utils.config import get_option, set_option

    pdf, port, _ = data
    formed = not torch.distributed.is_initialized()
    mesh = make_mesh(device="cpu")          # one rank over gloo
    try:
        lf = pe.from_dataframe(port).group_by("w").agg(pe.col("v").sum().alias("s"),
                                                       pe.col("k").max().alias("m"))
        exp = lf.collect().to_pandas()
        for value in (False, True):
            with option_context("executor.spmd_lowering", value):
                same(lf.collect(mesh=mesh).to_pandas(), exp)
            with pytest.raises(ValueError):
                set_option("executor.spmd_lowering", int(value))
            assert get_option("executor.spmd_lowering") is True
    finally:
        if formed:
            bootstrap.shutdown()


def test_over_and_distinct_match_memory(data):
    pdf, port, _ = data
    c = pe.col
    over = pe.from_dataframe(port).with_columns(
        c("v").sum().over("w").alias("vs"), c("k").max().over(["w", "s"]).alias("km"))
    same(over.collect(mesh=4).to_pandas(), over.collect().to_pandas())
    apart = pe.from_dataframe(port).with_columns(       # no shared key: one partition
        c("v").sum().over("w").alias("vs"), c("w").count().over("s").alias("n"))
    same(apart.collect(mesh=4).to_pandas(), apart.collect().to_pandas())
    flt = pe.from_dataframe(port).filter(c("v") > c("v").mean().over("w"))
    same(flt.collect(mesh=3).to_pandas(), flt.collect().to_pandas())
    for keep in ("first", "last", "none"):
        uniq = pe.from_dataframe(port).select("w", "s").unique(keep=keep)
        same(uniq.collect(mesh=5).to_pandas(), uniq.collect().to_pandas())
        sub = pe.from_dataframe(port).unique(subset=["w"], keep=keep)
        same(sub.collect(mesh=5).to_pandas(), sub.collect().to_pandas())


def test_union_matches_memory_and_the_reference(data):
    pdf, port, ref = data

    def plan(e, src):
        lf = e.from_dataframe(src)
        return lf.filter(e.col("w") > 0).concat(lf.filter(e.col("w") < -10), lf.head(7))

    got = plan(pe, port).collect(mesh=4).to_pandas()
    same(got, plan(pe, port).collect().to_pandas())
    same(got, plan(ref_engine, ref).collect().to_pandas())


def test_a_multi_file_scan_gives_a_partition_a_file(data, tmp_path):
    pdf, port, _ = data
    paths = []
    for i in range(3):
        path = str(tmp_path / f"part-{i}.parquet")
        port.iloc[i * 1000:(i + 1) * 1000].to_parquet(path)
        paths.append(path)
    lf = pe.scan_parquet(paths, device="cpu").filter(pe.col("w") > 5).group_by("s").agg(
        pe.col("v").sum().alias("t"), pe.col("v").std().alias("sd"))
    got = lf.collect(streaming=True).to_pandas()
    assert streaming.LAST_RUN == {"partitions": 1, "file_partitions": 3}
    same(got, lf.collect().to_pandas())
    sel = pdf[pdf.w > 5]
    exp = sel.groupby("s").agg(t=("v", "sum"), sd=("v", "std")).reset_index()
    same(got, exp)


def test_choose_partitions_and_the_source_estimate_match_the_reference(data, tmp_path):
    pdf, port, ref = data
    dense = pdf[["w", "v"]]
    port_lf = pe.from_dataframe(ct.DataFrame.from_pandas(dense, device="cpu"))
    ref_lf = ref_engine.from_dataframe(rct.DataFrame.from_pandas(dense))
    assert streaming.estimate_source_bytes(port_lf._node) == \
        ref_streaming.estimate_source_bytes(ref_lf._node)
    path = str(tmp_path / "t.parquet")
    port.to_parquet(path)
    scans = (pe.scan_parquet([path, path], device="cpu")._node,
             ref_ir.Scan("parquet", [path, path], None, None))
    assert streaming.estimate_source_bytes(scans[0]) == \
        ref_streaming.estimate_source_bytes(scans[1])
    from cudf_tpu.utils.config import option_context as ref_option_context

    for size in (1 << 28, 4096, 64):
        with option_context("executor.target_partition_size", size), \
                ref_option_context("executor.target_partition_size", size):
            assert streaming.choose_partitions(port_lf._node) == \
                ref_streaming.choose_partitions(ref_lf._node)
            port_lf.group_by("w").agg(pe.col("v").sum()).collect(mesh="auto")
            assert streaming.LAST_RUN["partitions"] == \
                ref_streaming.choose_partitions(ref_lf._node)


def test_map_function_and_python_scan_match_the_reference():
    pdf = pd.DataFrame({"x": np.arange(12), "y": np.arange(12.0) / 3})

    def double(t, e):
        return t.insert("z", t["y"])

    port_src = IRs.PythonScan(lambda: ct.DataFrame.from_pandas(pdf, device="cpu"))
    ref_src = ref_ir.PythonScan(lambda: rct.DataFrame.from_pandas(pdf))
    assert port_src.schema() == ref_src.schema() == ["x", "y"]
    port_lf = pe.LazyFrame(port_src).filter(pe.col("x") > 3).map_batches(
        lambda t: double(t, pe), name="dup")
    ref_lf = ref_engine.LazyFrame(ref_src).filter(ref_engine.col("x") > 3).map_batches(
        lambda t: double(t, ref_engine), name="dup")
    assert "MapFunction(dup)" in port_lf.explain(optimized=False)
    exp = ref_lf.collect().to_pandas()
    for mesh in (None, 3):
        got = port_lf.collect(mesh=mesh).to_pandas()
        same(got, exp, sort=False)
    got = pe.LazyFrame(port_src).select((pe.col("x") * 2).alias("d")).collect(mesh=4)
    assert got["d"].tolist() == list(range(0, 24, 2))


@pytest.mark.parametrize("mesh", [(2, 2), 2.0, "8", object()])
def test_a_device_mesh_raises_naming_item_10(data, mesh):
    """A ``mesh`` that is neither a partition count, "auto" nor a
    ``parallel.Mesh`` (a tuple, a float, a str, an object) raises
    TypeError."""
    _, port, _ = data
    with pytest.raises(TypeError, match="parallel.Mesh"):
        pe.from_dataframe(port).collect(mesh=mesh)


def test_a_one_query_tpch_plan_matches_memory():
    """TPC-H q12 (a filter, a join, a CASE groupby) over the port's
    generator, streamed and shuffled, against the in-memory executor."""
    from cudf_tpu_torch.models import tpch

    tables = tpch.generate_device(0.002, seed=5, device="cpu")
    mem = tpch.q12(tables).to_pandas()
    with option_context("executor.broadcast_limit", 0):
        same(tpch.q12(tables, mesh=4).to_pandas(), mem, sort=False)
    same(tpch.q12(tables, streaming=True).to_pandas(), mem, sort=False)


def test_assert_eq_matches_the_reference_and_raises_on_a_difference():
    got, pdf = testing.make_random_frame(200, seed=3, device="cpu")
    ref, ref_pdf = ref_testing.make_random_frame(200, seed=3)
    pd.testing.assert_frame_equal(pdf, ref_pdf)
    testing.assert_eq(got, pdf)
    testing.assert_eq(got, ref.to_pandas())
    testing.assert_eq(got["f64"], pdf["f64"])
    testing.assert_eq(got.iloc[::-1], pdf.iloc[::-1].reset_index(drop=True), check_index=False)
    testing.assert_eq(got, pdf.sample(frac=1.0, random_state=1), sort_rows=True)
    testing.assert_eq(1.0, 1.0 + 1e-13)
    testing.assert_eq(float("nan"), float("nan"))
    testing.assert_eq(3, 3)
    with pytest.raises(AssertionError):
        testing.assert_eq(got["i64"] + 1, pdf["i64"])
    with pytest.raises(AssertionError):
        testing.assert_eq(1.0, 1.1)

