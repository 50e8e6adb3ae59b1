"""``collect(mesh=<a parallel.Mesh>)`` (``engine/spmd.py``) over 2 and 4
gloo ranks on the CPU, each rank a process of one module-wide
``RankPool``, against the reference's ``evaluate_spmd`` on its 8-device
CPU mesh (``tests/conftest.py``) over the plans of
``tests/test_spmd_engine.py``, on the same seeded numpy data.

Every rank gets the whole answer, and every rank's must be the same.
Where the order is the plan's (a sort) rows are compared in order, else
after a sort on all columns.  Integers, counts and strings exact; floats
rtol 1e-12 (standard deviations 1e-9, as the reference's own tests hold
them).  Where the reference is wrong the port is held to pandas: its
float join keys are never decoded (ROADMAP.md §3; the join's key column
comes back encoded), and a CASE with a null branch, whose mask its
zero-row probe does not see, fails to trace (TracerBoolConversionError).  Every plan runs with no
fallback but the median's, which is unlowerable and counted once.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import cudf_tpu as rct
from cudf_tpu import engine as ref_engine
from cudf_tpu.engine.spmd import evaluate_spmd as ref_evaluate_spmd
from cudf_tpu.frame.dataframe import DataFrame as RefDataFrame
from cudf_tpu.frame.index import default_index as ref_default_index
from cudf_tpu.parallel.mesh import make_mesh as ref_make_mesh
from cudf_tpu_torch.parallel.dryrun import RankPool

import torch_rank_tasks as tasks

torch.set_num_threads(1)
RANKS = [2, 4]


def _frames():
    rng = np.random.default_rng(21)
    n = 4000
    f = {"q1": pd.DataFrame({"flag": rng.integers(0, 3, n),
                             "qty": rng.integers(1, 50, n).astype(np.int64),
                             "price": rng.uniform(1, 100, n).round(2)})}
    n_fact, n_dim = 4000, 256
    f["fact"] = pd.DataFrame({"suppkey": rng.integers(0, n_dim, n_fact),
                              "price": rng.integers(1, 1000, n_fact).astype(np.float64),
                              "qty": rng.integers(1, 50, n_fact)})
    f["dim"] = pd.DataFrame({"suppkey": np.arange(n_dim), "nation": rng.integers(0, 5, n_dim)})
    f["kv"] = pd.DataFrame({"k": rng.integers(0, 40, 3000), "v": rng.normal(size=3000)})
    names = np.array(["ar", "br", "cn", "de", "us"])
    f["countries"] = pd.DataFrame({"country": names[rng.integers(0, 5, 2000)],
                                   "v": rng.integers(0, 100, 2000).astype(np.int64)})
    f["semi"] = pd.DataFrame({"k": rng.integers(0, 500, 3000), "v": rng.integers(0, 9, 3000)})
    f["keep"] = pd.DataFrame({"k": np.arange(0, 500, 7)})
    f["cust"] = pd.DataFrame({"custkey": np.arange(300), "seg": rng.integers(0, 5, 300)})
    f["orders"] = pd.DataFrame({"o_custkey": rng.integers(0, 200, 1200),
                                "o_orderkey": np.arange(1200)})
    f["left"] = pd.DataFrame({"k": np.arange(50), "lv": np.arange(50) * 10})
    f["right"] = pd.DataFrame({"k": np.arange(0, 50, 2), "rv": np.arange(25).astype(np.float64)})
    f["fl"] = pd.DataFrame({"k": np.arange(0, 60, 2), "lv": np.arange(30)})
    f["fr"] = pd.DataFrame({"k": np.arange(0, 90, 3), "rv": np.arange(30) * 2})
    f["sortme"] = pd.DataFrame({"a": rng.integers(0, 8, 5000), "b": rng.normal(size=5000).round(2),
                                "c": rng.integers(0, 10**12, 5000), "v": np.arange(5000)})
    v = rng.normal(size=3000)
    f["nulls"] = pd.DataFrame({"k": rng.integers(0, 20, 3000),
                               "v": np.where(rng.random(3000) < 0.8, v, np.nan)})
    f["win"] = pd.DataFrame({"k": rng.integers(0, 50, 4000), "v": rng.normal(size=4000).round(3),
                             "w": rng.integers(0, 100, 4000)})
    f["fkl"] = pd.DataFrame({"x": rng.integers(0, 60, 800) * 0.5 - 7.25, "a": np.arange(800)})
    f["fkr"] = pd.DataFrame({"x": np.arange(-7.25, 22.75, 0.5), "b": np.arange(60) * 3})
    return f


FRAMES = _frames()
# the plans each ranks' answer is held to the reference's SPMD answer on
REFERENCE_PLANS = ["q1", "q5", "minmax", "strings", "semi_distinct", "q13", "left_nulls",
                   "full", "multisort", "nullable", "over"]
# held to pandas alone: the reference fails the first two; the last
# two are the reference's own tests' second shapes, left out of its
# compiles to keep this file under a minute
PANDAS_PLANS = ["float_key", "masked_probe", "q13_seg", "over_filter"]
ORDERED = {"q5", "multisort"}
SD = {"minmax"}


def pandas_answer(name):
    f = FRAMES
    if name == "float_key":
        return f["fkl"].merge(f["fkr"], on="x")
    if name == "q13_seg":
        joined = f["cust"].merge(f["orders"], left_on="custkey", right_on="o_custkey",
                                 how="left").drop(columns="o_custkey")
        return joined.groupby("seg")["o_orderkey"].agg(m="mean", s="sum").reset_index()
    if name == "over_filter":
        win = f["win"].assign(t=f["win"].groupby("k")["v"].transform("sum"))
        return win[win["v"] > win["t"] * 0.1]
    kv = f["kv"].assign(w=f["kv"]["v"].where(f["kv"]["v"] > 0))
    return kv.groupby("k").agg(s=("w", "sum"), n=("w", "count")).reset_index()


def norm(df, ordered=False):
    out = pd.DataFrame({c: (df[c].astype("float64") if pd.api.types.is_numeric_dtype(df[c])
                            or pd.api.types.is_bool_dtype(df[c])
                            else df[c].astype(object).where(df[c].notna(), None).astype(str))
                        for c in df.columns})
    if not ordered:
        out = out.sort_values(list(out.columns), kind="stable")
    return out.reset_index(drop=True)


def same(got, exp, name, ordered=False):
    rtol = 1e-9 if name in SD else 1e-12
    pd.testing.assert_frame_equal(norm(got, ordered), norm(exp, ordered), rtol=rtol,
                                  check_dtype=False)


@pytest.fixture(scope="module")
def pools():
    started = {n: RankPool(n) for n in RANKS}      # both start while the reference compiles
    yield started
    for p in started.values():
        p.close()


@pytest.fixture(scope="module")
def reference():
    """The reference's SPMD answer to each plan, once a module (its
    programs compile for seconds each)."""
    mesh = ref_make_mesh(8)
    frames = {n: rct.DataFrame.from_pandas(f) for n, f in FRAMES.items()}
    out = {}
    for name in REFERENCE_PLANS:
        t = ref_evaluate_spmd(tasks.PLANS[name](ref_engine, frames).optimized(), mesh)
        out[name] = RefDataFrame._from(t, ref_default_index(t.num_rows)).to_pandas()
    return out


def run(pools, ranks, name, **kw):
    answers = pools[ranks].run(tasks.run_plan, name, FRAMES, kw.get("options", ()),
                               kw.get("spmd", True))
    first, _ = answers[0]
    for got, fallbacks in answers:
        assert fallbacks == 0
        pd.testing.assert_frame_equal(got, first)       # every rank the whole answer
    return first


@pytest.mark.parametrize("ranks", RANKS)
@pytest.mark.parametrize("name", REFERENCE_PLANS)
def test_a_plan_equals_the_references_spmd_answer(pools, reference, ranks, name):
    got = run(pools, ranks, name)
    same(got, reference[name], name, ordered=name in ORDERED)


@pytest.mark.parametrize("ranks", RANKS)
@pytest.mark.parametrize("name", PANDAS_PLANS)
def test_a_plan_equals_pandas(pools, ranks, name):
    same(run(pools, ranks, name), pandas_answer(name), name)


@pytest.mark.parametrize("ranks", RANKS)
def test_shuffle_joins_and_the_lowering_switched_off(pools, reference, ranks):
    """q5 with its join shuffled (no broadcast), shuffled after a bloom
    filter of the dim's keys (the filter's bits or-ed over the ranks by an
    ``all_reduce``), and with ``executor.spmd_lowering`` off (every rank
    runs the one-process executor over the mesh's size in partitions): the
    same answer."""
    shuffled = run(pools, ranks, "q5", options=("executor.broadcast_limit", 0))
    same(shuffled, reference["q5"], "q5", ordered=True)
    bloomed = run(pools, ranks, "q5", options=("executor.broadcast_limit", 1024))
    same(bloomed, reference["q5"], "q5", ordered=True)
    off = run(pools, ranks, "q5", spmd=False)
    same(off, reference["q5"], "q5", ordered=True)


@pytest.mark.parametrize("ranks", RANKS)
def test_an_unlowerable_plan_falls_back_once(pools, ranks):
    """A median does not decompose: ``evaluate_spmd`` raises Unlowerable on
    every rank, ``collect`` counts one fallback and answers as pandas, and
    under ``executor.fallback_mode`` "raise" it raises Unlowerable."""
    exp = FRAMES["kv"].groupby("k")["v"].median().reset_index(name="med")
    for raised, got, stats, raised_again in pools[ranks].run(tasks.run_unlowerable, "median",
                                                            FRAMES):
        assert raised is not None and "median" in raised
        assert stats["count"] == 1 and any("median" in r for r in stats["reasons"])
        assert raised_again
        same(got, exp, "median")


@pytest.mark.parametrize("ranks", RANKS)
def test_a_scan_of_several_files_gives_file_i_to_rank_i_mod_world(pools, ranks, tmp_path):
    """Five Parquet files over 2 and 4 ranks: rank r reads files r, r +
    world, ...; the groupby over them equals pandas' over the files."""
    frames = [pd.DataFrame({"k": np.arange(i, i + 40) % 7, "v": np.arange(40.0) * (i + 1)})
              for i in range(5)]
    paths = []
    for i, f in enumerate(frames):
        paths.append(str(tmp_path / f"part-{i}.parquet"))
        f.to_parquet(paths[-1], index=False)
    exp = pd.concat(frames).groupby("k")["v"].sum().reset_index(name="s")
    answers = pools[ranks].run(tasks.scan_files, paths)
    for rank, (got, files) in enumerate(answers):
        assert files == len(paths[rank::ranks])
        same(got, exp, "files")
