"""Two faults of the partitioned executor that the port had copied from
the reference (``cudf_tpu/engine/streaming.py``), each held on the port
to its in-memory ``collect()`` and to pandas, at ``collect(mesh=4)``, and
shown still wrong on the reference (the JAX CPU backend):

1. a whole-column aggregate inside a pointwise node was computed once a
   partition: ``select(col("a").sum())`` over a = 0..9 gave one partial
   sum a partition, [3, 12, 21, 9], where the answer is [45].  A Select of
   aggregates alone now takes partials and a merge; a Filter or
   ``with_columns`` that compares rows with a whole-column aggregate runs
   on one partition (a counted fallback);
2. a shuffle join hashed each side's keys in their own types, so an int32
   key and a float64 key of equal values went to different partitions:
   200 matching rows came back as 68.  Each key pair is now cast to the
   type the join compares it in before hashing.

Integers and counts exact, floats rtol 1e-12.
"""

import warnings

import numpy as np
import pandas as pd
import pytest
import torch

import torch_jax_cache  # noqa: F401  (the run's shared JAX compile cache)
import cudf_tpu as rct
from cudf_tpu import engine as ref_engine
from cudf_tpu.utils.config import option_context as ref_option_context
import cudf_tpu_torch as ct
from cudf_tpu_torch import engine as pe
from cudf_tpu_torch.utils.config import option_context

torch.set_num_threads(1)

A = pd.DataFrame({"a": np.arange(10), "b": np.arange(10) % 3})
LEFT = pd.DataFrame({"k": (np.arange(200) % 50).astype(np.int32), "lv": np.arange(200)})
RIGHT = pd.DataFrame({"k": np.arange(50).astype(np.float64), "rv": np.arange(50)})


def plan(e, frame, case):
    c = e.col
    lf = e.from_dataframe(frame(A))
    if case == "sum":
        return lf.select(c("a").sum())
    if case == "max_min":
        return lf.select(c("a").max(), c("b").min())
    if case == "filter_mean":
        return lf.filter(c("a") > c("a").mean())
    if case == "centered":
        return lf.with_columns((c("a") - c("a").mean()).alias("d"))
    return e.from_dataframe(frame(LEFT)).join(e.from_dataframe(frame(RIGHT)), on="k")


def expected(case):
    if case == "sum":
        return pd.DataFrame({"a": [A["a"].sum()]})
    if case == "max_min":
        return pd.DataFrame({"a": [A["a"].max()], "b": [A["b"].min()]})
    if case == "filter_mean":
        return A[A["a"] > A["a"].mean()]
    if case == "centered":
        return A.assign(d=A["a"] - A["a"].mean())
    return LEFT.merge(RIGHT, on="k")


def rows(df):
    df = df.astype({c: "float64" for c in df.columns})
    return df.sort_values(list(df.columns)).reset_index(drop=True)


def collect(lf, mesh):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")         # a counted fallback warns
        return lf.collect(mesh=mesh).to_pandas()


CASES = ["sum", "max_min", "filter_mean", "centered", "int32_float64_join"]


@pytest.mark.parametrize("case", CASES)
def test_the_port_answers_where_the_reference_does_not(case):
    port = plan(pe, lambda p: ct.DataFrame.from_pandas(p, device="cpu"), case)
    exp = rows(expected(case))
    with option_context("executor.broadcast_limit", 0):
        got = rows(collect(port, 4))
    pd.testing.assert_frame_equal(got, exp, rtol=1e-12)
    pd.testing.assert_frame_equal(rows(port.collect().to_pandas()), exp, rtol=1e-12)
    with ref_option_context("executor.broadcast_limit", 0):
        wrong = rows(collect(plan(ref_engine, rct.DataFrame.from_pandas, case), 4))
    assert not (wrong.shape == exp.shape and np.allclose(wrong.to_numpy(), exp.to_numpy(),
                                                         equal_nan=True))


def test_the_issue_figures():
    """The two answers as the re-anchor wrote them down."""
    port = plan(pe, lambda p: ct.DataFrame.from_pandas(p, device="cpu"), "sum")
    assert collect(port, 4)["a"].tolist() == [45]
    ref = plan(ref_engine, rct.DataFrame.from_pandas, "sum")
    assert collect(ref, 4)["a"].tolist() == [3, 12, 21, 9]
    join = plan(pe, lambda p: ct.DataFrame.from_pandas(p, device="cpu"), "join")
    with option_context("executor.broadcast_limit", 0):
        assert len(collect(join, 4)) == 200


def test_a_select_of_aggregates_takes_no_fallback_and_a_filter_takes_one():
    """The Select (and a Reduce, ``agg``) merge partials with no fallback;
    the Filter comparing rows with the mean runs on one partition, counted."""
    frame = ct.DataFrame.from_pandas(A, device="cpu")
    c = pe.col
    pe.reset_fallback_stats()
    with option_context("executor.fallback_mode", "raise"):
        for lf in (pe.from_dataframe(frame).select(c("a").sum(), c("a").std().alias("sd"),
                                                   c("b").mean().alias("m")),
                   pe.from_dataframe(frame).agg(c("a").var().alias("v"), c("b").count())):
            got = lf.collect(mesh=4).to_pandas()
            pd.testing.assert_frame_equal(got, lf.collect().to_pandas(), rtol=1e-12)
    assert pe.get_fallback_stats()["count"] == 0
    with option_context("executor.fallback_mode", "silent"):
        pe.from_dataframe(frame).filter(c("a") > c("a").mean()).collect(mesh=4)
    stats = pe.get_fallback_stats()
    assert stats["count"] == 1 and any("whole-column" in r for r in stats["reasons"])
