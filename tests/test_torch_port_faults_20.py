"""Three faults of the reference's partitioned executor
(``cudf_tpu/engine/streaming.py``) that the port does not copy, each
shown on the reference (the JAX CPU backend, ``collect(mesh=3)`` or
``collect(mesh=2)``) and held
on the port to pandas and to its in-memory executor (exact):

1. a key is hashed with its mask as an extra operand, so a shuffle join
   of a masked key against an unmasked one loses matches;
2. ``.over()`` windows are repartitioned by the union of their keys,
   which splits the windows of the shorter key list;
3. Distinct's keep="none" runs locally first, which keeps a value with
   three copies over two partitions.

(The var/std merge and the spill manager's live bytes are
``tests/test_torch_streaming.py``'s and ``tests/test_torch_spill.py``'s.)
"""

import numpy as np
import pandas as pd
import pytest
import torch

import cudf_tpu as rct
from cudf_tpu import engine as ref_engine
from cudf_tpu.utils.config import option_context as ref_option_context
import cudf_tpu_torch as ct
from cudf_tpu_torch import engine as pe
from cudf_tpu_torch.utils.config import option_context

torch.set_num_threads(1)

LEFT = pd.DataFrame({"k": pd.array([1, 2, None, 3, 1, 2] * 20, dtype="Int64"),
                     "v": np.arange(120.0)})
RIGHT = pd.DataFrame({"k": np.array([1, 2, 3]), "w": [10.0, 20.0, 30.0]})
WIN = pd.DataFrame({"w": np.arange(40) % 4, "s": np.arange(40) % 3, "v": np.arange(40.0)})
DUP = pd.DataFrame({"a": [1, 1, 2, 3, 3, 3, 1]})


def plan(e, frame, case):
    if case == "masked_join_key":
        return e.from_dataframe(frame(LEFT)).join(e.from_dataframe(frame(RIGHT)), on="k")
    if case == "over_key_lists":
        return e.from_dataframe(frame(WIN)).with_columns(
            e.col("v").sum().over("w").alias("vs"), e.col("v").max().over(["w", "s"]).alias("m"))
    return e.from_dataframe(frame(DUP)).unique(keep="none")


def expected(case):
    if case == "masked_join_key":
        return LEFT.dropna().astype({"k": "int64"}).merge(RIGHT, on="k")
    if case == "over_key_lists":
        return WIN.assign(vs=WIN.groupby("w")["v"].transform("sum"),
                          m=WIN.groupby(["w", "s"])["v"].transform("max"))
    return DUP.drop_duplicates(keep=False)


def rows(df):
    df = df.astype({c: "float64" for c in df.columns})
    return df.sort_values(list(df.columns)).reset_index(drop=True)


@pytest.mark.parametrize("case", ["masked_join_key", "over_key_lists", "keep_none"])
def test_the_port_answers_where_the_reference_does_not(case):
    mesh = 3 if case == "masked_join_key" else 2    # the partitions where each shows
    port = plan(pe, lambda p: ct.DataFrame.from_pandas(p, device="cpu"), case)
    exp = rows(expected(case))
    with option_context("executor.broadcast_limit", 0):
        got = rows(port.collect(mesh=mesh).to_pandas())
    pd.testing.assert_frame_equal(got, exp)
    pd.testing.assert_frame_equal(rows(port.collect().to_pandas()), exp)
    with ref_option_context("executor.broadcast_limit", 0):
        wrong = rows(plan(ref_engine, rct.DataFrame.from_pandas, case).collect(mesh=mesh)
                     .to_pandas())
    assert not (wrong.shape == exp.shape and np.allclose(wrong.to_numpy(), exp.to_numpy(),
                                                         equal_nan=True))
