"""``DataFrame.merge`` (``cudf_tpu_torch/frame/join.py``) against pandas,
and the engine's ``Join`` (every ``how``), ``ConditionalJoin`` and
``MergeSorted`` against the reference's engine (``cudf_tpu.engine`` on
the JAX CPU backend), on the same seeded frames.

- merge: inner, left, right, cross, semi and anti on one int key, two
  keys and a string key, with and without null keys and values (pandas
  pairs null keys, and so does the port), ``sort=True``, both indexes as
  the key, and keys from the common columns; an outer join's rows as a
  set against pandas (which sorts them by key) and in order against the
  reference; a key that names an index level on one side.
- the engine: null keys never match; ``how="cross"`` through the IR on
  the reference's side (its ``LazyFrame.join`` takes no keys as None).

Every comparison is exact.  The file must stay under 60 s alone.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import cudf_tpu
from cudf_tpu.engine import from_dataframe as ref_from_dataframe
from cudf_tpu.engine import ir as ref_ir
from cudf_tpu.frame.index import default_index as ref_default_index
import cudf_tpu_torch as ct
from cudf_tpu_torch.engine import from_dataframe
from cudf_tpu_torch.engine import ir as IRs
from cudf_tpu_torch.frame.index import default_index

torch.set_num_threads(1)

CPU = torch.device("cpu")
NL, NR = 40, 30


def _frames(seed, nulls=False):
    rng = np.random.default_rng(seed)
    left = pd.DataFrame({"k": rng.integers(0, 8, NL), "j": rng.integers(0, 2, NL),
                         "s": rng.choice(["p", "q", "rr"], NL), "v": rng.normal(size=NL)})
    right = pd.DataFrame({"k": rng.integers(2, 11, NR), "j": rng.integers(0, 2, NR),
                          "s": rng.choice(["p", "rr", "t"], NR), "w": rng.normal(size=NR)})
    if nulls:
        left["v"] = left["v"].where(rng.random(NL) > 0.2)
        left["k"] = left["k"].astype(float).where(rng.random(NL) > 0.2)
        right["k"] = right["k"].astype(float).where(rng.random(NR) > 0.2)
    return left, right


def _pandas(df):
    out = df.to_pandas()
    for c in out.columns:
        if out[c].dtype == object or isinstance(out[c].dtype, pd.StringDtype):
            out[c] = out[c].astype(object)
    return out


def _norm(df):
    out = df.copy()
    for c in out.columns:
        if out[c].dtype.kind in "iu":
            out[c] = out[c].astype(float)
        elif out[c].dtype.kind not in "fb":
            out[c] = out[c].astype(object).where(out[c].notna(), None)
    return out


def _check(got, exp, ordered=True):
    got, exp = _norm(_pandas(got)), _norm(exp)
    assert list(got.columns) == list(exp.columns)
    if not ordered:
        got = got.sort_values(list(got.columns), na_position="last").reset_index(drop=True)
        exp = exp.sort_values(list(exp.columns), na_position="last").reset_index(drop=True)
    pd.testing.assert_frame_equal(got.reset_index(drop=True), exp.reset_index(drop=True),
                                  check_exact=True, check_dtype=False)


@pytest.mark.parametrize("nulls", [False, True])
@pytest.mark.parametrize("how", ["inner", "left", "right", "cross"])
@pytest.mark.parametrize("on", ["k", ["k", "j"], "s"])
def test_merge_matches_pandas(on, how, nulls):
    left, right = _frames(9, nulls)
    l, r = ct.DataFrame.from_pandas(left, device=CPU), ct.DataFrame.from_pandas(right, device=CPU)
    if how == "cross":
        _check(l.merge(r, how="cross"), left.merge(right, how="cross"))
        return
    _check(l.merge(r, on=on, how=how), left.merge(right, on=on, how=how))
    _check(l.merge(r, on=on, how=how, sort=True), left.merge(right, on=on, how=how, sort=True))


@pytest.mark.parametrize("on,nulls", [("k", True), (["k", "j"], False)])
def test_outer_merge_rows_follow_pandas_and_order_the_reference(on, nulls):
    left, right = _frames(10, nulls)
    l, r = ct.DataFrame.from_pandas(left, device=CPU), ct.DataFrame.from_pandas(right, device=CPU)
    got = l.merge(r, on=on, how="outer")
    _check(got, left.merge(right, on=on, how="outer"), ordered=False)
    ref = cudf_tpu.DataFrame.from_pandas(left).merge(cudf_tpu.DataFrame.from_pandas(right),
                                                     on=on, how="outer")
    _check(got, ref.to_pandas())


@pytest.mark.parametrize("how", ["semi", "anti", "leftsemi", "leftanti"])
def test_semi_and_anti_merges_match_pandas(how):
    left, right = _frames(11, nulls=True)
    l, r = ct.DataFrame.from_pandas(left, device=CPU), ct.DataFrame.from_pandas(right, device=CPU)
    got = l.merge(r, on=["k", "j"], how=how)
    hit = left[["k", "j"]].apply(tuple, axis=1).isin(set(right[["k", "j"]].apply(tuple, axis=1)))
    hit |= left["k"].isna() & (left["j"].isin(right["j"][right["k"].isna()]))
    exp = left[hit if "semi" in how else ~hit]
    _check(got, exp)
    assert got.index.to_pandas().tolist() == exp.index.tolist()


def test_merge_on_common_columns_index_and_levels():
    left, right = _frames(12)
    l, r = ct.DataFrame.from_pandas(left, device=CPU), ct.DataFrame.from_pandas(right, device=CPU)
    common_l, common_r = left.drop(columns=["s"]), right.drop(columns=["s"])
    _check(ct.DataFrame.from_pandas(common_l, device=CPU).merge(
        ct.DataFrame.from_pandas(common_r, device=CPU)), common_l.merge(common_r))
    for how in ("inner", "left", "outer"):
        li, ri = left.set_index("k"), right.set_index("k")
        got = ct.DataFrame.from_pandas(li, device=CPU).merge(
            ct.DataFrame.from_pandas(ri, device=CPU), left_index=True, right_index=True,
            how=how, sort=how == "outer")
        exp = li.merge(ri, left_index=True, right_index=True, how=how, sort=how == "outer")
        _check(got, exp)
        assert got.index.to_pandas().tolist() == exp.index.tolist()
    lvl = left.set_index("k")                        # "k" an index level on the left
    _check(ct.DataFrame.from_pandas(lvl, device=CPU).merge(r, on="k"), lvl.merge(right, on="k"))


@pytest.mark.parametrize("how", ["inner", "left", "outer", "cross", "semi", "anti"])
def test_engine_join_matches_reference_engine(how):
    left, right = _frames(13, nulls=True)
    right = right.rename(columns={"j": "jr"})
    rl = ref_from_dataframe(cudf_tpu.DataFrame.from_pandas(left))
    rr = ref_from_dataframe(cudf_tpu.DataFrame.from_pandas(right))
    plan = from_dataframe(ct.DataFrame.from_pandas(left, device=CPU)).join(
        from_dataframe(ct.DataFrame.from_pandas(right, device=CPU)), how=how,
        **({} if how == "cross" else {"on": "k"}))
    if how == "cross":
        exp = ref_ir.Join(rl._node, rr._node, [], [], "cross").evaluate()
        exp = cudf_tpu.DataFrame._from(exp, ref_default_index(exp.num_rows)).to_pandas()
    else:
        exp = rl.join(rr, on="k", how=how).collect().to_pandas()
    for opt in (False, True):
        _check(plan.collect(no_optimization=opt), exp)
    if how not in ("left", "semi"):
        return
    two = from_dataframe(ct.DataFrame.from_pandas(left, device=CPU)).join(
        from_dataframe(ct.DataFrame.from_pandas(right, device=CPU)),
        left_on=["k", "j"], right_on=["k", "jr"], how=how)
    ref_two = rl.join(rr, left_on=["k", "j"], right_on=["k", "jr"], how=how)
    _check(two.collect(), ref_two.collect().to_pandas())


def test_conditional_join_and_merge_sorted_match_reference_engine():
    left, right = _frames(14)
    rl, rr = cudf_tpu.DataFrame.from_pandas(left), cudf_tpu.DataFrame.from_pandas(right)
    pl, pr = ct.DataFrame.from_pandas(left, device=CPU), ct.DataFrame.from_pandas(right, device=CPU)

    def pred(lt, rt):
        from cudf_tpu_torch.ops.binaryop import binary_operation
        return binary_operation(lt["v"], rt["w"], "lt")

    def ref_pred(lt, rt):
        from cudf_tpu.ops.binaryop import binary_operation
        return binary_operation(lt["v"], rt["w"], "lt")

    got = IRs.ConditionalJoin(IRs.DataFrameScan(pl._table), IRs.DataFrameScan(pr._table),
                              pred).evaluate()
    exp = ref_ir.ConditionalJoin(ref_ir.DataFrameScan(rl._table),
                                 ref_ir.DataFrameScan(rr._table), ref_pred).evaluate()
    _check(ct.DataFrame._from(got, default_index(got.num_rows)),
           cudf_tpu.DataFrame._from(exp, ref_default_index(exp.num_rows)
                                    ).to_pandas())
    parts = [left.sort_values("k", kind="stable").iloc[i::3] for i in range(3)]
    parts = [p.sort_values("k", kind="stable") for p in parts]
    got = IRs.MergeSorted("k", *[IRs.DataFrameScan(ct.DataFrame.from_pandas(
        p, device=CPU)._table) for p in parts]).evaluate()
    exp = ref_ir.MergeSorted("k", *[ref_ir.DataFrameScan(cudf_tpu.DataFrame.from_pandas(
        p)._table) for p in parts]).evaluate()
    _check(ct.DataFrame._from(got, default_index(got.num_rows)),
           cudf_tpu.DataFrame._from(exp, ref_default_index(exp.num_rows)
                                    ).to_pandas())
