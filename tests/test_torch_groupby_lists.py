"""The groupby aggregations that return LIST columns (``ops/groupby.py``:
``group_collect_list``, ``group_unique``, ``group_collect_set``,
``group_topk``, ``group_histogram``; ``frame/groupby.py``: ``agg(list)``,
``agg(set)``, "collect", "unique", "collect_set", "histogram" and
``SeriesGroupBy.unique``) against the reference's (``cudf_tpu``, JAX on
the CPU) and pandas, with null values, null keys and NaN keys, under
``dropna`` both ways and ``sort=False``.  The reference's collect_set and
histogram order a group's values by its equality operands (a null value
first); the port orders them ascending with a null value last, so those
are held to the reference as sets and to the ascending order directly.
Exact everywhere.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from cudf_tpu.core.column import Column as RefColumn
from cudf_tpu.ops import groupby as ref_gb
import cudf_tpu_torch as ct
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.ops import groupby as gb

torch.set_num_threads(1)

CPU = "cpu"
N = 400


def _frame(seed, float_keys=False):
    """Keys in 0..11 (about 5% null, or NaN for float keys), int values in
    0..9 about 10% null, float values with NaN."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 12, N).astype(np.float64)
    k[rng.random(N) < 0.05] = np.nan
    v = rng.integers(0, 10, N).astype(np.float64)
    v[rng.random(N) < 0.1] = np.nan
    pdf = pd.DataFrame({
        "k": k if float_keys else pd.array(np.where(np.isnan(k), 0, k).astype(np.int64),
                                            dtype="Int64"),
        "v": pd.array(np.where(np.isnan(v), 0, v).astype(np.int64), dtype="Int64"),
        "f": rng.normal(0, 1, N).round(1)})
    if not float_keys:
        pdf.loc[np.isnan(k), "k"] = pd.NA
    pdf.loc[rng.random(N) < 0.1, "v"] = pd.NA
    pdf.loc[rng.random(N) < 0.1, "f"] = np.nan
    return pdf


def _norm(v):
    if isinstance(v, (list, tuple, np.ndarray)):
        return [_norm(x) for x in v]
    if isinstance(v, dict):
        return {a: _norm(b) for a, b in v.items()}
    return None if v is None or v is pd.NA or (isinstance(v, float) and v != v) else v


def _port(pdf):
    return ct.DataFrame.from_pandas(pdf, device=CPU)


def _ascending(values):
    return sorted(values, key=lambda x: (x is None, x))


@pytest.mark.parametrize("dropna", [True, False])
@pytest.mark.parametrize("sort", [True, False])
@pytest.mark.parametrize("col", ["v", "f"])
def test_collect_list_matches_pandas(dropna, sort, col):
    pdf = _frame(1)
    got = _port(pdf).groupby("k", dropna=dropna, sort=sort)[col].agg(list).to_pandas()
    exp = pdf.groupby("k", dropna=dropna, sort=sort)[col].agg(list)
    assert [_norm(k) for k in got.index] == [_norm(k) for k in exp.index]
    assert _norm(got.tolist()) == _norm(exp.tolist())


@pytest.mark.parametrize("name", ["collect", "list"])
def test_collect_list_matches_reference(name):
    pdf = _frame(2)
    keys = pdf["k"].to_numpy(dtype=np.float64, na_value=np.nan)
    vals = pdf["v"].to_numpy(dtype=np.float64, na_value=np.nan)
    kv, vv = ~np.isnan(keys), ~np.isnan(vals)
    rk = RefColumn.from_numpy(np.nan_to_num(keys).astype(np.int64), mask=kv)
    rv = RefColumn.from_numpy(np.nan_to_num(vals).astype(np.int64), mask=vv)
    pk = Column.from_numpy(np.nan_to_num(keys).astype(np.int64), device=CPU).with_validity(
        torch.from_numpy(kv))
    pv = Column.from_numpy(np.nan_to_num(vals).astype(np.int64), device=CPU).with_validity(
        torch.from_numpy(vv))
    rg, pg = ref_gb.make_grouper([rk]), gb.make_grouper([pk])
    exp = ref_gb._AGG_DISPATCH[name](rv, rg)
    assert gb.aggregate(pv, pg, name).to_pylist() == exp.to_pylist()
    for agg in ("collect_set", "histogram"):
        got, ref = gb.aggregate(pv, pg, agg).to_pylist(), \
            ref_gb._AGG_DISPATCH[agg](rv, rg).to_pylist()
        for g, r in zip(got, ref):
            key = (lambda d: (d["value"], d["count"])) if agg == "histogram" else (lambda x: x)
            assert sorted(map(key, g), key=str) == sorted(map(key, r), key=str)
            assert g == _ascending(g) if agg == "collect_set" else \
                [d["value"] for d in g] == _ascending([d["value"] for d in g])


@pytest.mark.parametrize("dropna", [True, False])
@pytest.mark.parametrize("col", ["v", "f"])
def test_unique_and_collect_set_match_pandas(dropna, col):
    pdf = _frame(3, float_keys=True)
    df = _port(pdf)
    got = df.groupby("k", dropna=dropna)[col].unique().to_pandas()
    exp = pdf.groupby("k", dropna=dropna)[col].unique()
    assert _norm(got.tolist()) == _norm(exp.tolist())
    as_set = df.groupby("k", dropna=dropna)[col].agg(set).to_pandas()
    assert _norm(as_set.tolist()) == [_ascending(_norm(list(v))) for v in exp.tolist()]
    named = df.groupby("k", dropna=dropna).agg({col: "collect_set"}).to_pandas()[col]
    assert _norm(named.tolist()) == _norm(as_set.tolist())


@pytest.mark.parametrize("k,largest", [(1, True), (2, True), (3, False)])
@pytest.mark.parametrize("col", ["v", "f"])
def test_topk_matches_pandas(k, largest, col):
    pdf = _frame(4)
    g = gb.make_grouper([_port(pdf)._table["k"]])
    got = gb.group_topk(_port(pdf)._table[col], g, k, largest).to_pylist()
    grouped = pdf.dropna(subset=["k"]).groupby("k")[col]
    exp = grouped.nlargest(k) if largest else grouped.nsmallest(k)
    exp = [list(exp.loc[key]) for key in sorted(pdf["k"].dropna().unique())]
    assert _norm(got) == _norm(exp)


def test_topk_matches_reference():
    rng = np.random.default_rng(5)
    keys, vals = rng.integers(0, 9, N), rng.integers(-50, 50, N)
    rg = ref_gb.make_grouper([RefColumn.from_numpy(keys)])
    pg = gb.make_grouper([Column.from_numpy(keys, device=CPU)])
    for k in (1, 2, 5):
        assert gb.group_topk(Column.from_numpy(vals, device=CPU), pg, k).to_pylist() == \
            ref_gb.group_topk(RefColumn.from_numpy(vals), rg, k).to_pylist()


@pytest.mark.parametrize("dropna", [True, False])
def test_histogram_matches_value_counts(dropna):
    pdf = _frame(6, float_keys=True)
    got = _port(pdf).groupby("k", dropna=dropna).agg({"v": "histogram"}).to_pandas()["v"]
    exp = pdf.groupby("k", dropna=dropna)["v"].value_counts(dropna=False)
    want = {}
    for (key, value), count in exp.items():
        want.setdefault(_norm(key), {})[_norm(value)] = int(count)
    assert [_norm(k) for k in got.index] == list(want)
    for key, hist in zip(want, got.tolist()):
        assert {d["value"]: d["count"] for d in hist} == want[key]
        assert [d["value"] for d in hist] == _ascending([d["value"] for d in hist])


def test_list_aggs_of_strings_and_explode_back():
    rng = np.random.default_rng(7)
    pdf = pd.DataFrame({"k": rng.integers(0, 5, 60),
                        "s": pd.Series(["id%03d" % v for v in rng.integers(0, 9, 60)],
                                       dtype=object)})
    pdf.loc[rng.random(60) < 0.1, "s"] = None
    got = _port(pdf).groupby("k").s.agg(list)
    exp = pdf.groupby("k").s.agg(list)
    assert _norm(got.to_pandas().tolist()) == _norm(exp.tolist())
    back = got.explode().to_pandas()
    assert sorted(zip(back.index, back.map(_norm)), key=str) == \
        sorted(zip(pdf["k"], pdf["s"].map(_norm)), key=str)
