"""The kernel-tier groupby transform (``cudf_tpu_torch/ops/groupby.py``
``transform_kernel_tier``) against the sort tier and pandas, the
requests it declines, and the groupby requests the port names beyond
the reference (list aggregations, ``rolling``), over the seeded frames of
``tests/test_torch_groupby_family.py``, with its tolerances."""

import numpy as np
import pandas as pd
import pytest
import torch

import cudf_tpu_torch as ct
from cudf_tpu_torch.ops import copying
from cudf_tpu_torch.ops import groupby as gb
from cudf_tpu_torch.utils.config import option_context
from torch_groupby_family_helpers import CPU, _assert_same, _port


@pytest.mark.parametrize("K", [10, 5000])
@pytest.mark.parametrize("agg", ["sum", "count", "mean", "min", "max", "size"])
def test_kernel_tier_transform_matches_sort_tier_and_pandas(agg, K):
    """transform_kernel_tier (the one-hot tier at K = 10, the radix tier at
    K = 5000, through their plain versions on the CPU) equals the sort
    tier's broadcast and pandas' transform, null keys giving null rows."""
    rng = np.random.default_rng(7)
    n = 3000
    k = rng.integers(0, K, n).astype(np.int32)
    kv = rng.random(n) > 0.05
    x = rng.integers(-50, 50, n).astype(np.int32)
    xv = rng.random(n) > 0.1
    key, vals = _port(k, kv), _port(x, xv)
    with option_context("groupby.fast_path_min_rows", 0):
        got = gb.transform_kernel_tier(key, [("x", vals, agg)])["x"]
    g = gb.make_grouper([key])
    spread = copying.gather(gb.aggregate(vals, g, agg), g.group_ids, bounds_check=False)
    rows = g.kept_rows.numpy()
    exp, exp_ok = np.zeros(n, spread.data.numpy().dtype), np.zeros(n, bool)
    exp[rows] = spread.data.numpy()
    exp_ok[rows] = True if spread.validity is None else spread.validity.numpy()
    assert got.dtype == spread.dtype
    _assert_same(got, exp, exp_ok, 1e-12, f"{agg} vs the sort tier")
    pdf = pd.DataFrame({"k": pd.array(np.where(kv, k, 0), dtype="Int32"),
                        "x": pd.array(x, dtype="Int32")})
    pdf.loc[~kv, "k"] = pd.NA
    pdf.loc[~xv, "x"] = pd.NA
    pexp = pdf.groupby("k")["x"].transform(agg)
    _assert_same(got, pexp.to_numpy(dtype=np.float64, na_value=np.nan),
                 ~pexp.isna().to_numpy(), 1e-12, f"{agg} vs pandas")


def test_kernel_tier_transform_declines_what_the_sort_tier_serves():
    """Two keys, a float key, a null-key group (dropna=False), NaN in a float
    mean and an aggregation outside sum/count/mean/min/max/size: None."""
    rng = np.random.default_rng(8)
    k = _port(rng.integers(0, 5, 100).astype(np.int32), rng.random(100) > 0.1)
    f = _port(rng.normal(size=100), None)
    nan = _port(np.where(rng.random(100) > 0.5, np.nan, 1.0), None)
    with option_context("groupby.fast_path_min_rows", 0):
        assert gb.transform_kernel_tier(f, [("x", f, "sum")]) is None
        assert gb.transform_kernel_tier(k, [("x", f, "sum")], dropna=False) is None
        assert gb.transform_kernel_tier(k, [("x", nan, "mean")]) is None
        assert gb.transform_kernel_tier(k, [("x", f, "median")]) is None
        assert gb.transform_kernel_tier(k, [("x", f, "sum")]) is not None


def test_frame_transform_takes_the_kernel_tier_without_a_grouper():
    """A frame's transform of an aggregation by one integer key is served
    by the kernel tiers and builds no grouper sort; the sort tier's answer
    (the tiers switched off) is the same, and pandas'."""
    rng = np.random.default_rng(9)
    pdf = pd.DataFrame({"k": rng.integers(0, 20, 500).astype(np.int32),
                        "v": rng.normal(size=500), "i": rng.integers(0, 9, 500)})
    df = ct.DataFrame.from_pandas(pdf, device=CPU)
    with option_context("groupby.fast_path_min_rows", 0):
        grouped = df.groupby("k")
        fast = grouped.transform("mean").to_pandas()
        assert grouped._grouper is None
    with option_context("groupby.onehot_fast_path", False):
        slow = df.groupby("k").transform("mean").to_pandas()
    exp = pdf.groupby("k").transform("mean")
    pd.testing.assert_frame_equal(fast, slow, rtol=1e-12)
    pd.testing.assert_frame_equal(fast, exp, rtol=1e-12)


@pytest.mark.parametrize("agg", ["collect", "list", "unique", "collect_set", "topk",
                                 "histogram", "tdigest"])
def test_list_aggregations_raise_naming_item_6(agg):
    """The LIST aggregations are ported (ROADMAP.md queue 1, item 6a): one
    list a group, through ``agg`` and ``aggregate`` alike; "topk" needs its
    k (``group_topk``); "tdigest" gives a STRUCT of each group's centroids,
    min and max (ported with item 6c)."""
    df = ct.DataFrame({"k": torch.tensor([1, 1, 2]), "v": torch.tensor([1.0, 2.0, 3.0])})
    g = gb.make_grouper([df._table["k"]])
    if agg == "topk":
        with pytest.raises(NotImplementedError, match="group_topk"):
            df.groupby("k").agg({"v": agg})
        with pytest.raises(NotImplementedError, match="group_topk"):
            gb.aggregate(df._table["v"], g, agg)
        return
    exp = [[1.0, 2.0], [3.0]] if agg not in ("histogram", "tdigest") else \
        [[{"value": 1.0, "count": 1}, {"value": 2.0, "count": 1}], [{"value": 3.0, "count": 1}]]
    if agg == "tdigest":
        exp = [{"centroids": [{"mean": 1.0, "weight": 1.0}, {"mean": 2.0, "weight": 1.0}],
                "min": 1.0, "max": 2.0},
               {"centroids": [{"mean": 3.0, "weight": 1.0}], "min": 3.0, "max": 3.0}]
    assert gb.aggregate(df._table["v"], g, agg).to_pylist() == exp
    assert df.groupby("k").agg({"v": agg})._table["v"].to_pylist() == exp


def test_rolling_raises_naming_item_8():
    """Grouped rolling windows are ported (``frame/window.py``, item 8):
    windows of rows within each group, as pandas gives them; a time offset
    (which the reference lacks) raises naming "beyond the reference"."""
    df = ct.DataFrame({"k": torch.tensor([1, 1, 2]), "v": torch.tensor([1.0, 2.0, 3.0])})
    assert df.groupby("k").rolling(2).sum()._table["v"].to_pylist()[1] == 3.0
    assert df.groupby("k")["v"].rolling(2, min_periods=1).sum().tolist() == [1.0, 3.0, 3.0]
    with pytest.raises(NotImplementedError, match="beyond the reference"):
        df.groupby("k")["v"].rolling("2D")
