"""``merge_asof`` (``frame/asof.py``) against pandas 3 and the reference
(JAX on the CPU); ``query``, ``eval`` and the tracing are in
``tests/test_torch_eval_query.py``.

``merge_asof`` is held to pandas in every direction, with ``by=`` over
nanosecond timestamps (fault 4: the reference packs ``group * 2^40 + on``
into one int64, which 2024's timestamps overflow, and gives ``[10, nan,
10]`` where pandas gives ``[10, 20, 30]``) and with a tolerance; without
``by=`` also to the reference."""

import numpy as np
import pandas as pd
import pytest
import torch

import torch_jax_cache  # noqa: F401  (the run's shared JAX compile cache)
import cudf_tpu as R

import cudf_tpu_torch as ct

torch.set_num_threads(1)

CPU = "cpu"


def _frames(n_left=120, n_right=80, seed=0, groups=4):
    rng = np.random.default_rng(seed)
    base = np.datetime64("2024-01-01T00:00:00", "ns")
    lt = base + np.sort(rng.integers(0, 10 ** 12, n_left)).astype("timedelta64[ns]")
    rt = base + np.sort(rng.integers(0, 10 ** 12, n_right)).astype("timedelta64[ns]")
    left = pd.DataFrame({"t": lt, "g": rng.integers(0, groups, n_left), "lv": np.arange(n_left)})
    right = pd.DataFrame({"t": rt, "g": rng.integers(0, groups, n_right),
                          "v": rng.normal(size=n_right), "lv": -np.arange(n_right)})
    return left, right


def _same(got, exp):
    got = got.to_pandas()
    assert list(got.columns) == list(exp.columns)
    for c in exp.columns:
        g, e = got[c], exp[c]
        if e.dtype.kind in "MOT" or str(e.dtype) in ("str", "string"):
            assert g.tolist() == e.tolist(), c
        else:
            np.testing.assert_allclose(g.to_numpy(float), e.to_numpy(float), rtol=0,
                                       equal_nan=True, err_msg=c)


@pytest.mark.parametrize("direction", ["backward", "forward", "nearest"])
@pytest.mark.parametrize("by", [None, "g"])
@pytest.mark.parametrize("tolerance", [None, pd.Timedelta("3min"), pd.Timedelta("40s")])
def test_merge_asof_matches_pandas(direction, by, tolerance):
    left, right = _frames()
    got = ct.merge_asof(ct.DataFrame.from_pandas(left, device=CPU),
                        ct.DataFrame.from_pandas(right, device=CPU), on="t", by=by,
                        direction=direction, tolerance=tolerance)
    _same(got, pd.merge_asof(left, right, on="t", by=by, direction=direction,
                             tolerance=tolerance))


@pytest.mark.parametrize("direction", ["backward", "forward", "nearest"])
def test_merge_asof_without_by_equals_the_reference(direction):
    rng = np.random.default_rng(3)
    left = pd.DataFrame({"t": np.sort(rng.integers(0, 1000, 60)), "a": np.arange(60.0)})
    right = pd.DataFrame({"t": np.sort(rng.integers(0, 1000, 40)), "b": rng.normal(size=40)})
    got = ct.merge_asof(ct.DataFrame.from_pandas(left, device=CPU),
                        ct.DataFrame.from_pandas(right, device=CPU), on="t",
                        direction=direction)
    exp = R.merge_asof(R.DataFrame.from_pandas(left), R.DataFrame.from_pandas(right), on="t",
                       direction=direction)
    np.testing.assert_allclose(got.to_pandas()["b"].to_numpy(float),
                               exp.to_pandas()["b"].to_numpy(float), equal_nan=True)
    _same(got, pd.merge_asof(left, right, on="t", direction=direction))


def test_fault_4_by_over_nanosecond_timestamps():
    t = pd.to_datetime(["2024-01-01", "2024-02-01", "2024-03-01"])
    left = pd.DataFrame({"t": t, "g": [1, 2, 1]})
    right = pd.DataFrame({"t": t, "g": [1, 2, 1], "v": [10, 20, 30]})
    got = ct.merge_asof(ct.DataFrame.from_pandas(left, device=CPU),
                        ct.DataFrame.from_pandas(right, device=CPU), on="t", by="g")
    assert got["v"].tolist() == [10, 20, 30]
    _same(got, pd.merge_asof(left, right, on="t", by="g"))


def test_merge_asof_by_a_string_key_and_suffixes():
    left, right = _frames(40, 30, seed=5)
    left["g"] = left["g"].map(lambda k: f"k{k}")
    right["g"] = right["g"].map(lambda k: f"k{k}")
    got = ct.merge_asof(ct.DataFrame.from_pandas(left, device=CPU),
                        ct.DataFrame.from_pandas(right, device=CPU), on="t", by="g",
                        suffixes=("_l", "_r"))
    _same(got, pd.merge_asof(left, right, on="t", by="g", suffixes=("_l", "_r")))
