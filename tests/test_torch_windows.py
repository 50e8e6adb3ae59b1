"""``frame/window.py`` and the engine's ``Rolling`` against the reference
(JAX on the CPU) within rtol 1e-12 where the reference is right, and
against pandas 3 within rtol 1e-9 where this port's ROADMAP.md §3 lists
the reference as wrong:

- fault 1: an empty resample bin sums to 0 (the reference gives NaN;
  ``tests/test_torch_resample.py``);
- fault 2: a centred window computes the column's tail (the reference
  leaves the last (w - 1) // 2 rows NaN; ``tests/test_torch_rolling_grouped.py``);
- fault 3: rolling var/std are centred per window; they are held to a
  two-pass float64 variance of each window, within rtol 1e-9 (pandas'
  own online algorithm is itself ~1e-8 off for values near 1e9, and the
  reference's prefix sums give 0.0 there).

Against the reference, sums and means also take an absolute 1e-11: its
global prefix-sum differences (of 240 values up to ~30 here) round to
~3e-12 absolute, which is more than rtol 1e-12 of a window summing near
zero.  Its var/std are held at rtol 1e-9 where it is right (its prefix
sums lose digits relative to the window's spread)."""

import numpy as np
import pandas as pd
import pytest
import torch

import torch_jax_cache  # noqa: F401  (the run's shared JAX compile cache)
import cudf_tpu as R

import cudf_tpu_torch as ct
from cudf_tpu_torch.engine import ir as IRs
from cudf_tpu_torch.frame.series import UDF_ROUTES
from torch_windows_helpers import CPU, REF_ATOL, _close, _values

torch.set_num_threads(1)


def test_fault_3_var_near_1e9_is_centred():
    big = pd.Series([1e9 + 1, 1e9 + 2, 1e9 + 4, 1e9 + 8, 1e9 + 3])
    got = ct.Series(big, device=CPU).rolling(3).var()
    _close(got, [np.nan, np.nan, 7 / 3, 28 / 3, 7.0], 1e-9)
    assert R.Series(big).rolling(3).var().to_pandas().tolist()[2:] == [0.0, 0.0, 0.0]
    _close(ct.Series(big, device=CPU).rolling(3).std(), big.rolling(3).std(), 1e-7)
    const = pd.Series([5.0] * 8)
    assert ct.Series(const, device=CPU).rolling(3).var().tolist()[2:] == [0.0] * 6


@pytest.mark.parametrize("fn", ["sum", "mean", "min", "max", "count"])
@pytest.mark.parametrize("offset", ["1h", "25min", "2D"])
def test_offset_windows_equal_the_reference(fn, offset):
    rng = np.random.default_rng(4)
    ts = pd.to_datetime("2021-01-01") + pd.to_timedelta(
        np.sort(rng.integers(0, 3 * 86400, 200)), unit="s")
    ps = pd.Series(_values(200, 2).to_numpy(), index=ts)
    got = getattr(ct.Series(ps, device=CPU).rolling(offset), fn)()
    if fn != "count":          # the reference counts valid values against min_periods
        exp = getattr(R.from_pandas(ps).rolling(offset), fn)().to_pandas()
        _close(got, exp, 1e-12, REF_ATOL)
    _close(got, getattr(ps.rolling(offset), fn)(), 1e-9)


def test_offset_var_and_day_unit_index():
    days = np.array(["2024-01-01", "2024-01-02", "2024-01-02", "2024-01-05", "2024-01-06"],
                    "datetime64[D]")
    x = np.array([1e9 + 1, 1e9 + 5, 1e9 + 2, 1e9 + 9, 1e9 + 4])
    s = ct.Series(x, index=ct.Index(ct.Series(days, device=CPU)._column), device=CPU)
    ps = pd.Series(x, index=pd.DatetimeIndex(days.astype("datetime64[s]")))
    _close(s.rolling("2D").sum(), ps.rolling("2D").sum(), 1e-12)
    _close(s.rolling("3D").var(), [np.nan, 8.0, 13 / 3, np.nan, 12.5], 1e-9)


def test_apply_vmapped_and_host():
    ps = _values(120, 5)
    s = ct.Series(ps, device=CPU)
    before = dict(UDF_ROUTES)
    got = s.rolling(6).apply(lambda x: x.max() - x.min(), raw=True)
    assert UDF_ROUTES["vmap"] == before["vmap"] + 1
    _close(got, ps.rolling(6).apply(lambda x: x.max() - x.min(), raw=True), 1e-12)
    got = s.rolling(6, min_periods=2).apply(lambda x: float(np.nanmedian(x)), raw=True)
    assert UDF_ROUTES["host"] == before["host"] + 1
    _close(got, ps.rolling(6, min_periods=2).apply(lambda x: float(np.nanmedian(x)),
                                                   raw=True), 1e-12)
    got = s.rolling(4).apply(lambda w: w.sum(), raw=False)
    _close(got, ps.rolling(4).apply(lambda w: w.sum(), raw=False), 1e-12)


def test_dataframe_rolling_and_ewm():
    pdf = pd.DataFrame({"a": _values(80, 6), "b": np.arange(80) % 7, "s": ["x"] * 80})
    df = ct.DataFrame.from_pandas(pdf, device=CPU)
    got = df.rolling(3).mean().to_pandas()
    exp = R.DataFrame.from_pandas(pdf).rolling(3).mean().to_pandas()
    assert list(got.columns) == list(exp.columns) == ["a", "b"]
    _close(got["a"], exp["a"], 1e-12, REF_ATOL)
    _close(got["b"], exp["b"], 1e-12, REF_ATOL)
    for kw in ({"alpha": 0.3}, {"span": 5}, {"com": 2.0}, {"halflife": 3.0},
               {"alpha": 0.3, "adjust": False}, {"alpha": 0.2, "ignore_na": True}):
        _close(ct.Series(pdf["a"], device=CPU).ewm(**kw).mean(), pdf["a"].ewm(**kw).mean(),
               1e-12)
    _close(df[["a", "b"]].ewm(alpha=0.4).mean().to_pandas()["b"],
           pdf[["a", "b"]].ewm(alpha=0.4).mean()["b"], 1e-12)


def test_engine_rolling_node_equals_the_reference():
    from cudf_tpu.engine import ir as RIR
    from cudf_tpu.core.table import Table as RT

    pdf = pd.DataFrame({"t": np.arange(50), "v": _values(50, 9, nan=False)})
    df = ct.DataFrame.from_pandas(pdf, device=CPU)
    aggs = [("s", "v", "sum"), ("m", "v", "max"), ("c", "v", "count")]
    got = IRs.Rolling(IRs.DataFrameScan(df._table), "t", 4, aggs).evaluate()
    rdf = R.DataFrame.from_pandas(pdf)
    exp = RIR.Rolling(RIR.DataFrameScan(rdf._table), "t", 4, aggs).evaluate()
    assert list(got.names) == list(exp.names) == ["t", "s", "m", "c"]
    for name in ("s", "m", "c"):
        _close(pd.Series(got[name].to_numpy()), pd.Series(np.asarray(exp[name].to_numpy())),
               1e-12, REF_ATOL)
    assert "Rolling" in IRs.Rolling(IRs.DataFrameScan(df._table), "t", 4, aggs).explain()
