"""Frames, aggregations and comparisons shared by
tests/test_torch_sort_groupby.py and tests/test_torch_sort_tier_aggs.py."""

import numpy as np
import pandas as pd
import pytest
import torch

from cudf_tpu.core.column import Column as RefColumn
from cudf_tpu.ops import groupby as ref_gb
import cudf_tpu_torch as ct
from cudf_tpu_torch.ops import groupby as gb


CPU = torch.device("cpu")
N = 600
F32_RTOL = 1e-5
AGGS = ["sum", "count", "size", "mean", "min", "max", "var", "std", "prod", "any", "all",
        "first", "last", "nunique", "median", "quantile", "idxmin", "idxmax"]


def _frame(seed, n=N, keys=4):
    """Keys a (int32, with NaN-free nulls as pandas Int32) and b (float64
    with NaN); values i int32 and f float64 with nulls, g float32, t
    bool, u uint64 (small), s int8 (prod fits)."""
    rng = np.random.default_rng(seed)
    pdf = pd.DataFrame({
        "a": pd.array(rng.integers(0, keys, n), dtype="Int32"),
        "b": rng.integers(0, 3, n).astype(np.float64),
        "i": pd.array(rng.integers(-1000, 1000, n), dtype="Int32"),
        "f": rng.uniform(0, 100, n),
        "g": rng.normal(size=n).astype(np.float32),
        "t": rng.random(n) > 0.5,
        "u": rng.integers(0, 50, n).astype(np.uint64),
        "s": rng.choice(np.array([-1, 1, 1, 1], dtype=np.int8), n),
    })
    pdf.loc[rng.random(n) < 0.1, "a"] = pd.NA
    pdf.loc[rng.random(n) < 0.05, "b"] = np.nan
    pdf.loc[rng.random(n) < 0.1, "i"] = pd.NA
    pdf.loc[rng.random(n) < 0.1, "f"] = np.nan
    return pdf


def _port_column(series):
    """A port column over a pandas column's values and mask (NaN is a
    null, as in from_pandas)."""
    na = series.isna().to_numpy()
    values = series.to_numpy(dtype=series.dtype.numpy_dtype if hasattr(
        series.dtype, "numpy_dtype") else series.dtype, na_value=0)
    return ct.from_buffers(values.dtype, len(series), values,
                           None if not na.any() else ~na, device=CPU)


def _ref_column(series):
    na = series.isna().to_numpy()
    values = series.to_numpy(dtype=series.dtype.numpy_dtype if hasattr(
        series.dtype, "numpy_dtype") else series.dtype, na_value=0)
    return RefColumn.from_numpy(values, mask=None if not na.any() else ~na)


def _check_series(g, e, rtol=1e-12, what=""):
    null = e.isna().to_numpy()
    np.testing.assert_array_equal(g.isna().to_numpy(), null, err_msg=f"{what} nulls")
    e_dtype = getattr(e.dtype, "numpy_dtype", e.dtype)
    if null.any() and np.dtype(e_dtype).kind in "iub":
        e_dtype = np.float64 if np.dtype(e_dtype).kind != "b" else object
    assert g.dtype == e_dtype, (what, g.dtype, e_dtype)
    gv, ev = g.to_numpy()[~null], e.to_numpy()[~null]
    if np.dtype(e_dtype).kind == "f":
        rt = max(rtol, F32_RTOL) if e_dtype == np.float32 else rtol
        np.testing.assert_allclose(gv.astype(np.float64), ev.astype(np.float64), rtol=rt,
                                   atol=0, err_msg=str(what))
    else:
        np.testing.assert_array_equal(gv, ev, err_msg=str(what))


@pytest.fixture(scope="module")
def groupers():
    """One frame grouped by (a, b) under dropna, in the port and in the
    reference (whose make_grouper is exact for keys without null data)."""
    pdf = _frame(1)
    port = gb.make_grouper([_port_column(pdf.a), _port_column(pdf.b)], dropna=True)
    ref = ref_gb.make_grouper([_ref_column(pdf.a), _ref_column(pdf.b)], dropna=True)
    return pdf, port, ref


# the columns each agg is held to the reference on (pandas holds every
# column): the reference's min/max/first/last/prod/any/all run reset scans
# that take ~4 s a dtype to compile on a CPU, so those are held to it on
# the float64 column or not at all; its idxmin/idxmax fail under a row
# mask (ROADMAP.md queue 3)
REF_COLUMNS = dict({agg: ("i", "f", "t", "u") for agg in AGGS},
                   min=("f",), max=("f",), first=("f",), last=("f",), prod=(), any=(),
                   all=(), idxmin=(), idxmax=(), quantile=("i", "f"), median=("i", "f", "u"))
