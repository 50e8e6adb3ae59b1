"""A dictionary over temporal keys (``ops/dictionary.py``,
``core/column.py`` ``from_dictionary``): ``encode``, ``factorize`` and
``decode`` of timestamp, duration and day-unit columns against the
reference (the JAX CPU backend), and ``Series.astype("category")``,
``Series.factorize``, a groupby and a merge on such a key against pandas.

The same seeded numpy values feed both packages.  A null row's code is
masked: codes are compared at the valid rows.  Everything is exact.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from cudf_tpu.core.column import as_column as ref_as_column
from cudf_tpu.ops import dictionary as ref_dictionary
import cudf_tpu_torch as ct
from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.ops import dictionary

torch.set_num_threads(1)

N = 200
KINDS = ["datetime64[ns]", "datetime64[us]", "datetime64[ms]", "datetime64[s]",
         "datetime64[D]", "timedelta64[ns]", "timedelta64[ms]", "timedelta64[s]"]


def values(kind, seed=0, nulls=True):
    """N values of ``kind`` drawn from 12 distinct ticks (not in order),
    a sixth of them NaT."""
    rng = np.random.default_rng(seed)
    ticks = rng.choice(rng.integers(-4000, 20000, 12) * 3, N)
    arr = ticks.astype(kind)
    if nulls:
        arr[rng.random(N) < 0.17] = np.datetime64("NaT") if kind[0] == "d" else \
            np.timedelta64("NaT")
    return arr


def valid_of(arr):
    return ~np.isnat(arr)


def ticks(col):
    """A column's values as int64 ticks (host)."""
    return col.data.long().numpy() if isinstance(col, Column) else \
        np.asarray(col.data).astype(np.int64)


@pytest.mark.parametrize("kind", KINDS)
def test_encode_matches_the_reference(kind):
    arr = values(kind)
    got = dictionary.encode(Column.from_numpy(arr, device="cpu"))
    exp = ref_dictionary.encode(ref_as_column(arr))
    assert str(got.dtype) == str(exp.dtype) and str(got.keys.dtype) == str(exp.children[0].dtype)
    assert got.dtype.value_type == got.keys.dtype
    np.testing.assert_array_equal(ticks(got.keys), ticks(exp.children[0]))
    valid = valid_of(arr)
    np.testing.assert_array_equal(got.validity.numpy(), valid)
    np.testing.assert_array_equal(got.data.numpy()[valid], np.asarray(exp.data)[valid])


@pytest.mark.parametrize("sort", [True, False])
@pytest.mark.parametrize("kind", KINDS)
def test_factorize_matches_the_reference(kind, sort):
    arr = values(kind, seed=1)
    codes, keys = dictionary.factorize(Column.from_numpy(arr, device="cpu"), sort=sort)
    ref_codes, ref_keys = ref_dictionary.factorize(ref_as_column(arr), sort=sort)
    assert str(keys.dtype) == str(ref_keys.dtype) and keys.validity is None
    np.testing.assert_array_equal(ticks(keys), ticks(ref_keys))
    valid = valid_of(arr)
    np.testing.assert_array_equal(codes.numpy()[valid], np.asarray(ref_codes)[valid])


@pytest.mark.parametrize("kind", KINDS)
def test_decode_gives_the_column_back(kind):
    arr = values(kind, seed=2)
    col = Column.from_numpy(arr, device="cpu")
    back = dictionary.encode(col).decode_dictionary()
    assert back.dtype == col.dtype
    np.testing.assert_array_equal(back.to_numpy(), col.to_numpy())


@pytest.mark.parametrize("kind", KINDS)
def test_astype_category_matches_pandas(kind):
    """pandas' categories, their unit included (a day-unit column is
    datetime64[s] in pandas, as its ``to_pandas`` is)."""
    arr = values(kind, seed=3)
    s = ct.Series(Column.from_numpy(arr, device="cpu"), name="t")
    got = s.astype("category").to_pandas()
    exp = s.to_pandas().astype("category")
    pd.testing.assert_series_equal(got, exp)
    assert got.cat.categories.dtype == exp.cat.categories.dtype


@pytest.mark.parametrize("kind", ["datetime64[ns]", "datetime64[D]", "timedelta64[ms]"])
def test_series_factorize_matches_pandas(kind):
    arr = values(kind, seed=4)
    s = ct.Series(Column.from_numpy(arr, device="cpu"))
    codes, uniques = s.factorize()
    exp_codes, exp_uniques = s.to_pandas().factorize()
    np.testing.assert_array_equal(np.asarray(codes), exp_codes)
    np.testing.assert_array_equal(uniques.to_numpy(), exp_uniques.to_numpy())


@pytest.mark.parametrize("kind", ["datetime64[us]", "datetime64[D]", "timedelta64[ns]"])
def test_groupby_on_a_temporal_category_matches_pandas(kind):
    arr = values(kind, seed=5)
    v = np.random.default_rng(5).integers(0, 1000, N)
    df = ct.DataFrame({"k": ct.Series(Column.from_numpy(arr, device="cpu")).astype("category"),
                       "v": ct.Series(v, device="cpu")})
    got = df.groupby("k").agg({"v": ["sum", "count"]}).to_pandas()
    pdf = pd.DataFrame({"k": df["k"].to_pandas(), "v": v})
    exp = pdf.groupby("k", observed=True).agg({"v": ["sum", "count"]})
    pd.testing.assert_frame_equal(got, exp, check_dtype=False)


@pytest.mark.parametrize("kind", ["datetime64[ns]", "timedelta64[s]"])
def test_merge_on_a_temporal_category_matches_pandas(kind):
    arr = values(kind, seed=6, nulls=False)
    left = ct.DataFrame({"k": ct.Series(Column.from_numpy(arr, device="cpu")).astype("category"),
                         "v": ct.Series(np.arange(N), device="cpu")})
    distinct = np.unique(arr)[::2]
    right = ct.DataFrame({"k": ct.Series(Column.from_numpy(distinct, device="cpu"))
                          .astype("category"),
                          "w": ct.Series(np.arange(distinct.size) * 10, device="cpu")})
    got = left.merge(right, on="k").to_pandas()
    exp = left.to_pandas().merge(right.to_pandas(), on="k")
    for frame in (got, exp):
        frame["k"] = frame["k"].astype(arr.dtype if kind[0] == "t" else "datetime64[ns]")
    key = ["k", "v"]
    pd.testing.assert_frame_equal(got.sort_values(key).reset_index(drop=True),
                                  exp.sort_values(key).reset_index(drop=True), check_dtype=False)


@pytest.mark.parametrize("keys", [
    np.array([1, 5, 9], np.int8), np.array([2.5, 7.0]), np.array([3, 4], np.uint32),
    np.array([10, 20], "datetime64[ms]"), np.array([1, 2], "timedelta64[us]"),
    np.array(["2024-01-01", "2024-02-01"], "datetime64[D]"), np.array(["a", "b"], object)])
def test_from_dictionary_keeps_the_keys_dtype(keys):
    """Every non-STRING key column keeps its dtype as the value type; any
    string keys give STRING."""
    k = Column.from_numpy(keys, device="cpu")
    col = Column.from_dictionary(torch.tensor([1, 0, 1], dtype=torch.int32), k)
    assert col.dtype.value_type == (dt.STRING if k.dtype.is_string else k.dtype)
    np.testing.assert_array_equal(col.to_numpy(), keys[[1, 0, 1]])
