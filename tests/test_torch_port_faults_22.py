"""Port faults found by running pandas' own tests under the port's
accelerator, each held to pandas 3 on the port's objects directly: a
nullable or Arrow-backed Series' rank, a STRING column's groupby sum, and
``between``'s check of ``inclusive``."""

import pandas as pd
import pytest

import cudf_tpu_torch as ct


@pytest.mark.parametrize("dtype", ["Int64", "Float64", "boolean", "int64[pyarrow]",
                                   "float64[pyarrow]", "uint8[pyarrow]", "float64"])
@pytest.mark.parametrize("kw", [{}, {"method": "first"}, {"pct": True},
                                {"method": "dense", "na_option": "top"},
                                {"method": "max", "ascending": False}])
def test_rank_keeps_pandas_dtype_family(dtype, kw):
    values = [True, False, None, True] if dtype == "boolean" else [3, 1, None, 2]
    exp = pd.Series(values, dtype=dtype).rank(**kw)
    got = ct.Series(pd.Series(values, dtype=dtype), device="cpu").rank(**kw).to_pandas()
    assert got.dtype == exp.dtype, (got.dtype, exp.dtype)
    assert got.isna().tolist() == exp.isna().tolist()
    assert got[exp.notna()].astype(float).tolist() == exp[exp.notna()].astype(float).tolist()


@pytest.mark.parametrize("sort", [True, False])
def test_groupby_sum_of_strings_joins_them(sort):
    pdf = pd.DataFrame({"k": [2, 1, 2, 2, 3], "s": ["a", "b", None, "c", None],
                        "v": [1.0, 2.0, 3.0, 4.0, 5.0]})
    exp = pdf.groupby("k", sort=sort).sum()
    got = ct.DataFrame.from_pandas(pdf, device="cpu").groupby("k", sort=sort).sum().to_pandas()
    assert got["s"].tolist() == exp["s"].tolist() == (["b", "ac", ""] if sort else
                                                      ["ac", "b", ""])
    assert got["v"].tolist() == exp["v"].tolist()
    assert got["s"].dtype == exp["s"].dtype


@pytest.mark.parametrize("inclusive", ["yes", True, False, None])
def test_between_refuses_an_unknown_inclusive(inclusive):
    s = ct.Series([1.0, 2.0, 3.0], device="cpu")
    with pytest.raises(ValueError, match="Inclusive has to be either"):
        s.between(1.0, 2.0, inclusive=inclusive)
    with pytest.raises(ValueError, match="Inclusive has to be either"):
        pd.Series([1.0]).between(1.0, 2.0, inclusive=inclusive)
    assert s.between(1.0, 2.0, inclusive="left").tolist() == [True, False, False]
