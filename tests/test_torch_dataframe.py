"""The port's ``DataFrame`` (its pandas API) against pandas and the
reference's ``cudf_tpu.DataFrame`` on the same seeded inputs.

Each case runs one function on a pandas frame, the port's and (for the
cases the reference serves) the reference's, compared through
``to_pandas``: columns, values, nulls, index labels.  Integers, bools,
strings and labels exact; floats rtol 1e-12.  ``__setitem__`` of a Series
over other labels is held to pandas, which aligns by label (the
reference assigns by position when the lengths agree).
"""

import numpy as np
import pandas as pd
import pytest
import torch

import cudf_tpu
import cudf_tpu_torch as ct

torch.set_num_threads(1)

CPU = torch.device("cpu")
N = 30


def _pdf():
    rng = np.random.default_rng(21)
    b = rng.normal(0, 1, N).round(3)
    b[[2, 9, 20]] = np.nan
    return pd.DataFrame({"a": rng.integers(-4, 5, N), "b": b,
                         "c": rng.choice(["x", "yy", "z"], N),
                         "d": rng.random(N) > 0.4, "e": rng.normal(0, 1, N).round(3)})


PDF = _pdf()


def _frame(ns):
    if ns is ct:
        return ct.DataFrame.from_pandas(PDF, device=CPU)
    if ns is cudf_tpu:
        return cudf_tpu.DataFrame.from_pandas(PDF)
    return PDF.copy()


def _host(x):
    return x.to_pandas() if hasattr(x, "to_pandas") else x


def assert_like(got, exp):
    got, exp = _host(got), _host(exp)
    if isinstance(exp, pd.DataFrame):
        assert list(got.columns) == list(exp.columns), (list(got.columns), list(exp.columns))
        got, exp = got.copy(), exp.copy()
        for c in exp.columns:
            if exp[c].dtype.kind not in "fiub" or got[c].dtype.kind not in "fiub":
                got[c], exp[c] = got[c].astype(object), exp[c].astype(object)
            elif exp[c].dtype.kind != "b":
                got[c], exp[c] = got[c].astype("float64"), exp[c].astype("float64")
        pd.testing.assert_frame_equal(got, exp, check_dtype=False, check_index_type=False,
                                      check_column_type=False, rtol=1e-12)
    elif isinstance(exp, pd.Series):
        got, exp = got.copy(), exp.copy()
        if exp.dtype.kind in "fiu":
            got, exp = got.astype("float64"), exp.astype("float64")
        elif exp.dtype.kind != "b":
            got, exp = got.astype(object), exp.astype(object)
        pd.testing.assert_series_equal(got, exp, check_dtype=False, check_index_type=False,
                                       check_names=False, rtol=1e-12)
    else:
        assert got == exp, (got, exp)


NUM = ["a", "b", "e"]
CASES = [
    ("select", lambda df: df[["a", "c"]]),
    ("column", lambda df: df["b"]),
    ("attr", lambda df: df.e),
    ("mask", lambda df: df[df.a > 0]),
    ("mask_and", lambda df: df[(df.a > 0) & (df.e < 0.5)]),
    ("head", lambda df: df.head(4)),
    ("tail", lambda df: df.tail(3)),
    ("iloc_slice", lambda df: df.iloc[3:8]),
    ("iloc_rows", lambda df: df.iloc[[4, 0, 2]]),
    ("loc_slice", lambda df: df.loc[5:9]),
    ("loc_rows_cols", lambda df: df.loc[[1, 3], ["b", "c"]]),
    ("assign", lambda df: df.assign(f=df.a * (1 - df.e), g=2.5)),
    ("rename", lambda df: df.rename(columns={"a": "A"})),
    ("drop", lambda df: df.drop(columns=["b", "d"])),
    ("fillna", lambda df: df[NUM].fillna(0.0)),
    ("fillna_dict", lambda df: df.fillna({"b": -1.0})),
    ("dropna", lambda df: df.dropna()),
    ("dropna_subset", lambda df: df.dropna(subset=["b", "e"])),
    ("isna", lambda df: df[NUM].isna()),
    ("astype", lambda df: df.astype({"a": "float64"})),
    ("abs", lambda df: df[NUM].abs()),
    ("clip", lambda df: df[NUM].clip(-1, 1)),
    ("shift", lambda df: df[NUM].shift(2)),
    ("cumsum", lambda df: df[NUM].cumsum()),
    ("add", lambda df: df[NUM] + 1),
    ("radd", lambda df: 1 - df[NUM]),
    ("frame_mul", lambda df: df[NUM] * df[NUM]),
    ("sort_values", lambda df: df.sort_values(["c", "a"], kind="stable")),
    ("set_index", lambda df: df.set_index("a")),
    ("reset_index", lambda df: df[df.a > 0].reset_index()),
    ("sum", lambda df: df[NUM].sum()),
    ("mean", lambda df: df[NUM].mean()),
    ("min", lambda df: df[NUM].min()),
    ("count", lambda df: df.count()),
    ("nunique", lambda df: df.nunique()),
    ("sum_axis1", lambda df: df[NUM].sum(axis=1)),
    ("nlargest", lambda df: df.nlargest(5, "e")),
    ("duplicated", lambda df: df.duplicated(["a", "c"])),
    ("select_dtypes", lambda df: df.select_dtypes("number")),
    ("where", lambda df: df[NUM].where(df[NUM] > 0, 0.0)),
    ("round", lambda df: df[NUM].round(1)),
    ("groupby_named", lambda df: df.groupby("c", observed=True).agg(
        s=("e", "sum"), n=("a", "count")).reset_index()),
    ("merge", lambda df: df.merge(df[["c", "e"]].head(3), on="c")),
]
REFERENCE = [c for c in CASES if c[0] in ("select", "mask", "head", "iloc_slice", "assign",
                                          "fillna", "dropna", "sum", "sort_values")]


@pytest.mark.parametrize("name,fn", CASES, ids=[c[0] for c in CASES])
def test_frame_method_matches_pandas(name, fn):
    assert_like(fn(_frame(ct)), fn(_frame(pd)))


@pytest.mark.parametrize("name,fn", REFERENCE, ids=[c[0] for c in REFERENCE])
def test_frame_method_matches_reference(name, fn):
    assert_like(fn(_frame(ct)), fn(_frame(cudf_tpu)))


def test_setitem_aligns_a_series_by_label_as_pandas():
    """pandas aligns df["c"] = s by label; the reference assigns a Series
    of the frame's length by position."""
    pdf = pd.DataFrame({"a": [3, 1, 2]})
    port = ct.DataFrame.from_pandas(pdf, device=CPU)
    ref = cudf_tpu.DataFrame.from_pandas(pdf)
    pdf["c"] = pdf["a"].sort_values()
    port["c"] = port["a"].sort_values()
    ref["c"] = ref["a"].sort_values()
    assert port.to_pandas()["c"].tolist() == pdf["c"].tolist() == [3, 1, 2]
    assert ref.to_pandas()["c"].tolist() == [1, 2, 3]          # the reference's fault
    port["d"] = port["a"].iloc[1:]                   # a label it lacks: NaN
    pdf["d"] = pdf["a"].iloc[1:]
    assert_like(port, pdf)


def test_setitem_forms_and_buffers_as_pandas():
    port, pdf = _frame(ct), _frame(pd)
    child, pchild = port[port.a > 0], pdf[pdf.a > 0]
    data = child["e"]._column.data.clone()
    for df in (port, pdf):
        df["e"] = df.e * 2
        df["k"] = 7
        df["arr"] = np.arange(N)
        df.loc[df.a < 0, "e"] = 0.0
        df.insert(0, "first", df.a + 1)
        del df["d"]
        df.pop("b")
    assert_like(port, pdf)
    assert torch.equal(child["e"]._column.data, data)     # the child's buffer is its own
    assert_like(child, pchild)
    port.columns = [str(c).upper() for c in port.columns]
    pdf.columns = [str(c).upper() for c in pdf.columns]
    assert_like(port, pdf)
    with pytest.raises(ValueError, match="device"):
        ct.DataFrame({"a": np.arange(3)})


def test_attributes_and_rows_as_pandas():
    port, pdf = _frame(ct), _frame(pd)
    assert port.shape == pdf.shape and port.size == pdf.size and port.ndim == 2
    assert list(port) == list(pdf) and ("b" in port) and ("zz" not in port)
    assert not port.empty and port.columns == list(pdf.columns)
    assert port.equals(port.copy()) and not port.equals(port.head(3))
    assert port.at[4, "c"] == pdf.at[4, "c"] and port.iat[5, 0] == pdf.iat[5, 0]
    assert port.iloc[2, 1] == pdf.iloc[2, 1] or np.isnan(pdf.iloc[2, 1])
    np.testing.assert_array_equal(port[NUM].to_numpy(), pdf[NUM].to_numpy())
    assert port.to_dict("list")["c"] == pdf.to_dict("list")["c"]
    assert_like(port[NUM].quantile(0.5), pdf[NUM].quantile(0.5))
    assert_like(port[NUM].idxmax(), pdf[NUM].idxmax())
    assert_like(port[["a", "c"]].value_counts(), pdf[["a", "c"]].value_counts())
    assert_like(port.mask(port.a > 0).a, pdf.mask(pdf.a > 0).a)
    assert_like(port.dropna(thresh=5), pdf.dropna(thresh=5))
    assert_like(port[NUM].diff(), pdf[NUM].diff())
    assert_like(port.replace({"x": "X"}), pdf.replace({"x": "X"}))
    assert_like(port[NUM].ffill(), pdf[NUM].ffill())
    assert_like(port[NUM].bfill(), pdf[NUM].bfill())
    assert_like(port[NUM].mean(axis=1), pdf[NUM].mean(axis=1))
    assert_like(port.set_axis(np.arange(N) + 100), pdf.set_axis(np.arange(N) + 100))
    assert_like(port.loc[7], pdf.loc[7].astype(object))
    assert port.to_json(lines=True) == pdf.to_json(orient="records", lines=True)
    with pytest.raises(NotImplementedError, match="beyond the reference"):
        port.interpolate()
