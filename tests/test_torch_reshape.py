"""The port's reshapes (``cudf_tpu_torch/frame/reshape.py``: concat,
get_dummies, melt, pivot_table, pivot, crosstab, unstack, stack,
transpose) against the reference's ``cudf_tpu/frame/reshape.py`` and
pandas on the same seeded inputs, compared through ``to_pandas``.

Where the reference is at fault the case is held to pandas, and says so:
``pivot_table``, ``crosstab`` and ``unstack`` reset the index (the index
keys become columns, the columns axis loses its name); ``get_dummies`` of
a named Series without a prefix prefixes the Series' name.  ``melt``'s
``variable`` is a DICTIONARY32, so it comes back as a Categorical of
pandas' values (``check_categorical=False``).  A frame's column names
are host values, so a column axis of int32 keys comes back as int64
(``check_column_type=False``).  Values exact, floats rtol 1e-12.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import torch_jax_cache  # noqa: F401  (the run's shared JAX compile cache)
import cudf_tpu
import cudf_tpu_torch as ct

torch.set_num_threads(1)

CPU = torch.device("cpu")
N = 40


def _pdf():
    rng = np.random.default_rng(5)
    v = rng.normal(0, 1, N).round(3)
    v[[3, 11, 30]] = np.nan
    return pd.DataFrame({"k": rng.integers(1, 5, N).astype(np.int32),
                         "c": rng.integers(1, 4, N), "s": rng.choice(["x", "yy", "z"], N),
                         "v": v, "w": rng.integers(-9, 10, N),
                         "f": rng.normal(0, 1, N).round(3)})


PDF = _pdf()


def _port(pdf=PDF):
    return ct.DataFrame.from_pandas(pdf, device=CPU)


def _ref(pdf=PDF):
    return cudf_tpu.DataFrame.from_pandas(pdf)


def like(got, exp, **kw):
    got = got.to_pandas() if hasattr(got, "to_pandas") else got
    exp = exp.to_pandas() if hasattr(exp, "to_pandas") else exp
    opts = dict(check_exact=False, rtol=1e-12)
    opts.update(kw)
    if isinstance(exp, pd.DataFrame):
        pd.testing.assert_frame_equal(got, exp, **opts)
    else:
        pd.testing.assert_series_equal(got, exp, **opts)


CONCAT_CASES = {
    "rows_same_columns": lambda ns, d: ns.concat([d.iloc[:15], d.iloc[15:]]),
    "rows_missing_columns": lambda ns, d: ns.concat([d[["k", "v", "s"]], d[["k", "w"]]]),
    "rows_inner": lambda ns, d: ns.concat([d[["k", "v", "s"]], d[["k", "w", "v"]]],
                                          join="inner"),
    "rows_ignore_index": lambda ns, d: ns.concat([d.head(5), d.tail(7)], ignore_index=True),
    "series": lambda ns, d: ns.concat([d["w"].head(4), d["w"].tail(3)]),
    "int_with_float": lambda ns, d: ns.concat([d["w"], d["f"].rename("w")]),
    "columns_aligned": lambda ns, d: ns.concat([d[["k", "v"]], d["w"]], axis=1),
}


@pytest.mark.parametrize("name", list(CONCAT_CASES))
def test_concat_matches_reference_and_pandas(name):
    fn = CONCAT_CASES[name]
    got = fn(ct, _port())
    like(got, fn(pd, PDF))
    like(got, fn(cudf_tpu, _ref()))


def test_concat_pieces_the_reference_does_not_align():
    """axis=1 over differing labels aligns by label (the labels in order
    of appearance, an unnamed Series numbered), and the two halves of a
    RangeIndex join back into one RangeIndex: held to pandas (the
    reference sets the columns side by side by position, and keeps the
    first Series' name where the names differ)."""
    port, pdf = _port(), PDF
    cases = [
        lambda ns, d: ns.concat([d["w"], d["f"]]),
        lambda ns, d: ns.concat([d["k"], d["v"].iloc[5:].rename(None), d["f"].iloc[::2]],
                                axis=1),
        lambda ns, d: ns.concat([d["k"], d["v"].iloc[5:]], axis=1, join="inner"),
        lambda ns, d: ns.concat([d[["k"]], d[["w"]]], axis=1, ignore_index=True),
    ]
    for fn in cases:
        like(fn(ct, port), fn(pd, pdf))
    halves = ct.concat([port.iloc[:20], port.iloc[20:]])
    assert isinstance(halves.index, ct.RangeIndex) and halves.equals(port)


def test_concat_of_dictionaries_over_different_keys():
    """Two Categoricals over different categories append to their
    values (the port's result is a Categorical over the union; pandas
    gives strings)."""
    a = pd.DataFrame({"s": pd.Categorical(["x", "y", "x"]), "v": [1.0, 2.0, 3.0]})
    b = pd.DataFrame({"s": pd.Categorical(["z", "x"]), "v": [4.0, 5.0]})
    got = ct.concat([ct.DataFrame.from_pandas(a, device=CPU),
                     ct.DataFrame.from_pandas(b, device=CPU)]).to_pandas()
    exp = pd.concat([a, b])
    assert got["s"].astype(str).tolist() == exp["s"].astype(str).tolist()
    like(got[["v"]], exp[["v"]])


def test_get_dummies_matches_reference_and_pandas():
    port, ref = _port(), _ref()
    for kw in ({"columns": ["s"]}, {"columns": ["s", "k"], "prefix": "P"},
               {"columns": ["s"], "drop_first": True}, {"columns": ["c"], "dtype": "int64"}):
        got = ct.get_dummies(port, **kw)
        like(got, pd.get_dummies(PDF, **kw), check_column_type=False)
        like(got, cudf_tpu.get_dummies(ref, **kw), check_column_type=False)


def test_get_dummies_held_to_pandas():
    """A named Series without a prefix: pandas names the columns by the
    categories alone (the reference prefixes the Series' name); a list
    of prefixes, one a column (the reference takes the column names); a
    Categorical's columns are all its categories, in their order."""
    kw = {"columns": ["s", "k"], "prefix": ["S", "K"]}
    like(ct.get_dummies(_port(), **kw), pd.get_dummies(PDF, **kw), check_column_type=False)
    s = PDF["s"].rename("x")
    like(ct.get_dummies(ct.Series(s, device=CPU)), pd.get_dummies(s))
    like(ct.get_dummies(ct.Series(s, device=CPU), prefix="p"), pd.get_dummies(s, prefix="p"))
    cat = pd.Series(pd.Categorical(["b", None, "a"], categories=["c", "a", "b"]))
    like(ct.get_dummies(ct.Series(cat, device=CPU)), pd.get_dummies(cat),
         check_column_type=False, check_categorical=False)


@pytest.mark.parametrize("kw", [dict(id_vars="k", value_vars=["v", "f"]),
                                dict(id_vars=["k", "s"], value_vars=["w"], var_name="var",
                                     value_name="val"),
                                dict(id_vars=["k"])])
def test_melt_matches_reference_and_pandas(kw):
    cols = ["k", "s", "v", "f", "w"] if "value_vars" in kw else ["k", "v", "f"]
    got = ct.melt(_port()[cols], **kw)
    assert got._table[kw.get("var_name", "variable")].dtype.is_dictionary
    opts = dict(check_dtype=False, check_categorical=False)
    like(got, pd.melt(PDF[cols], **kw), **opts)
    like(got, cudf_tpu.melt(_ref()[cols], **kw), **opts)
    like(_port()[cols].melt(**kw), PDF[cols].melt(**kw), **opts)


PIVOTS = {
    "sum_one_value": dict(values="w", index="k", columns="c", aggfunc="sum"),
    "mean_values_list": dict(values=["v", "w"], index="k", columns="c", aggfunc="mean"),
    "one_value_in_a_list": dict(values=["f"], index="k", columns="c", aggfunc="max"),
    "fill_value": dict(values="w", index=["k"], columns="c", aggfunc="sum", fill_value=0),
    "two_index_keys": dict(values="f", index=["k", "c"], columns="s", aggfunc="count"),
    "string_columns": dict(values="v", index="c", columns="s", aggfunc="sum"),
    "no_columns": dict(values=["w", "v"], index="k", aggfunc="sum"),
    "no_values": dict(index="k", columns="c", aggfunc="min"),
}


@pytest.mark.parametrize("name", list(PIVOTS))
def test_pivot_table_held_to_pandas(name):
    """The grid, the index keys as the index and the column keys as the
    columns with their axis names (the reference resets the index and
    drops the names): held to pandas, names checked."""
    kw = dict(PIVOTS[name])
    pdf = PDF.drop(columns=["s"]) if name == "no_values" else PDF
    got = ct.pivot_table(ct.DataFrame.from_pandas(pdf, device=CPU), **kw)
    like(got, pd.pivot_table(pdf, **kw), check_names=True, check_column_type=False)
    like(ct.DataFrame.from_pandas(pdf, device=CPU).pivot_table(**kw),
         pdf.pivot_table(**kw), check_names=True, check_column_type=False)


def test_pivot_table_values_agree_with_reference():
    """The reference's values, once its reset index is taken back."""
    kw = dict(values="w", index="k", columns="c", aggfunc="sum")
    ref = cudf_tpu.pivot_table(_ref(), **kw).to_pandas().set_index("k")
    got = ct.pivot_table(_port(), **kw).to_pandas()
    got.columns.name = None
    like(got, ref, check_names=False, check_index_type=False, check_column_type=False)


def grid(got, exp):
    like(got, exp, check_names=True, check_column_type=False)


def test_pivot_crosstab_and_unstack_held_to_pandas():
    small = PDF.drop_duplicates(["k", "c"])
    port_small = ct.DataFrame.from_pandas(small, device=CPU)
    grid(port_small.pivot(index="k", columns="c", values="f"),
         small.pivot(index="k", columns="c", values="f"))
    grid(ct.crosstab(_port()["k"], _port()["c"]), pd.crosstab(PDF["k"], PDF["c"]))
    grid(ct.crosstab(_port()["k"], _port()["s"], values=_port()["f"], aggfunc="sum"),
         pd.crosstab(PDF["k"], PDF["s"], values=PDF["f"], aggfunc="sum"))
    unnamed = ct.crosstab(_port()["k"].rename(None), _port()["c"].rename(None))
    grid(unnamed, pd.crosstab(PDF["k"].rename(None), PDF["c"].rename(None)))
    grouped = _port().groupby(["k", "c"])["w"].sum()
    grid(grouped.unstack(), PDF.groupby(["k", "c"])["w"].sum().unstack())
    grid(grouped.unstack(0), PDF.groupby(["k", "c"])["w"].sum().unstack(0))
    frame = _port().groupby(["k", "c"]).agg({"w": "sum", "f": "max"})
    grid(frame.unstack(), PDF.groupby(["k", "c"]).agg({"w": "sum", "f": "max"}).unstack())
    with pytest.raises(ValueError, match="duplicate"):
        _port().pivot(index="k", columns="c", values="f")


def test_stack_and_transpose():
    """transpose of a numeric frame matches the reference and pandas;
    stack (a MultiIndex Series) is held to pandas (the reference resets
    it through pandas); mixed frames raise, naming their ROADMAP line."""
    num = ["v", "w", "f"]
    head = PDF[num].head(6)
    port = ct.DataFrame.from_pandas(head, device=CPU)
    like(port.T, head.T)
    like(port.transpose(), cudf_tpu.DataFrame.from_pandas(head).transpose())
    like(port.stack(), head.stack())
    like(port[["w"]].stack(), head[["w"]].stack())
    for fn in (lambda d: d.transpose(), lambda d: d.stack()):
        with pytest.raises(NotImplementedError, match="host pandas routes"):
            fn(_port()[["k", "s"]])
