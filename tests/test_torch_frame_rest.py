"""The rest of the port's Series/DataFrame API: ``join``,
``combine_first``, ``update``, ``interpolate``, ``rename`` of labels,
``dropna(axis=1)``, ``quantile`` of a list, ``agg(axis=1)`` and the row
reductions, a frame with a Series broadcast over its columns, and
``describe`` of strings, against the reference and pandas on the same
seeded inputs.

Held to pandas where the reference is at fault, and said so:
``join(on=...)`` (the reference resets the index and suffixes the key and
a column only one side holds: ``k_x``, ``w_x``), ``agg(func, axis=1)``
(the reference ignores ``axis``), ``update`` with a NaN in a Series built
from numpy (the reference writes it).  Values exact, floats rtol 1e-12.
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
N = 24


def _pdf():
    rng = np.random.default_rng(29)
    v = rng.normal(0, 1, N).round(3)
    v[[0, 4, 5, 13, N - 1]] = np.nan
    f = rng.normal(0, 1, N).round(3)
    f[[2, 9]] = np.nan
    return pd.DataFrame({"k": rng.integers(1, 6, N), "v": v, "f": f,
                         "w": rng.integers(-9, 10, N).astype(np.int32),
                         "s": rng.choice(["a", "bb", "c"], N)},
                        index=pd.Index(rng.permutation(N) * 3, name="r"))


PDF = _pdf()
DIM = pd.DataFrame({"t": [10.5, 20.5, 40.5], "w": [1, 2, 4]}, index=pd.Index([1, 2, 4],
                                                                             name="k"))


def port(pdf=PDF):
    return ct.DataFrame.from_pandas(pdf, device=CPU)


def ref(pdf=PDF):
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


@pytest.mark.parametrize("how", ["left", "inner", "outer", "right"])
def test_join_on_a_column_held_to_pandas(how):
    """The left frame's index labels kept (null where a row has no left
    side), left-row order (right-row order for ``right``, sorted by the key
    for ``outer``), ``lsuffix``/``rsuffix`` on the columns both hold."""
    got = port().join(ct.DataFrame.from_pandas(DIM, device=CPU), on="k", how=how,
                      lsuffix="_l", rsuffix="_r")
    exp = PDF.join(DIM, on="k", how=how, lsuffix="_l", rsuffix="_r")
    like(got, exp, check_dtype=False, check_index_type=False)
    with pytest.raises(ValueError, match="overlap"):
        port().join(ct.DataFrame.from_pandas(DIM, device=CPU), on="k")


@pytest.mark.parametrize("how", ["left", "inner", "outer", "right"])
def test_join_on_the_index_matches_pandas(how):
    left = PDF[["v", "s"]].set_axis(PDF["k"].to_numpy() * 1, axis=0).iloc[:8]
    left = left[~left.index.duplicated()]
    got = ct.DataFrame.from_pandas(left, device=CPU).join(
        ct.DataFrame.from_pandas(DIM[["t"]], device=CPU), how=how)
    like(got, left.join(DIM[["t"]], how=how), check_dtype=False, check_index_type=False)
    series = ct.Series([1.5, 2.5], index=[2, 3], name="z", device=CPU)
    like(ct.DataFrame.from_pandas(left, device=CPU).join(series),
         left.join(pd.Series([1.5, 2.5], index=[2, 3], name="z")), check_index_type=False)


def test_join_on_the_index_matches_reference():
    left = PDF[["v"]].set_axis(np.arange(N) % 7, axis=0).iloc[:7]
    got = ct.DataFrame.from_pandas(left, device=CPU).join(
        ct.DataFrame.from_pandas(DIM[["t"]], device=CPU), how="inner")
    exp = cudf_tpu.DataFrame.from_pandas(left).join(
        cudf_tpu.DataFrame.from_pandas(DIM[["t"]]), how="inner")
    like(got, exp, check_names=False)


def test_combine_first_and_update():
    """combine_first aligned by label, as the reference and pandas
    (differing indexes meet over the sorted union); update in place with
    the other's non-missing values at the labels self has."""
    a, b = PDF["v"], PDF["f"]
    like(port()["v"].combine_first(port()["f"]), a.combine_first(b))
    like(port()["v"].combine_first(port()["f"]), ref()["v"].combine_first(ref()["f"]))
    shifted = b.iloc[3:15]
    like(port()["v"].combine_first(ct.Series(shifted.to_numpy(), index=shifted.index,
                                             name="f", device=CPU)), a.combine_first(shifted))
    x, y = PDF[["v", "f"]].iloc[:12], PDF[["v", "w"]].iloc[6:].astype({"w": "float64"})
    like(port(x).combine_first(port(y)), x.combine_first(y))
    like(port(x).combine_first(port(x[["f"]] * 2)), x.combine_first(x[["f"]] * 2))
    like(port(x).combine_first(port(x[["f"]] * 2)), ref(x).combine_first(ref(x[["f"]] * 2)))
    for other in (pd.Series([100.0, np.nan, 7.0], index=[PDF.index[2], PDF.index[3], -1]),
                  PDF["f"]):
        got, exp, r = port()["v"], PDF["v"].copy(), ref()["v"]
        got.update(ct.Series(other.to_numpy(), index=list(other.index), device=CPU))
        exp.update(other)
        # the reference writes a NaN of a Series built from numpy (held to
        # pandas, which skips it): it gets the other's values without them
        kept = other.dropna()
        r.update(cudf_tpu.Series(kept.to_numpy(), index=cudf_tpu.Index(list(kept.index))))
        like(got, exp, check_names=False, check_index_type=False)
        like(got, r, check_names=False, check_index_type=False)


@pytest.mark.parametrize("values", [[1.0, np.nan, 3.0, np.nan], [np.nan, 1.0, np.nan, 3.0],
                                    [np.nan, np.nan, 2.0, np.nan, np.nan, 8.0, 1.0, np.nan]])
def test_interpolate_matches_reference_and_pandas(values):
    """Leading missing values stay missing, trailing ones take the last
    valid value, the rest lie on the line between their neighbours."""
    s = pd.Series(values)
    got = ct.Series(s, device=CPU).interpolate()
    like(got, s.interpolate())
    like(got, cudf_tpu.Series(s).interpolate())
    like(port()["v"].interpolate(), PDF["v"].interpolate())
    with pytest.raises(NotImplementedError, match="linear only"):
        port()["v"].interpolate(method="spline")


def test_rename_of_labels():
    mapper = {PDF.index[0]: -1, PDF.index[3]: -2}
    like(port()["v"].rename(mapper), PDF["v"].rename(mapper))
    like(port()["v"].rename(lambda x: x * 10), ref()["v"].rename(lambda x: x * 10))
    like(port().rename(index=mapper), PDF.rename(index=mapper))
    like(port().rename(index=mapper, columns={"v": "V"}),
         ref().rename(index=mapper, columns={"v": "V"}))
    multi = PDF.set_index(["k", "s"])
    like(ct.DataFrame.from_pandas(multi, device=CPU).rename(index={1: 100, "a": "A"}),
         multi.rename(index={1: 100, "a": "A"}))


def test_dropna_columns_and_quantiles():
    for kw in ({}, {"how": "all"}, {"thresh": N - 3}, {"subset": list(PDF.index[6:9])}):
        like(port().dropna(axis=1, **kw), PDF.dropna(axis=1, **kw))
    all_missing = PDF.assign(z=np.nan)
    like(port(all_missing).dropna(axis=1, how="all"), all_missing.dropna(axis=1, how="all"))
    qs = [0.25, 0.5, 0.75]
    num = ["k", "v", "f", "w"]
    like(port()[num].quantile(qs), PDF[num].quantile(qs))
    like(port()[num].quantile(qs), ref()[num].quantile(qs), check_index_type=False)


ROW_FUNCS = ["sum", "prod", "mean", "min", "max", "std", "var", "median", "count", "any",
             "all", "sem"]


@pytest.mark.parametrize("name", ROW_FUNCS)
def test_row_reductions_held_to_pandas(name):
    """``agg(name, axis=1)`` and ``name(axis=1)`` reduce each row, missing
    values skipped (the reference's ``agg`` ignores ``axis``); an integer
    frame without nulls keeps integer sums, products and extremes."""
    mixed, ints = PDF[["v", "f", "w"]], PDF[["k", "w"]]
    like(port(mixed).agg(name, axis=1), mixed.agg(name, axis=1), check_names=False)
    like(getattr(port(ints), name)(axis=1), getattr(ints, name)(axis=1), check_names=False)


def test_agg_list_on_rows_and_beyond():
    like(port()[["v", "w"]].agg(["max", "sum"], axis=1), PDF[["v", "w"]].agg(["max", "sum"],
                                                                              axis=1))
    with pytest.raises(NotImplementedError, match="beyond the reference"):
        port()[["v", "w"]].skew(axis=1)


def test_frame_with_a_series_broadcast():
    """The Series' labels meet the column names (the sorted union where
    they differ: a name on one side only is missing)."""
    num = ["v", "f", "w"]
    means = PDF[num].mean()
    like(port()[num] - port()[num].mean(), PDF[num] - means)
    like(port()[num] - port()[num].mean(), ref()[num] - ref()[num].mean())
    other = pd.Series([1.0, 2.0, 3.0], index=["w", "v", "zz"])
    like(port()[num] * ct.Series([1.0, 2.0, 3.0], index=["w", "v", "zz"], device=CPU),
         PDF[num] * other)
    like(port()[num] > ct.Series([0.0, 0.5, 1.0], index=num, device=CPU),
         PDF[num] > pd.Series([0.0, 0.5, 1.0], index=num))


def test_describe_of_strings_and_bools():
    """count, unique, top and freq, as pandas gives them (here as text:
    the port has no column of mixed types); the reference's agree but for
    the top of two values tied at the top count (it takes another)."""
    got = port()["s"].describe().to_pandas()
    assert got.tolist() == [str(v) for v in PDF["s"].describe().tolist()]
    theirs = ref()["s"].describe().to_pandas().astype(str).tolist()
    assert [got.tolist()[i] for i in (0, 1, 3)] == [theirs[i] for i in (0, 1, 3)]
    assert got.index.tolist() == ["count", "unique", "top", "freq"]
    flags = PDF["w"] > 0
    assert ct.Series(flags, device=CPU).describe().tolist() == [
        str(v) for v in flags.describe().tolist()]


def test_beyond_the_reference_raises_naming_its_line():
    """What the reference lacks too raises NotImplementedError naming
    ROADMAP.md's "beyond the reference" line: DataFrame.map, applymap,
    interpolate and update, whole-row loc/iloc setitem, a join on a
    MultiIndex of several levels, a merge of an index with columns, and
    the groupby idxmin and ewm over a MultiIndex (the reference gives
    positions for the one and raises TypeError for the other)."""
    df = port()
    multi = ct.DataFrame.from_pandas(PDF.set_index(["k", "s"]), device=CPU)
    cases = [lambda: df.map(abs), lambda: df.applymap(abs), lambda: df.interpolate(),
             lambda: df.update(df), lambda: df.loc.__setitem__(PDF.index[0], 1.0),
             lambda: df.iloc.__setitem__(0, 1.0),
             lambda: multi.join(multi[["v"]], rsuffix="_r"),
             lambda: df.merge(ct.DataFrame.from_pandas(DIM, device=CPU), left_on="k",
                              right_index=True),
             lambda: multi.groupby("w")[["v"]].idxmin(),
             lambda: multi.groupby("w")["v"].ewm(alpha=0.5).mean()]
    for fn in cases:
        with pytest.raises(NotImplementedError, match="beyond the reference"):
            fn()


def test_series_of_a_pandas_series_keeps_its_labels_and_name():
    """``Series(pandas_series, device=...)`` keeps the pandas Series'
    index and name, as pandas' constructor does (a port fault repaired
    here: the labels became a RangeIndex and the name None)."""
    s = PDF["v"].iloc[3:9]
    got = ct.Series(s, device=CPU)
    like(got, s)
    assert got.name == "v" and got.index.name == "r"
    assert ct.Series(s, name="z", device=CPU).name == "z"
    assert ct.Series(s, index=list(range(6)), device=CPU).index.to_pylist() == list(range(6))
