"""The port's pandas accelerator (``cudf_tpu_torch.pandas``) against the
reference's (``cudf_tpu.pandas``, JAX on the CPU) and plain pandas: the
same snippets of pandas code under each, their results compared as
pandas objects (integers, keys and strings exact, floats rtol 1e-12).
The port's proxy runs on the CPU with pandas as its slow side."""

import numpy as np
import pytest

from torch_pandas_helpers import plain, same, under


def _frame(pd):
    return pd.DataFrame({"k": [3, 1, 3, 2, 1, 3], "v": [1.5, -2.0, 3.25, np.nan, 5.0, -0.5],
                         "w": [10, 20, 30, 40, 50, 60],
                         "s": ["apple", "Banana", "cherry", "date", "elder", "fig"]})


def construction(pd, tmp):
    return pd.DataFrame({"a": [1, 2, 3], "b": [1.5, None, 3.0], "s": ["x", "y", "zz"]})


def series_construction(pd, tmp):
    return pd.Series([4.0, 5.5, None], index=[10, 20, 30], name="x")


def arithmetic(pd, tmp):
    df = _frame(pd)
    return pd.DataFrame({"a": (df.w * 2 + df.v) / 3, "b": df.w ** 2 - 1, "c": 1 - df.v,
                         "d": df.w // 7, "e": df.w % 7, "f": -df.v})


def filters(pd, tmp):
    df = _frame(pd)
    return df[(df.w > 15) & df.v.notna()]


def named_groupby_agg(pd, tmp):
    df = _frame(pd)
    return df.groupby("k").agg(total=("v", "sum"), n=("w", "count"), mean=("w", "mean"),
                               top=("w", "max"))


def merge(pd, tmp):
    a = _frame(pd)
    b = pd.DataFrame({"k": [1, 2, 4], "label": ["one", "two", "four"]})
    return pd.merge(a, b, on="k", how="left")


def merge_inner(pd, tmp):
    a = _frame(pd)
    b = pd.DataFrame({"k": [3, 1], "z": [0.25, 0.5]})
    return a.merge(b, on="k")


def concat(pd, tmp):
    df = _frame(pd)
    return pd.concat([df, df.head(2)], ignore_index=True)


def sort_values(pd, tmp):
    return _frame(pd).sort_values(["k", "w"], ascending=[True, False])


def loc_iloc_get(pd, tmp):
    df = _frame(pd)
    return (df.loc[df.w > 25, ["k", "w"]], df.iloc[1:4], df.w.iloc[[0, 2]],
            df.set_index("s").loc["cherry", "w"])


def loc_iloc_set(pd, tmp):
    df = _frame(pd)
    df.loc[df.w > 40, "v"] = 0.0
    s = df.w.copy()
    s.iloc[1] = 99
    df["w2"] = s
    return df


def inplace(pd, tmp):
    df = _frame(pd)
    df.fillna(0.0, inplace=True)
    df.sort_values("w", ascending=False, inplace=True)
    df.rename(columns={"w": "weight"}, inplace=True)
    return df


def str_accessor(pd, tmp):
    s = _frame(pd).s
    return pd.DataFrame({"upper": s.str.upper(), "len": s.str.len(),
                         "has_a": s.str.contains("a"), "head": s.str.slice(0, 3)})


def dt_accessor(pd, tmp):
    d = pd.Series(pd.to_datetime(["2024-01-31 10:00", "2023-07-04 23:59", "2020-02-29 00:00"]))
    return pd.DataFrame({"year": d.dt.year, "month": d.dt.month, "day": d.dt.day,
                         "hour": d.dt.hour, "dow": d.dt.dayofweek})


def read_csv(pd, tmp):
    path = tmp / "small.csv"
    path.write_text("k,v,s\n1,0.5,a\n2,1.25,bb\n1,,c\n3,4.0,dd\n")
    return pd.read_csv(str(path))


def read_parquet(pd, tmp):
    import pandas as real

    path = tmp / "small.parquet"
    real.DataFrame({"k": np.arange(6, dtype=np.int64) % 3, "v": np.linspace(0, 1, 6),
                    "s": list("abcdef")}).to_parquet(str(path))
    return pd.read_parquet(str(path))


def numpy_ufunc(pd, tmp):
    df = _frame(pd)
    return pd.DataFrame({"sqrt": np.sqrt(df.w), "log": np.log1p(df.v.abs())})


SNIPPETS = [construction, series_construction, arithmetic, filters, named_groupby_agg, merge,
            merge_inner, concat, sort_values, loc_iloc_get, loc_iloc_set, inplace,
            str_accessor, dt_accessor, read_csv, read_parquet, numpy_ufunc]


@pytest.mark.parametrize("snippet", SNIPPETS, ids=lambda f: f.__name__)
def test_snippets_give_the_references_and_pandas_results(snippet, tmp_path):
    results = {}
    for kind in ("pandas", "reference", "port"):
        with under(kind) as pd:
            results[kind] = snippet(pd, tmp_path)
            if kind == "port":
                fast = [r for r in (results[kind] if isinstance(results[kind], tuple)
                                    else (results[kind],)) if hasattr(r, "_fast")]
                assert all(r._fast is not None or r._slow is not None for r in fast)
            results[kind] = plain(results[kind])
    same(results["port"], results["pandas"], f"{snippet.__name__}: port vs pandas")
    same(results["port"], results["reference"], f"{snippet.__name__}: port vs reference",
         check_dtype=False)


def test_the_fast_side_is_the_ports_frame_on_the_device_given():
    import cudf_tpu_torch as ct

    with under("port") as pd:
        df = pd.DataFrame({"a": [1, 2, 3]})
        assert isinstance(df._fast, ct.DataFrame)
        assert df._fast.device.type == "cpu"
        assert isinstance(df, pd.DataFrame)
        out = df.sum()
        assert out["a"] == 6
