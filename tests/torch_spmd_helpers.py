"""Frames, plans and the rank pools shared by tests/test_torch_spmd.py and
tests/test_torch_spmd_pandas.py."""

import numpy as np
import pandas as pd
import pytest

from cudf_tpu_torch.parallel.dryrun import RankPool
import torch_rank_tasks as tasks


RANKS = [2, 4]


def _frames():
    rng = np.random.default_rng(21)
    n = 4000
    f = {"q1": pd.DataFrame({"flag": rng.integers(0, 3, n),
                             "qty": rng.integers(1, 50, n).astype(np.int64),
                             "price": rng.uniform(1, 100, n).round(2)})}
    n_fact, n_dim = 4000, 256
    f["fact"] = pd.DataFrame({"suppkey": rng.integers(0, n_dim, n_fact),
                              "price": rng.integers(1, 1000, n_fact).astype(np.float64),
                              "qty": rng.integers(1, 50, n_fact)})
    f["dim"] = pd.DataFrame({"suppkey": np.arange(n_dim), "nation": rng.integers(0, 5, n_dim)})
    f["kv"] = pd.DataFrame({"k": rng.integers(0, 40, 3000), "v": rng.normal(size=3000)})
    names = np.array(["ar", "br", "cn", "de", "us"])
    f["countries"] = pd.DataFrame({"country": names[rng.integers(0, 5, 2000)],
                                   "v": rng.integers(0, 100, 2000).astype(np.int64)})
    f["semi"] = pd.DataFrame({"k": rng.integers(0, 500, 3000), "v": rng.integers(0, 9, 3000)})
    f["keep"] = pd.DataFrame({"k": np.arange(0, 500, 7)})
    f["cust"] = pd.DataFrame({"custkey": np.arange(300), "seg": rng.integers(0, 5, 300)})
    f["orders"] = pd.DataFrame({"o_custkey": rng.integers(0, 200, 1200),
                                "o_orderkey": np.arange(1200)})
    f["left"] = pd.DataFrame({"k": np.arange(50), "lv": np.arange(50) * 10})
    f["right"] = pd.DataFrame({"k": np.arange(0, 50, 2), "rv": np.arange(25).astype(np.float64)})
    f["fl"] = pd.DataFrame({"k": np.arange(0, 60, 2), "lv": np.arange(30)})
    f["fr"] = pd.DataFrame({"k": np.arange(0, 90, 3), "rv": np.arange(30) * 2})
    f["sortme"] = pd.DataFrame({"a": rng.integers(0, 8, 5000), "b": rng.normal(size=5000).round(2),
                                "c": rng.integers(0, 10**12, 5000), "v": np.arange(5000)})
    v = rng.normal(size=3000)
    f["nulls"] = pd.DataFrame({"k": rng.integers(0, 20, 3000),
                               "v": np.where(rng.random(3000) < 0.8, v, np.nan)})
    f["win"] = pd.DataFrame({"k": rng.integers(0, 50, 4000), "v": rng.normal(size=4000).round(3),
                             "w": rng.integers(0, 100, 4000)})
    f["fkl"] = pd.DataFrame({"x": rng.integers(0, 60, 800) * 0.5 - 7.25, "a": np.arange(800)})
    f["fkr"] = pd.DataFrame({"x": np.arange(-7.25, 22.75, 0.5), "b": np.arange(60) * 3})
    return f


FRAMES = _frames()


# held to pandas alone: the reference fails the first two; the last
# two are the reference's own tests' second shapes, left out of its
# compiles to keep this file under a minute
PANDAS_PLANS = ["float_key", "masked_probe", "q13_seg", "over_filter"]
SD = {"minmax"}


def pandas_answer(name):
    f = FRAMES
    if name == "float_key":
        return f["fkl"].merge(f["fkr"], on="x")
    if name == "q13_seg":
        joined = f["cust"].merge(f["orders"], left_on="custkey", right_on="o_custkey",
                                 how="left").drop(columns="o_custkey")
        return joined.groupby("seg")["o_orderkey"].agg(m="mean", s="sum").reset_index()
    if name == "over_filter":
        win = f["win"].assign(t=f["win"].groupby("k")["v"].transform("sum"))
        return win[win["v"] > win["t"] * 0.1]
    kv = f["kv"].assign(w=f["kv"]["v"].where(f["kv"]["v"] > 0))
    return kv.groupby("k").agg(s=("w", "sum"), n=("w", "count")).reset_index()


def norm(df, ordered=False):
    out = pd.DataFrame({c: (df[c].astype("float64") if pd.api.types.is_numeric_dtype(df[c])
                            or pd.api.types.is_bool_dtype(df[c])
                            else df[c].astype(object).where(df[c].notna(), None).astype(str))
                        for c in df.columns})
    if not ordered:
        out = out.sort_values(list(out.columns), kind="stable")
    return out.reset_index(drop=True)


def same(got, exp, name, ordered=False):
    rtol = 1e-9 if name in SD else 1e-12
    pd.testing.assert_frame_equal(norm(got, ordered), norm(exp, ordered), rtol=rtol,
                                  check_dtype=False)


@pytest.fixture(scope="module")
def pools():
    started = {n: RankPool(n) for n in RANKS}      # both start while the reference compiles
    yield started
    for p in started.values():
        p.close()


def run(pools, ranks, name, **kw):
    answers = pools[ranks].run(tasks.run_plan, name, FRAMES, kw.get("options", ()),
                               kw.get("spmd", True))
    first, _ = answers[0]
    for got, fallbacks in answers:
        assert fallbacks == 0
        pd.testing.assert_frame_equal(got, first)       # every rank the whole answer
    return first
