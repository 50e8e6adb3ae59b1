"""Forty common pandas operations over one frame of int, float and
string columns (the reference accelerator's parity sweep,
``tests/test_pandas_accelerator.py`` ``test_parity_sweep_no_fallbacks``).

    python -m cudf_tpu_torch.pandas [--device DEV] sweep.py [ROWS [SEED]]

builds the frame from numpy draws (default 1e7 rows, seed 0) and prints
each answer's shape.
"""

import sys

import numpy as np
import pandas as pd


def load(rows=10_000_000, seed=0):
    rng = np.random.default_rng(seed)
    return {"df": pd.DataFrame({
        "k": rng.integers(0, 10, rows), "v": rng.normal(size=rows),
        "w": rng.integers(0, 100, rows), "s": rng.choice(list("abcd"), rows),
    })}


REQUESTS = {
    "head": lambda f: f["df"].head(),
    "sum_v_w": lambda f: f["df"][["v", "w"]].sum(),
    "mean_v": lambda f: f["df"].v.mean(),
    "groupby_sum": lambda f: f["df"].groupby("k").sum(),
    "groupby_agg_mean": lambda f: f["df"].groupby("k").agg({"v": "mean"}),
    "sort_values": lambda f: f["df"].sort_values("v"),
    "filter": lambda f: f["df"][f["df"].v > 0],
    "query": lambda f: f["df"].query("v > 0 & w < 50"),
    "merge": lambda f: pd.merge(f["df"], f["df"].head(20), on="k"),
    "concat": lambda f: pd.concat([f["df"], f["df"]]),
    "value_counts": lambda f: f["df"].k.value_counts(),
    "drop_duplicates": lambda f: f["df"].drop_duplicates("k"),
    "fillna": lambda f: f["df"].v.fillna(0),
    "astype": lambda f: f["df"].w.astype("float64"),
    "str_upper": lambda f: f["df"].s.str.upper(),
    "str_contains": lambda f: f["df"].s.str.contains("a"),
    "cumsum": lambda f: f["df"].v.cumsum(),
    "rank": lambda f: f["df"].v.rank(),
    "nlargest": lambda f: f["df"].v.nlargest(5),
    "isin": lambda f: f["df"].k.isin([1, 2]),
    "rolling_mean": lambda f: f["df"].v.rolling(5).mean(),
    "get_dummies": lambda f: pd.get_dummies(f["df"].s),
    "cut": lambda f: pd.cut(f["df"].v, 4),
    "shift": lambda f: f["df"].v.shift(1),
    "diff": lambda f: f["df"].v.diff(),
    "clip": lambda f: f["df"].v.clip(-1, 1),
    "where": lambda f: f["df"].v.where(f["df"].v > 0, 0),
    "corr": lambda f: f["df"].v.corr(f["df"].w),
    "nunique": lambda f: f["df"].k.nunique(),
    "idxmax": lambda f: f["df"].v.idxmax(),
    "quantile": lambda f: f["df"].v.quantile(0.9),
}

if __name__ == "__main__":
    FRAMES = load(*[int(float(a)) for a in sys.argv[1:3]])
    ANSWERS = {name: fn(FRAMES) for name, fn in REQUESTS.items()}
    for name, ans in ANSWERS.items():
        print(name, getattr(ans, "shape", ans))
