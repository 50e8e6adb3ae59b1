"""The ten questions of h2oai db-benchmark's groupby task (data
``G1_<n>_1e2_0_0`` of ``groupby-datagen.R``: id1, id2 over "id001" ..
"id100" and id3 over "id0000000001" .. as categories, id4, id5 in
1..100, id6 in 1..n/100, v1 in 1..5, v2 in 1..15, v3 uniform in
[0, 100)), in the form of its pandas solution (``pandas/groupby-pandas.py``):
``groupby(..., as_index=False, sort=False, observed=True, dropna=False)``.

Each function takes a frame and runs on the port's ``DataFrame`` (its
pandas API) as it runs on pandas, so the same code is held to pandas on
the CPU and drives the card.  q9's solution builds a pandas Series inside
``apply``; here it selects the (v1, v2) cell of each group of the grouped
``corr`` (rows come group by group, v1 then v2), and ``q9_apply`` is its
``apply`` form in the port's own terms (a host loop over the groups).
"""

from __future__ import annotations

FORM = dict(as_index=False, sort=False, observed=True, dropna=False)


def q1(x):
    """sum v1 by id1"""
    return x.groupby("id1", **FORM).agg({"v1": "sum"})


def q2(x):
    """sum v1 by id1:id2"""
    return x.groupby(["id1", "id2"], **FORM).agg({"v1": "sum"})


def q3(x):
    """sum v1 mean v3 by id3"""
    return x.groupby("id3", **FORM).agg({"v1": "sum", "v3": "mean"})


def q4(x):
    """mean v1:v3 by id4"""
    return x.groupby("id4", **FORM).agg({"v1": "mean", "v2": "mean", "v3": "mean"})


def q5(x):
    """sum v1:v3 by id6"""
    return x.groupby("id6", **FORM).agg({"v1": "sum", "v2": "sum", "v3": "sum"})


def q6(x):
    """median v3 sd v3 by id4 id5"""
    return x.groupby(["id4", "id5"], **FORM).agg({"v3": ["median", "std"]})


def q7(x):
    """max v1 - min v2 by id3"""
    return (x.groupby("id3", **FORM).agg({"v1": "max", "v2": "min"})
            .assign(range_v1_v2=lambda t: t["v1"] - t["v2"])[["id3", "range_v1_v2"]])


def q8(x):
    """largest two v3 by id6"""
    return (x[~x["v3"].isna()][["id6", "v3"]].sort_values("v3", ascending=False)
            .groupby("id6", **FORM).head(2))


def q9(x):
    """regression v1 v2 by id2 id4: r2, the square of corr(v1, v2), a group"""
    c = x[["id2", "id4", "v1", "v2"]].groupby(["id2", "id4"], **FORM)[["v1", "v2"]].corr()
    return c["v2"].iloc[0::2] ** 2


def q9_apply(x):
    """q9 as a host loop over the groups: r2 a group, as a frame of the
    keys and the value (column 0 in the port, None in pandas)."""
    return x[["id2", "id4", "v1", "v2"]].groupby(["id2", "id4"], **FORM).apply(
        lambda g: g["v1"].corr(g["v2"]) ** 2)


def q10(x):
    """sum v3 count by id1:id6"""
    return x.groupby(["id1", "id2", "id3", "id4", "id5", "id6"], **FORM).agg(
        {"v3": "sum", "v1": "size"})


QUESTIONS = {"q1": q1, "q2": q2, "q3": q3, "q4": q4, "q5": q5, "q6": q6, "q7": q7,
             "q8": q8, "q9": q9, "q10": q10}
