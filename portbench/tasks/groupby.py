"""db-benchmark's groupby task: the questions that take the port's sort
tier (q2, q6, q8, q9, q10), in the form of its pandas solution
(``pandas/groupby-pandas.py``), frozen copies of
``cudf_tpu_torch/models/g1.py``, written against the port's public
``DataFrame`` API.  Each takes {frame name: DataFrame} and returns the
question's answer.

q9's solution builds a pandas Series inside ``apply``; here it selects
the (v1, v2) cell of each group of the grouped ``corr``, r2 = corr ** 2.
"""

from __future__ import annotations

FORM = dict(as_index=False, sort=False, observed=True, dropna=False)


def q2(f):
    """sum v1 by id1:id2"""
    return f["x"].groupby(["id1", "id2"], **FORM).agg({"v1": "sum"})


def q6(f):
    """median v3 sd v3 by id4 id5"""
    return f["x"].groupby(["id4", "id5"], **FORM).agg({"v3": ["median", "std"]})


def q8(f):
    """largest two v3 by id6"""
    x = f["x"]
    return (x[~x["v3"].isna()][["id6", "v3"]].sort_values("v3", ascending=False)
            .groupby("id6", **FORM).head(2))


def q9(f):
    """regression v1 v2 by id2 id4: r2, the square of corr(v1, v2), a group"""
    c = f["x"][["id2", "id4", "v1", "v2"]].groupby(["id2", "id4"], **FORM)[["v1", "v2"]].corr()
    return c["v2"].iloc[0::2] ** 2


def q10(f):
    """sum v3 count by id1:id6"""
    return f["x"].groupby(["id1", "id2", "id3", "id4", "id5", "id6"], **FORM).agg(
        {"v3": "sum", "v1": "size"})


QUESTIONS = {"q2": q2, "q6": q6, "q8": q8, "q9": q9, "q10": q10}

# the columns each question reads, once each
INPUTS = {
    "q2": {"x": ["id1", "id2", "v1"]}, "q6": {"x": ["id4", "id5", "v3"]},
    "q8": {"x": ["id6", "v3"]}, "q9": {"x": ["id2", "id4", "v1", "v2"]},
    "q10": {"x": ["id1", "id2", "id3", "id4", "id5", "id6", "v3"]},
}

# leading index levels that belong to an answer (q8's row labels; q9's
# group keys)
ANSWER_INDEX = {"q8": 1, "q9": 2}

# bytes of one row of each answer as it must be written: keys at their
# input width, integer sums and counts in 8 bytes, float results in 8;
# q8's rows carry their int64 row labels
RESULT_ROW_BYTES = {"q2": 4 + 4 + 8, "q6": 4 + 4 + 2 * 8, "q8": 8 + 4 + 8, "q9": 4 + 4 + 8,
                    "q10": 6 * 4 + 8 + 8}

# each number the check compares, with its limit (PERF.md gives the
# readings each was set from): ``mismatch`` counts rows whose keys,
# labels, counts or integer results differ, a float column's ``gap`` is
# its largest difference over its largest magnitude
LIMITS = {
    "q2.mismatch": 0, "q6.mismatch": 0, "q6.v3_median.gap": 1e-10, "q6.v3_std.gap": 1e-8,
    "q8.mismatch": 0, "q8.v3.gap": 0.0, "q9.mismatch": 0, "q9.value.gap": 1e-7,
    "q10.mismatch": 0, "q10.v3.gap": 1e-10,
}


def least_bytes(q: str, data, result_rows: int) -> int:
    """Bytes the question must move at least: each input column read
    once, the answer written once."""
    widths = data.config["column_bytes"]
    read = sum(data.rows(frame) * widths[frame][c]
               for frame, cols in INPUTS[q].items() for c in cols)
    return read + result_rows * RESULT_ROW_BYTES[q]
