"""db-benchmark's join task: its five questions in the form of its pandas
solution (``pandas/join-pandas.py``), written against the port's public
``DataFrame`` API.  Each takes {frame name: DataFrame} and returns the
merged frame with every column of both sides carried, as pandas gives
it (the key once, other shared names suffixed ``_x`` and ``_y``).
"""

from __future__ import annotations

from portbench.reference.join import JOINS


def q1(f):
    """small inner on int"""
    return f["x"].merge(f["small"], on="id1")


def q2(f):
    """medium inner on int"""
    return f["x"].merge(f["medium"], on="id2")


def q3(f):
    """medium outer on int"""
    return f["x"].merge(f["medium"], how="left", on="id2")


def q4(f):
    """medium inner on factor"""
    return f["x"].merge(f["medium"], on="id5")


def q5(f):
    """big inner on int"""
    return f["x"].merge(f["big"], on="id3")


QUESTIONS = {"q1": q1, "q2": q2, "q3": q3, "q4": q4, "q5": q5}

# the frames each question reads, every column of each
INPUTS = {q: ("x", right) for q, (right, _, _) in JOINS.items()}

# each number the check compares, with its limit (PERF.md gives the
# readings each was set from): ``mismatch`` counts rows whose keys or
# carried integer and category columns differ, or whose nulls differ; a
# float column's ``gap`` is its largest difference over its largest
# magnitude; the carried floats are copied, so every limit is 0
LIMITS = {f"{q}.{n}": 0 for q in QUESTIONS for n in ("mismatch", "v1.gap", "v2.gap")}


def least_bytes(q: str, data, result_rows: int) -> int:
    """Bytes the question must move at least: every column of both sides
    read once, each answer row written once (the right key dropped)."""
    right, on, _ = JOINS[q]
    widths = data.config["column_bytes"]
    row = {f: sum(widths[f].values()) for f in ("x", right)}
    read = data.rows("x") * row["x"] + data.rows(right) * row[right]
    return read + result_rows * (row["x"] + row[right] - widths[right][on])
