"""Inputs and comparisons shared by the accessor tests
(tests/test_torch_accessors.py, test_torch_str_pandas.py,
test_torch_dt_pandas.py)."""

import numpy as np
import pandas as pd
import torch

import cudf_tpu_torch as ct


CPU = torch.device("cpu")
N = 60
WORDS = ["apple", "Banana split", "", "cherry", "ñandú", "id0000000123", "a1b2", "  x  ",
         "DATE 2020-01-05", "añb"]


def _text():
    rng = np.random.default_rng(3)
    vals = [str(v) for v in rng.choice(WORDS, N)]
    for i in rng.choice(N, N // 10, replace=False):
        vals[i] = None
    return pd.Series(vals, name="t")


TEXT = _text()


def ours(s):
    return ct.Series(s, device=CPU)


def same(got, exp):
    got = got.to_pandas() if hasattr(got, "to_pandas") else got
    if isinstance(exp, pd.DataFrame):
        got.columns = list(exp.columns)
        pd.testing.assert_frame_equal(got, exp, check_dtype=False)
    else:
        pd.testing.assert_series_equal(got, exp, check_dtype=False, check_names=False)


STR_CALLS = {
    "len": lambda s: s.str.len(),
    "upper": lambda s: s.str.upper(),
    "title": lambda s: s.str.title(),
    "strip": lambda s: s.str.strip(),
    "slice": lambda s: s.str.slice(1, 4),
    "getitem": lambda s: s.str[::2],
    "get_past_end": lambda s: s.str.get(6),
    "contains_literal": lambda s: s.str.contains("an", regex=False),
    "contains_regex": lambda s: s.str.contains(r"a.b|\d{4}"),
    "contains_case": lambda s: s.str.contains("APPLE", case=False),
    "match": lambda s: s.str.match(r"[a-c]"),
    "fullmatch": lambda s: s.str.fullmatch(r".{5}"),
    "startswith": lambda s: s.str.startswith(("a", "B")),
    "endswith_na": lambda s: s.str.endswith("y", na=True),
    "find": lambda s: s.str.find("a", 1),
    "rfind": lambda s: s.str.rfind("a"),
    "count": lambda s: s.str.count(r"[aeiou]"),
    "replace_regex": lambda s: s.str.replace(r"\d+", "#", regex=True),
    "replace_literal": lambda s: s.str.replace("a", "AA", n=1),
    "extract": lambda s: s.str.extract(r"(\d+)", expand=False),
    "split_expand": lambda s: s.str.split(" ", n=1, expand=True),
    "pad": lambda s: s.str.pad(8, fillchar="*"),
    "center": lambda s: s.str.center(9),
    "zfill": lambda s: s.str.zfill(7),
    "repeat": lambda s: s.str.repeat(2),
    "isalpha": lambda s: s.str.isalpha(),
    "isdigit": lambda s: s.str.isdigit(),
    "islower": lambda s: s.str.islower(),
    "removeprefix": lambda s: s.str.removeprefix("ap"),
    "removesuffix": lambda s: s.str.removesuffix("ú"),
    "cat_sep": lambda s: s.str.cat(s, sep="|"),
}


DT = pd.Series(pd.to_datetime(["2020-02-29 13:45:10.5", None, "1999-12-31 23:59:59",
                               "2024-03-10 07:30:00"], format="ISO8601").astype("datetime64[ns]"), name="d")


DT_CALLS = {
    **{f: (lambda s, f=f: getattr(s.dt, f)) for f in (
        "year", "month", "day", "hour", "minute", "second", "microsecond", "nanosecond",
        "dayofweek", "day_of_week", "dayofyear", "quarter", "days_in_month", "is_leap_year",
        "is_month_start", "is_month_end")},
    "floor": lambda s: s.dt.floor("h"),
    "ceil": lambda s: s.dt.ceil("D"),
    "round": lambda s: s.dt.round("15min"),
    "strftime": lambda s: s.dt.strftime("%Y/%m/%d %H"),
    "tz": lambda s: s.dt.tz_localize("UTC").dt.tz_convert("America/New_York"),
    "tz_hour": lambda s: s.dt.tz_localize("UTC").dt.tz_convert("Asia/Kolkata").dt.hour,
    "tz_floor": lambda s: s.dt.tz_localize("UTC").dt.tz_convert("America/New_York")
    .dt.floor("D"),
    "as_unit": lambda s: s.dt.as_unit("ms"),
}
