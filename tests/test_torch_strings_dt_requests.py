"""Every request of ``cudf_tpu_torch/models/strings_dt.py`` at a few
thousand rows on the CPU: its answer against its plain PyTorch version
(``PLAIN``, the card's check) and the port's result against the same
request written in pandas over the same frames (``to_pandas()``).

G1's columns as ``chip_smoke.py`` draws them, cut to 4000 rows (id3 over
4000 // 5 keys, so every prefix request has several groups), and TPC-H's
lineitem from ``models/tpch.py``'s generator at SF 0.0005.  Text, integers,
bools and ticks exact; sums rtol 1e-12 (``RTOL``).  Every request takes
the device route (``STRING_ROUTES["host"]`` unmoved).
"""

import numpy as np
import pandas as pd
import pytest
import torch

import cudf_tpu_torch as ct
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.models import strings_dt as sd
from cudf_tpu_torch.models import tpch
from cudf_tpu_torch.ops.strings import STRING_ROUTES

torch.set_num_threads(1)

CPU = torch.device("cpu")
N = 4000


@pytest.fixture(scope="module")
def frames():
    g = torch.Generator().manual_seed(7)
    df = ct.DataFrame({"v1": torch.randint(1, 6, (N,), generator=g, dtype=torch.int32),
                       "v3": torch.rand(N, generator=g, dtype=torch.float64) * 100})
    for name, k, width in (("id1", 100, 3), ("id3", N // 5, 10)):
        keys = Column.from_strings([f"id{i:0{width}d}" for i in range(1, k + 1)], device=CPU)
        df[name] = Column.from_dictionary(
            torch.randint(0, k, (N,), generator=g, dtype=torch.int32), keys)
    li = tpch.generate_device(0.0005, seed=7, device=CPU)["lineitem"]
    return sd.prepare({"g1": df, "lineitem": li})


def _pandas(frames):
    g1 = frames["g1"].to_pandas()
    li = frames["lineitem"].to_pandas()
    id3s = g1["id3"].astype(str)
    rev = li["l_extendedprice"] * (1 - li["l_discount"])
    ship = li["l_shipdate"]
    text = {
        "len": lambda s: s.str.len(),
        "slice_astype_int64": lambda s: s.str.slice(2).astype("int64"),
        "slice_to_numeric": lambda s: pd.to_numeric(s.str.slice(2)),
        "contains_00000": lambda s: s.str.contains("00000", regex=False),
        "contains_regex": lambda s: s.str.contains(r"^id0+[1-9]\d{2}$"),
        "startswith_id00000": lambda s: s.str.startswith("id00000"),
        "upper": lambda s: s.str.upper(),
        "replace_zeros": lambda s: s.str.replace(r"0+", "-", regex=True),
        "split_0000": lambda s: s.str.split("0000", n=1, expand=True),
    }
    out = {"id3_astype_str": lambda: id3s,
           "concat_id1_v1": lambda: g1["id1"].astype(str) + "_" + g1["v1"].astype(str),
           "groupby_prefix8": lambda: g1["v3"].groupby(id3s.str.slice(0, 8)).sum(),
           "groupby_prefix8_category": lambda: g1["v3"].groupby(
               id3s.str.slice(0, 8).astype("category")).sum(),
           "groupby_prefix10_category": lambda: g1["v3"].groupby(
               id3s.str.slice(0, 10).astype("category")).sum(),
           "cat_codes": lambda: g1["id1"].cat.codes,
           "cat_categories": lambda: pd.Series(g1["id1"].cat.categories),
           "dt_floor_D": lambda: ship.dt.floor("D"), "dt_ceil_h": lambda: ship.dt.ceil("h"),
           "strftime_ymd": lambda: ship.dt.strftime("%Y-%m-%d"),
           "to_datetime_ymd": lambda: pd.to_datetime(ship.dt.strftime("%Y-%m-%d")),
           "tz_new_york_hour": lambda: ship.dt.tz_localize("UTC").dt.tz_convert(
               sd.ZONE).dt.hour,
           "revenue_by_year": lambda: rev.groupby(ship.dt.year).sum(),
           "revenue_by_month_category": lambda: rev.groupby(
               ship.dt.strftime("%Y-%m").astype("category"), observed=True).sum()}
    for name, fn in text.items():
        out[name] = (lambda fn=fn: fn(id3s))
        out[f"dict_{name}"] = (lambda fn=fn: fn(g1["id3"]))
    for name in ("year", "month", "day", "dayofweek", "quarter", "dayofyear", "is_month_end"):
        out[f"dt_{name}"] = (lambda name=name: getattr(ship.dt, name))
    return out


def _same(got, exp, rtol):
    assert list(got) == list(exp)
    for k in exp:
        g, e = got[k], exp[k]
        assert g.dtype == e.dtype and g.shape == e.shape, k
        if g.is_floating_point():
            assert torch.allclose(g, e, rtol=rtol, atol=0), k
        else:
            assert torch.equal(g, e), k


@pytest.mark.parametrize("name", list(sd.REQUESTS))
def test_request_equals_plain_and_pandas(frames, name):
    before = STRING_ROUTES["host"]
    res = sd.REQUESTS[name](frames)
    assert STRING_ROUTES["host"] == before, "a request took the host route"
    _same(sd.ANSWERS[name](res, frames), sd.PLAIN[name](frames), sd.RTOL[name] or 1e-12)
    exp = _pandas(frames)[name]()
    got = res.to_pandas()
    if isinstance(exp, pd.DataFrame):
        got.columns = list(exp.columns)
        pd.testing.assert_frame_equal(got, exp, check_dtype=False)
        return
    if isinstance(got, pd.Index):
        got = pd.Series(got)
    if name.startswith(("groupby", "revenue")):
        assert got.index.astype(str).tolist() == exp.index.astype(str).tolist()
        np.testing.assert_allclose(got.to_numpy(), exp.to_numpy(), rtol=1e-12)
        return
    if name == "to_datetime_ymd":
        assert got.dtype == exp.dtype
    pd.testing.assert_series_equal(got.reset_index(drop=True), exp.reset_index(drop=True),
                                   check_dtype=False, check_names=False,
                                   check_categorical=False)


def test_groups_cover_every_request():
    names = [n for group in sd.GROUPS.values() for n in group]
    assert sorted(names) == sorted(sd.REQUESTS) and len(set(names)) == len(names)
    assert set(sd.NEEDS) == set(sd.REQUESTS) == set(sd.PLAIN) == set(sd.ANSWERS)
