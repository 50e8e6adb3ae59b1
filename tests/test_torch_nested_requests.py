"""Every request of ``cudf_tpu_torch/models/nested.py`` at a few thousand
rows on the CPU: its answer against its plain PyTorch version (``PLAIN``,
the card's check), and the port's result against the same request in
pandas over the same frames (lists, exploded rows, value counts, split
pieces and matches, and the decimal arithmetic as Python ``Decimal``s).

G1's columns as ``chip_smoke.py`` draws them, cut to 4000 rows, and
TPC-H's lineitem from ``models/tpch.py``'s generator at SF 0.0005.
Everything exact.  No request takes a host route.
"""

import decimal as D

import pytest
import torch

import cudf_tpu_torch as ct
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.models import nested
from cudf_tpu_torch.models import strings_dt as sd
from cudf_tpu_torch.models import tpch
from cudf_tpu_torch.ops._utils import HOST_ROUTES
from cudf_tpu_torch.ops.strings import STRING_ROUTES

torch.set_num_threads(1)

CPU = torch.device("cpu")
N = 4000


@pytest.fixture(scope="module")
def frames():
    g = torch.Generator().manual_seed(11)

    def ints(lo, hi):
        return torch.randint(lo, hi + 1, (N,), generator=g, dtype=torch.int32)

    df = ct.DataFrame({"id4": ints(1, 100), "id6": ints(1, N // 10), "v1": ints(1, 5),
                       "v2": ints(1, 15),
                       "v3": torch.rand(N, generator=g, dtype=torch.float64) * 100})
    for name, k, width in (("id1", 100, 3), ("id3", N // 5, 10)):
        keys = Column.from_strings([f"id{i:0{width}d}" for i in range(1, k + 1)], device=CPU)
        df[name] = Column.from_dictionary(
            torch.randint(0, k, (N,), generator=g, dtype=torch.int32), keys)
    li = tpch.generate_device(0.0005, seed=11, device=CPU)["lineitem"]
    return sd.prepare({"g1": df, "lineitem": li})


@pytest.mark.parametrize("name", list(nested.REQUESTS))
def test_request_equals_its_plain_version(frames, name):
    before, host = dict(STRING_ROUTES), dict(HOST_ROUTES)
    got = nested.ANSWERS[name](nested.REQUESTS[name](frames), frames)
    assert STRING_ROUTES["host"] == before["host"] and HOST_ROUTES == host
    exp = nested.PLAIN[name](frames)
    assert sorted(got) == sorted(exp)
    for key in exp:
        assert got[key].dtype == exp[key].dtype, key
        assert torch.equal(got[key], exp[key]), key


def _cents(frames, name):
    return [D.Decimal(round(v * 100)).scaleb(-2)
            for v in frames["lineitem"][name].to_pandas().tolist()]


def test_requests_match_pandas(frames):
    g1 = frames["g1"].to_pandas()
    id3s = g1["id3"].astype(str)
    r = nested.REQUESTS
    assert r["agg_list_id1"](frames).to_pandas().tolist() == \
        g1.groupby("id1", observed=True)["v1"].agg(list).tolist()
    sets = g1.groupby("id4")["v2"].agg(lambda s: sorted(set(s)))
    assert r["collect_set_id4"](frames).to_pandas().tolist() == sets.tolist()
    assert r["collect_set_len"](frames).to_pandas().tolist() == sets.map(len).tolist()
    counts = g1.groupby(["id4", "v1"]).size()
    got = r["histogram_counts"](frames).to_pandas()
    assert got.tolist() == counts.tolist()
    assert got.index.tolist() == counts.index.get_level_values(0).tolist()
    q8 = g1[["id6", "v3"]].sort_values("v3", ascending=False).groupby("id6").head(2)
    top = r["topk2_id6"](frames).to_pandas()
    assert sorted(zip(top.index, top)) == sorted(zip(q8["id6"], q8["v3"]))
    pieces = id3s.str.split("d")
    assert r["split_len"](frames).to_pandas().tolist() == pieces.map(len).tolist()
    assert r["split_last"](frames).to_pandas().tolist() == pieces.str[-1].tolist()
    found = id3s.str.findall(r"[1-9]+")
    assert r["findall_len"](frames).to_pandas().tolist() == found.map(len).tolist()
    assert r["findall_last"](frames).to_pandas().tolist() == found.str[-1].tolist()
    price, disc, tax = (_cents(frames, c) for c in ("l_extendedprice", "l_discount", "l_tax"))
    assert r["money_cast"](frames).to_pandas().tolist() == price
    ctx = D.Context(prec=40)
    disc_price = [ctx.multiply(p, 1 - d) for p, d in zip(price, disc)]
    assert r["q1_disc_price"](frames).to_pandas().tolist() == disc_price
    assert r["q1_charge"](frames).to_pandas().tolist() == \
        [ctx.multiply(dp, 1 + t) for dp, t in zip(disc_price, tax)]
    qty = frames["lineitem"]["l_quantity"].to_pandas()
    assert r["q6_mask"](frames).to_pandas().tolist() == \
        [D.Decimal("0.05") <= d <= D.Decimal("0.07") and q < 24 for d, q in zip(disc, qty)]


def test_decimal128_product_passes_int64(frames):
    charge = nested.REQUESTS["q1_charge"](frames)
    a, b, prod = nested.decimal128_product(charge, 500)
    from cudf_tpu_torch.ops import decimal128 as d128

    exact = [x * y for x, y in zip(d128.to_ints128(a), d128.to_ints128(b))]
    assert d128.to_ints128(prod) == exact
    assert max(abs(v) for v in exact) >= 2 ** 63
    assert prod.dtype.scale == -12
