"""TPC-H tables and queries q1, q6, q12 and q14 on the port's LazyFrame
engine (the port's counterpart of ``benchmarks/tpch.py``).

The tables follow the TPC-H schema with its cardinality ratios: scale
factor 1 is 6e6 lineitem rows, 1.5e6 orders and 2e5 parts.  Like the
reference's, the generator is synthetic (uniform draws), not the audited
dbgen.

- ``generate(scale, seed, device)`` draws the reference ``generate``'s
  numpy arrays with one ``default_rng(seed)`` in the same call order, so
  one seed gives the reference's tables; its string columns become
  dictionary columns over their sorted distinct values.
- ``generate_device(scale, seed, device)`` draws on the device from one
  ``torch.Generator`` (no bulk copy from the host) in the reference
  ``generate_device``'s layouts: int32 keys, dictionary codes over keys
  from a small host set, ``datetime64[ns]`` dates.
- ``q1``, ``q6``, ``q12`` and ``q14`` are the reference's plans.
- ``pandas_reference`` is the reference's pandas version of those four.
- ``plain_q1`` ... ``plain_q14`` compute the same answers in plain
  PyTorch over the tables' tensors, apart from the engine.
"""

from __future__ import annotations

import numpy as np
import torch

from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.engine import col, from_dataframe, lit, when
from cudf_tpu_torch.frame.dataframe import DataFrame

_REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
_SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
_FLAGS = ["A", "N", "R"]
_STATUS = ["F", "O"]
_PART_NAMES = ["green apple", "red truck", "blue sky", "green forest", "yellow sun"]
_PART_TYPES = ["ECONOMY ANODIZED STEEL", "STANDARD BRUSHED COPPER", "PROMO BURNISHED NICKEL"]
_PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM"]
_SHIPMODES = ["MAIL", "SHIP", "AIR", "TRUCK"]

Q1_CUTOFF = np.datetime64("1998-09-02")
Q6_RANGE = (np.datetime64("1994-01-01"), np.datetime64("1995-01-01"))
Q12_RANGE = Q6_RANGE
Q14_RANGE = (np.datetime64("1995-09-01"), np.datetime64("1995-10-01"))
PROMO = "PROMO BURNISHED NICKEL"


def _sizes(scale: float):
    return dict(li=int(6_000_000 * scale), ord=int(1_500_000 * scale),
                cust=int(150_000 * scale), part=int(200_000 * scale),
                supp=max(int(10_000 * scale), 25), nation=25, region=5)


def _days(day: str) -> int:
    return int(np.datetime64(day).astype("datetime64[D]").astype(np.int64))


def _dates(rng, n, start="1992-01-01", end="1998-12-01"):
    days = rng.integers(_days(start), _days(end), n)
    return days.astype("datetime64[D]").astype("datetime64[ns]")


def _encoded(values, device) -> Column:
    """Host strings as a dictionary column over their sorted distinct values."""
    keys, codes = np.unique(np.asarray(values), return_inverse=True)
    return Column.from_dictionary(torch.from_numpy(codes.astype(np.int32)).to(device),
                                  Column.from_strings(keys.tolist(), device=device))


def generate(scale: float = 0.01, seed: int = 0, device="cuda"):
    """dict of DataFrames on ``device``: the reference ``generate``'s
    values for the same seed, strings dictionary-encoded."""
    rng = np.random.default_rng(seed)
    n = _sizes(scale)

    def frame(cols):
        return DataFrame({k: _encoded(v, device) if np.asarray(v).dtype.kind == "U" else v
                          for k, v in cols.items()}, device=device)

    nation = frame({
        "n_nationkey": np.arange(n["nation"]),
        "n_name": [f"NATION_{i:02d}" for i in range(n["nation"])],
        "n_regionkey": np.arange(n["nation"]) % n["region"],
    })
    region = frame({"r_regionkey": np.arange(n["region"]), "r_name": _REGIONS})
    supplier = frame({
        "s_suppkey": np.arange(n["supp"]),
        "s_nationkey": rng.integers(0, n["nation"], n["supp"]),
        "s_acctbal": np.round(rng.uniform(-999, 9999, n["supp"]), 2),
    })
    customer = frame({
        "c_custkey": np.arange(n["cust"]),
        "c_name": [f"Customer#{i:09d}" for i in range(n["cust"])],
        "c_nationkey": rng.integers(0, n["nation"], n["cust"]),
        "c_mktsegment": rng.choice(_SEGMENTS, n["cust"]),
        "c_acctbal": np.round(rng.uniform(-999, 9999, n["cust"]), 2),
    })
    part = frame({
        "p_partkey": np.arange(n["part"]),
        "p_name": rng.choice(_PART_NAMES, n["part"]),
        "p_type": rng.choice(_PART_TYPES, n["part"]),
        "p_retailprice": np.round(rng.uniform(900, 2000, n["part"]), 2),
    })
    orders = frame({
        "o_orderkey": np.arange(n["ord"]),
        "o_custkey": rng.integers(0, max(n["cust"], 1), n["ord"]),
        "o_orderstatus": rng.choice(_STATUS, n["ord"]),
        "o_totalprice": np.round(rng.uniform(800, 500000, n["ord"]), 2),
        "o_orderdate": _dates(rng, n["ord"]),
        "o_orderpriority": rng.choice(_PRIORITIES, n["ord"]),
    })
    lineitem = frame({
        "l_orderkey": rng.integers(0, max(n["ord"], 1), n["li"]),
        "l_partkey": rng.integers(0, max(n["part"], 1), n["li"]),
        "l_suppkey": rng.integers(0, n["supp"], n["li"]),
        "l_quantity": rng.integers(1, 51, n["li"]).astype(np.float64),
        "l_extendedprice": np.round(rng.uniform(900, 105000, n["li"]), 2),
        "l_discount": np.round(rng.uniform(0.0, 0.1, n["li"]), 2),
        "l_tax": np.round(rng.uniform(0.0, 0.08, n["li"]), 2),
        "l_returnflag": rng.choice(_FLAGS, n["li"]),
        "l_shipmode": rng.choice(_SHIPMODES, n["li"]),
        "l_linestatus": rng.choice(_STATUS, n["li"]),
        "l_shipdate": _dates(rng, n["li"]),
        "l_commitdate": _dates(rng, n["li"]),
        "l_receiptdate": _dates(rng, n["li"]),
    })
    return {"lineitem": lineitem, "orders": orders, "customer": customer,
            "supplier": supplier, "nation": nation, "region": region, "part": part}


def generate_device(scale: float = 0.01, seed: int = 0, device="cuda"):
    """dict of DataFrames drawn on ``device`` from one seeded
    torch.Generator, in the reference ``generate_device``'s layouts and
    distributions (not its values: another generator)."""
    n = _sizes(scale)
    gen = torch.Generator(device=device).manual_seed(seed)

    def ints(lo, hi, size, dtype=torch.int32):
        return torch.randint(lo, hi, (size,), generator=gen, device=device, dtype=dtype)

    def money(lo, hi, size):
        u = torch.rand(size, generator=gen, device=device, dtype=torch.float64) * (hi - lo) + lo
        return torch.round(u * 100.0) / 100.0

    def dates(size, start="1992-01-01", end="1998-12-01"):
        days = ints(_days(start), _days(end), size, torch.int64)
        return Column(dt.TIMESTAMP_NS, size, days * 86_400_000_000_000)

    def cat(choices, size):
        return Column.from_dictionary(ints(0, len(choices), size),
                                      Column.from_strings(list(choices), device=device))

    def arange(size):
        return torch.arange(size, dtype=torch.int32, device=device)

    def keyed(strings):
        return Column.from_dictionary(arange(len(strings)),
                                      Column.from_strings(strings, device=device))

    nation = DataFrame({
        "n_nationkey": arange(n["nation"]),
        "n_name": keyed([f"NATION_{i:02d}" for i in range(n["nation"])]),
        "n_regionkey": arange(n["nation"]) % n["region"],
    })
    region = DataFrame({"r_regionkey": arange(n["region"]), "r_name": keyed(_REGIONS)})
    supplier = DataFrame({
        "s_suppkey": arange(n["supp"]),
        "s_nationkey": ints(0, n["nation"], n["supp"]),
        "s_acctbal": money(-999, 9999, n["supp"]),
    })
    customer = DataFrame({
        "c_custkey": arange(n["cust"]),
        "c_name": cat([f"Customer#{i:04d}" for i in range(200)], n["cust"]),
        "c_nationkey": ints(0, n["nation"], n["cust"]),
        "c_mktsegment": cat(_SEGMENTS, n["cust"]),
        "c_acctbal": money(-999, 9999, n["cust"]),
    })
    part = DataFrame({
        "p_partkey": arange(n["part"]),
        "p_name": cat(_PART_NAMES, n["part"]),
        "p_type": cat(_PART_TYPES, n["part"]),
        "p_retailprice": money(900, 2000, n["part"]),
    })
    orders = DataFrame({
        "o_orderkey": arange(n["ord"]),
        "o_custkey": ints(0, max(n["cust"], 1), n["ord"]),
        "o_orderstatus": cat(_STATUS, n["ord"]),
        "o_totalprice": money(800, 500000, n["ord"]),
        "o_orderdate": dates(n["ord"]),
        "o_orderpriority": cat(_PRIORITIES, n["ord"]),
    })
    lineitem = DataFrame({
        "l_orderkey": ints(0, max(n["ord"], 1), n["li"]),
        "l_partkey": ints(0, max(n["part"], 1), n["li"]),
        "l_suppkey": ints(0, n["supp"], n["li"]),
        "l_quantity": ints(1, 51, n["li"]).double(),
        "l_extendedprice": money(900, 105000, n["li"]),
        "l_discount": money(0.0, 0.1, n["li"]),
        "l_tax": money(0.0, 0.08, n["li"]),
        "l_returnflag": cat(_FLAGS, n["li"]),
        "l_shipmode": cat(_SHIPMODES, n["li"]),
        "l_linestatus": cat(_STATUS, n["li"]),
        "l_shipdate": dates(n["li"]),
        "l_commitdate": dates(n["li"]),
        "l_receiptdate": dates(n["li"]),
    })
    return {"lineitem": lineitem, "orders": orders, "customer": customer,
            "supplier": supplier, "nation": nation, "region": region, "part": part}


# ----------------------------------------------------------------------
# the queries, as LazyFrame plans
# ----------------------------------------------------------------------

def q1(tables, no_optimization: bool = False):
    """Pricing summary report: a temporal filter, arithmetic, a groupby
    on two dictionary keys (the sort tier), then a sort on them."""
    li = from_dataframe(tables["lineitem"])
    disc_price = col("l_extendedprice") * (lit(1.0) - col("l_discount"))
    plan = (
        li.filter(col("l_shipdate") <= lit(Q1_CUTOFF))
        .with_columns(
            disc_price.alias("disc_price"),
            (disc_price * (lit(1.0) + col("l_tax"))).alias("charge"),
        )
        .group_by("l_returnflag", "l_linestatus")
        .agg(
            col("l_quantity").sum().alias("sum_qty"),
            col("l_extendedprice").sum().alias("sum_base_price"),
            col("disc_price").sum().alias("sum_disc_price"),
            col("charge").sum().alias("sum_charge"),
            col("l_quantity").mean().alias("avg_qty"),
            col("l_extendedprice").mean().alias("avg_price"),
            col("l_discount").mean().alias("avg_disc"),
            col("l_quantity").count().alias("count_order"),
        )
        .sort(["l_returnflag", "l_linestatus"])
    )
    return plan.collect(no_optimization=no_optimization)


def q6(tables, no_optimization: bool = False):
    """Forecast revenue change: five predicates, a product, one sum."""
    li = from_dataframe(tables["lineitem"])
    lo, hi = Q6_RANGE
    plan = (
        li.filter(
            (col("l_shipdate") >= lit(lo)) & (col("l_shipdate") < lit(hi))
            & (col("l_discount") >= lit(0.05)) & (col("l_discount") <= lit(0.07))
            & (col("l_quantity") < lit(24.0))
        )
        .with_columns((col("l_extendedprice") * col("l_discount")).alias("revenue"))
        .agg(col("revenue").sum().alias("revenue"))
    )
    return plan.collect(no_optimization=no_optimization)


def q12(tables, no_optimization: bool = False):
    """Shipping modes and order priority: is_in on a dictionary, temporal
    comparisons, a join against orders, a CASE count by ship mode (one
    dictionary key: the one-hot tier)."""
    o = from_dataframe(tables["orders"])
    li = from_dataframe(tables["lineitem"])
    lo, hi = Q12_RANGE
    high = (col("o_orderpriority") == lit("1-URGENT")) | (
        col("o_orderpriority") == lit("2-HIGH"))
    plan = (
        li.filter(col("l_shipmode").is_in(["MAIL", "SHIP"])
                  & (col("l_commitdate") < col("l_receiptdate"))
                  & (col("l_shipdate") < col("l_commitdate"))
                  & (col("l_receiptdate") >= lit(lo))
                  & (col("l_receiptdate") < lit(hi)))
        .join(o, left_on="l_orderkey", right_on="o_orderkey")
        .with_columns(
            when(high).then(lit(1)).otherwise(lit(0)).alias("high_line"),
            when(~high).then(lit(1)).otherwise(lit(0)).alias("low_line"),
        )
        .group_by("l_shipmode")
        .agg(col("high_line").sum().alias("high_line_count"),
             col("low_line").sum().alias("low_line_count"))
        .sort("l_shipmode")
    )
    return plan.collect(no_optimization=no_optimization)


def q14(tables, no_optimization: bool = False):
    """Promotion effect: the promo revenue share in percent, after a
    join against part and a CASE on a dictionary compared with a string."""
    li = from_dataframe(tables["lineitem"])
    p = from_dataframe(tables["part"])
    lo, hi = Q14_RANGE
    plan = (
        li.filter((col("l_shipdate") >= lit(lo)) & (col("l_shipdate") < lit(hi)))
        .join(p, left_on="l_partkey", right_on="p_partkey")
        .with_columns((col("l_extendedprice") * (lit(1.0) - col("l_discount"))).alias("rev"))
        .with_columns(
            when(col("p_type") == lit(PROMO))
            .then(col("rev")).otherwise(lit(0.0)).alias("promo_rev"))
        .agg(col("promo_rev").sum().alias("promo"),
             col("rev").sum().alias("total"))
    )
    out = plan.collect(no_optimization=no_optimization)._table
    promo, total = (float(out[n].data[0]) for n in ("promo", "total"))
    return 100.0 * promo / total if total else 0.0


QUERIES = {"q1": q1, "q6": q6, "q12": q12, "q14": q14}


def pandas_reference(tables, query: str):
    """The same query in pandas, over the tables' ``to_pandas()``."""
    import pandas as pd

    t = {k: tables[k].to_pandas() for k in ("lineitem", "orders", "part")}
    li = t["lineitem"]
    if query == "q1":
        li = li[li.l_shipdate <= pd.Timestamp("1998-09-02")].copy()
        li["disc_price"] = li.l_extendedprice * (1 - li.l_discount)
        li["charge"] = li.disc_price * (1 + li.l_tax)
        return li.groupby(["l_returnflag", "l_linestatus"], observed=True).agg(
            sum_qty=("l_quantity", "sum"),
            sum_base_price=("l_extendedprice", "sum"),
            sum_disc_price=("disc_price", "sum"),
            sum_charge=("charge", "sum"),
            avg_qty=("l_quantity", "mean"),
            avg_price=("l_extendedprice", "mean"),
            avg_disc=("l_discount", "mean"),
            count_order=("l_quantity", "count"),
        ).reset_index().sort_values(["l_returnflag", "l_linestatus"]).reset_index(drop=True)
    if query == "q6":
        m = ((li.l_shipdate >= pd.Timestamp("1994-01-01"))
             & (li.l_shipdate < pd.Timestamp("1995-01-01"))
             & (li.l_discount >= 0.05) & (li.l_discount <= 0.07)
             & (li.l_quantity < 24))
        return float((li[m].l_extendedprice * li[m].l_discount).sum())
    if query == "q12":
        o = t["orders"]
        lo, hi = pd.Timestamp("1994-01-01"), pd.Timestamp("1995-01-01")
        m = (li.l_shipmode.isin(["MAIL", "SHIP"])
             & (li.l_commitdate < li.l_receiptdate)
             & (li.l_shipdate < li.l_commitdate)
             & (li.l_receiptdate >= lo) & (li.l_receiptdate < hi))
        df = li[m].merge(o, left_on="l_orderkey", right_on="o_orderkey")
        high = df.o_orderpriority.isin(["1-URGENT", "2-HIGH"])
        df = df.assign(high_line=high.astype(int), low_line=(~high).astype(int))
        return (df.groupby("l_shipmode", observed=True)
                .agg(high_line_count=("high_line", "sum"),
                     low_line_count=("low_line", "sum")).reset_index()
                .sort_values("l_shipmode").reset_index(drop=True))
    if query == "q14":
        p = t["part"]
        lo, hi = pd.Timestamp("1995-09-01"), pd.Timestamp("1995-10-01")
        df = li[(li.l_shipdate >= lo) & (li.l_shipdate < hi)].merge(
            p, left_on="l_partkey", right_on="p_partkey")
        rev = df.l_extendedprice * (1 - df.l_discount)
        promo = rev[df.p_type == PROMO].sum()
        return 100.0 * promo / rev.sum() if rev.sum() else 0.0
    raise ValueError(query)


# ----------------------------------------------------------------------
# plain PyTorch versions over the tables' tensors (dictionary columns as
# codes and their host keys, dates as int64 ns ticks): each filter a
# boolean mask, each join a dense table over the build keys, each groupby
# a bincount over the codes
# ----------------------------------------------------------------------

def _ns(day) -> int:
    return int(np.datetime64(day, "ns").astype(np.int64))


def _data(df, name) -> torch.Tensor:
    return df._table[name].data


def _codes_of(df, name, wanted):
    """The codes whose keys are in ``wanted``."""
    keys = df._table[name].keys.host_strings()
    return [i for i, k in enumerate(keys) if k in wanted]


def _dense_lookup(build: torch.Tensor, probe: torch.Tensor):
    """(found, build row) for each probe key, over a table of the build
    side's (unique) keys."""
    lo = int(build.min())
    table = torch.full((int(build.max()) - lo + 1,), -1, dtype=torch.int64, device=build.device)
    table[(build - lo).long()] = torch.arange(build.shape[0], device=build.device)
    pos = (probe - lo).long()
    ok = (pos >= 0) & (pos < table.shape[0])
    row = table[pos.clamp(0, table.shape[0] - 1)]
    return ok & (row >= 0), row


def plain_q1(tables):
    """(keys as (returnflag, linestatus) strings in sorted order, {column:
    tensor}) with q1's columns."""
    li = tables["lineitem"]
    m = _data(li, "l_shipdate") <= _ns(Q1_CUTOFF)
    rf, ls = _data(li, "l_returnflag")[m].long(), _data(li, "l_linestatus")[m].long()
    rf_keys = li._table["l_returnflag"].keys.host_strings()
    ls_keys = li._table["l_linestatus"].keys.host_strings()
    K = len(ls_keys)
    g = rf * K + ls
    G = len(rf_keys) * K
    qty, price = _data(li, "l_quantity")[m], _data(li, "l_extendedprice")[m]
    disc, tax = _data(li, "l_discount")[m], _data(li, "l_tax")[m]
    disc_price = price * (1.0 - disc)

    def total(x):
        return torch.zeros(G, dtype=torch.float64, device=x.device).index_add_(0, g, x)

    cnt = torch.bincount(g, minlength=G)
    sums = {"sum_qty": total(qty), "sum_base_price": total(price),
            "sum_disc_price": total(disc_price),
            "sum_charge": total(disc_price * (1.0 + tax))}
    present = [i for i in torch.nonzero(cnt).squeeze(1).tolist()]
    order = sorted(present, key=lambda i: (rf_keys[i // K].encode(), ls_keys[i % K].encode()))
    idx = torch.tensor(order, dtype=torch.int64, device=cnt.device)
    out = {k: v[idx] for k, v in sums.items()}
    c = cnt[idx]
    out["avg_qty"] = out["sum_qty"] / c
    out["avg_price"] = out["sum_base_price"] / c
    out["avg_disc"] = total(disc)[idx] / c
    out["count_order"] = c
    return [(rf_keys[i // K], ls_keys[i % K]) for i in order], out


def plain_q6(tables) -> float:
    li = tables["lineitem"]
    sd, disc, qty = (_data(li, n) for n in ("l_shipdate", "l_discount", "l_quantity"))
    lo, hi = Q6_RANGE
    m = ((sd >= _ns(lo)) & (sd < _ns(hi)) & (disc >= 0.05) & (disc <= 0.07) & (qty < 24.0))
    return float((_data(li, "l_extendedprice") * disc)[m].sum())


def plain_q12(tables):
    """(ship modes in sorted order, high_line_count, low_line_count)."""
    li, o = tables["lineitem"], tables["orders"]
    sd, cd, rd = (_data(li, n) for n in ("l_shipdate", "l_commitdate", "l_receiptdate"))
    mode = _data(li, "l_shipmode")
    lo, hi = Q12_RANGE
    m = (cd < rd) & (sd < cd) & (rd >= _ns(lo)) & (rd < _ns(hi))
    wanted = torch.zeros_like(m)
    for c in _codes_of(li, "l_shipmode", {"MAIL", "SHIP"}):
        wanted |= mode == c
    rows = torch.nonzero(m & wanted).squeeze(1)
    found, orow = _dense_lookup(_data(o, "o_orderkey"), _data(li, "l_orderkey")[rows])
    rows, orow = rows[found], orow[found]
    prio = _data(o, "o_orderpriority")[orow]
    high = torch.zeros_like(prio, dtype=torch.bool)
    for c in _codes_of(o, "o_orderpriority", {"1-URGENT", "2-HIGH"}):
        high |= prio == c
    keys = li._table["l_shipmode"].keys.host_strings()
    g = mode[rows].long()
    hi_cnt = torch.bincount(g, weights=high.double(), minlength=len(keys)).long()
    cnt = torch.bincount(g, minlength=len(keys))
    present = sorted((i for i in torch.nonzero(cnt).squeeze(1).tolist()),
                     key=lambda i: keys[i].encode())
    idx = torch.tensor(present, dtype=torch.int64, device=cnt.device)
    return [keys[i] for i in present], hi_cnt[idx], (cnt - hi_cnt)[idx]


def plain_q14(tables) -> float:
    li, p = tables["lineitem"], tables["part"]
    sd = _data(li, "l_shipdate")
    lo, hi = Q14_RANGE
    rows = torch.nonzero((sd >= _ns(lo)) & (sd < _ns(hi))).squeeze(1)
    found, prow = _dense_lookup(_data(p, "p_partkey"), _data(li, "l_partkey")[rows])
    rows, prow = rows[found], prow[found]
    rev = _data(li, "l_extendedprice")[rows] * (1.0 - _data(li, "l_discount")[rows])
    ptype = _data(p, "p_type")[prow]
    promo_hit = torch.zeros_like(ptype, dtype=torch.bool)
    for c in _codes_of(p, "p_type", {PROMO}):
        promo_hit |= ptype == c
    promo, total = torch.stack([torch.where(promo_hit, rev, 0.0).sum(), rev.sum()]).tolist()
    return 100.0 * promo / total if total else 0.0


PLAIN = {"q1": plain_q1, "q6": plain_q6, "q12": plain_q12, "q14": plain_q14}
