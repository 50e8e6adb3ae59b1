"""TPC-H tables and the nine queries of ``benchmarks/tpch.py`` (q1, q3,
q4, q5, q6, q9, q10, q12 and q14) on the port's LazyFrame engine (the
port's counterpart of ``benchmarks/tpch.py``).

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
- ``q1`` ... ``q14`` are the reference's plans; ``QUERIES`` maps their
  names to them.  A table may be a frame or a LazyFrame, such as a file
  scan (``engine.scan_parquet``).  ``mesh`` (a partition count or
  "auto") and ``streaming`` run a plan on the partitioned executor
  (``LazyFrame.collect``).
- ``FRAME_QUERIES`` are the bodies of the reference's pandas version of
  each over a dict of frames, which run on the port's ``DataFrame`` (its
  pandas API) as they run on pandas; ``pandas_reference`` runs them on
  the tables' ``to_pandas()``.
- ``plain_q1`` ... ``plain_q14`` (``PLAIN``) compute the same answers in
  plain PyTorch over the tables' tensors, apart from the engine: masks,
  dense lookup tables over the build keys, ``index_add_`` and
  ``bincount``.
"""

from __future__ import annotations

import numpy as np
import torch

from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.engine import LazyFrame, col, from_dataframe, lit, when
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
Q3_CUTOFF = np.datetime64("1995-03-15")
Q4_RANGE = (np.datetime64("1993-07-01"), np.datetime64("1993-10-01"))
Q5_RANGE = Q6_RANGE
Q10_RANGE = (np.datetime64("1993-10-01"), np.datetime64("1994-01-01"))
PROMO = "PROMO BURNISHED NICKEL"
Q9_PARTS = ["green apple", "green forest"]


def _source(table):
    """A query's source: a frame, or a LazyFrame such as a file scan
    (``engine.scan_parquet``)."""
    return table if isinstance(table, LazyFrame) else from_dataframe(table)


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

def q1(tables, no_optimization: bool = False, mesh=None, streaming: bool = False):
    """Pricing summary report: a temporal filter, arithmetic, a groupby
    on two dictionary keys (the sort tier), then a sort on them."""
    li = _source(tables["lineitem"])
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
    return plan.collect(no_optimization=no_optimization, mesh=mesh, streaming=streaming)


def q6(tables, no_optimization: bool = False, mesh=None, streaming: bool = False):
    """Forecast revenue change: five predicates, a product, one sum."""
    li = _source(tables["lineitem"])
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
    return plan.collect(no_optimization=no_optimization, mesh=mesh, streaming=streaming)


def q12(tables, no_optimization: bool = False, mesh=None, streaming: bool = False):
    """Shipping modes and order priority: is_in on a dictionary, temporal
    comparisons, a join against orders, a CASE count by ship mode (one
    dictionary key: the one-hot tier)."""
    o = _source(tables["orders"])
    li = _source(tables["lineitem"])
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
    return plan.collect(no_optimization=no_optimization, mesh=mesh, streaming=streaming)


def q14(tables, no_optimization: bool = False, mesh=None, streaming: bool = False):
    """Promotion effect: the promo revenue share in percent, after a
    join against part and a CASE on a dictionary compared with a string."""
    li = _source(tables["lineitem"])
    p = _source(tables["part"])
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
    out = plan.collect(no_optimization=no_optimization, mesh=mesh, streaming=streaming)._table
    promo, total = (float(out[n].data[0]) for n in ("promo", "total"))
    return 100.0 * promo / total if total else 0.0


def q3(tables, no_optimization: bool = False, mesh=None, streaming: bool = False):
    """Shipping priority: a customer filter on a dictionary, two joins
    (customer-orders, orders-lineitem), revenue by order on two keys (the
    sort tier), the top 10 by revenue."""
    c = _source(tables["customer"])
    o = _source(tables["orders"])
    li = _source(tables["lineitem"])
    plan = (
        c.filter(col("c_mktsegment") == lit("BUILDING"))
        .join(o, left_on="c_custkey", right_on="o_custkey")
        .filter(col("o_orderdate") < lit(Q3_CUTOFF))
        .join(li, left_on="o_orderkey", right_on="l_orderkey")
        .filter(col("l_shipdate") > lit(Q3_CUTOFF))
        .with_columns((col("l_extendedprice") * (lit(1.0) - col("l_discount")))
                      .alias("revenue"))
        .group_by("o_orderkey", "o_orderdate")
        .agg(col("revenue").sum().alias("revenue"))
        .sort(["revenue", "o_orderdate"], descending=[True, False])
        .head(10)
    )
    return plan.collect(no_optimization=no_optimization, mesh=mesh, streaming=streaming)


def q4(tables, no_optimization: bool = False, mesh=None, streaming: bool = False):
    """Order priority checking: a semi join of a quarter's orders against
    the late lineitems (the sort-merge tier), counts by priority."""
    o = _source(tables["orders"])
    li = _source(tables["lineitem"])
    lo, hi = Q4_RANGE
    late = li.filter(col("l_commitdate") < col("l_receiptdate"))
    plan = (
        o.filter((col("o_orderdate") >= lit(lo)) & (col("o_orderdate") < lit(hi)))
        .join(late, left_on="o_orderkey", right_on="l_orderkey", how="semi")
        .group_by("o_orderpriority")
        .agg(col("o_orderkey").count().alias("order_count"))
        .sort("o_orderpriority")
    )
    return plan.collect(no_optimization=no_optimization, mesh=mesh, streaming=streaming)


def q5(tables, no_optimization: bool = False, mesh=None, streaming: bool = False):
    """Local supplier volume: five joins from region down to lineitem,
    the last on two keys (supplier and nation: the sort-merge tier),
    revenue by nation."""
    li = _source(tables["lineitem"])
    o = _source(tables["orders"])
    c = _source(tables["customer"])
    s = _source(tables["supplier"])
    n = _source(tables["nation"])
    r = _source(tables["region"])
    lo, hi = Q5_RANGE
    plan = (
        r.filter(col("r_name") == lit("ASIA"))
        .join(n, left_on="r_regionkey", right_on="n_regionkey")
        .join(c, left_on="n_nationkey", right_on="c_nationkey")
        .join(o.filter((col("o_orderdate") >= lit(lo)) & (col("o_orderdate") < lit(hi))),
              left_on="c_custkey", right_on="o_custkey")
        .join(li, left_on="o_orderkey", right_on="l_orderkey")
        .join(s, left_on=["l_suppkey", "n_nationkey"], right_on=["s_suppkey", "s_nationkey"])
        .with_columns(
            (col("l_extendedprice") * (lit(1.0) - col("l_discount"))).alias("volume"))
        .group_by("n_name")
        .agg(col("volume").sum().alias("revenue"))
        .sort("revenue", descending=True)
    )
    return plan.collect(no_optimization=no_optimization, mesh=mesh, streaming=streaming)


def q9(tables, no_optimization: bool = False, mesh=None, streaming: bool = False):
    """Product type profit: green parts joined to lineitem, supplier,
    nation and orders; profit by nation."""
    li = _source(tables["lineitem"])
    s = _source(tables["supplier"])
    n = _source(tables["nation"])
    p = _source(tables["part"])
    o = _source(tables["orders"])
    plan = (
        p.filter(col("p_name").is_in(Q9_PARTS))
        .join(li, left_on="p_partkey", right_on="l_partkey")
        .join(s, left_on="l_suppkey", right_on="s_suppkey")
        .join(n, left_on="s_nationkey", right_on="n_nationkey")
        .join(o, left_on="l_orderkey", right_on="o_orderkey")
        .with_columns(
            (col("l_extendedprice") * (lit(1.0) - col("l_discount"))
             - lit(10.0) * col("l_quantity")).alias("amount"))
        .group_by("n_name")
        .agg(col("amount").sum().alias("sum_profit"))
        .sort("n_name")
    )
    return plan.collect(no_optimization=no_optimization, mesh=mesh, streaming=streaming)


def q10(tables, no_optimization: bool = False, mesh=None, streaming: bool = False):
    """Returned item reporting: customer-orders-lineitem-nation joins,
    lost revenue by four keys (the sort tier: an int, a dictionary, a
    float and a dictionary), the top 20 customers."""
    c = _source(tables["customer"])
    o = _source(tables["orders"])
    li = _source(tables["lineitem"])
    n = _source(tables["nation"])
    lo, hi = Q10_RANGE
    plan = (
        c.join(o, left_on="c_custkey", right_on="o_custkey")
        .filter((col("o_orderdate") >= lit(lo)) & (col("o_orderdate") < lit(hi)))
        .join(li, left_on="o_orderkey", right_on="l_orderkey")
        .filter(col("l_returnflag") == lit("R"))
        .join(n, left_on="c_nationkey", right_on="n_nationkey")
        .with_columns((col("l_extendedprice") * (lit(1.0) - col("l_discount")))
                      .alias("revenue"))
        .group_by("c_custkey", "c_name", "c_acctbal", "n_name")
        .agg(col("revenue").sum().alias("revenue"))
        .sort(["revenue", "c_custkey"], descending=[True, False])
        .head(20)
    )
    return plan.collect(no_optimization=no_optimization, mesh=mesh, streaming=streaming)


QUERIES = {"q1": q1, "q3": q3, "q4": q4, "q5": q5, "q6": q6, "q9": q9, "q10": q10,
           "q12": q12, "q14": q14}


# ----------------------------------------------------------------------
# the queries in pandas' API: the bodies of the reference's
# ``pandas_reference`` over a dict of frames, dates as np.datetime64,
# nothing brought to the host.  They call pandas methods only, so one
# function runs on the port's frames, the reference's cudf_tpu.DataFrame
# tables and pandas frames alike.
# ----------------------------------------------------------------------

def frame_q1(t):
    li = t["lineitem"]
    li = li[li.l_shipdate <= Q1_CUTOFF].copy()
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


def frame_q6(t):
    li = t["lineitem"]
    lo, hi = Q6_RANGE
    m = ((li.l_shipdate >= lo) & (li.l_shipdate < hi)
         & (li.l_discount >= 0.05) & (li.l_discount <= 0.07)
         & (li.l_quantity < 24))
    return float((li[m].l_extendedprice * li[m].l_discount).sum())


def frame_q12(t):
    o, li = t["orders"], t["lineitem"]
    lo, hi = Q12_RANGE
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


def frame_q14(t):
    li, p = t["lineitem"], t["part"]
    lo, hi = Q14_RANGE
    df = li[(li.l_shipdate >= lo) & (li.l_shipdate < hi)].merge(
        p, left_on="l_partkey", right_on="p_partkey")
    rev = df.l_extendedprice * (1 - df.l_discount)
    promo = rev[df.p_type == PROMO].sum()
    return 100.0 * promo / rev.sum() if rev.sum() else 0.0


def frame_q3(t):
    c, o, li = t["customer"], t["orders"], t["lineitem"]
    df = c[c.c_mktsegment == "BUILDING"].merge(
        o[o.o_orderdate < Q3_CUTOFF], left_on="c_custkey", right_on="o_custkey")
    df = df.merge(li[li.l_shipdate > Q3_CUTOFF], left_on="o_orderkey", right_on="l_orderkey")
    df["revenue"] = df.l_extendedprice * (1 - df.l_discount)
    out = (df.groupby(["o_orderkey", "o_orderdate"]).agg(revenue=("revenue", "sum"))
           .reset_index().sort_values(["revenue", "o_orderdate"], ascending=[False, True])
           .head(10).reset_index(drop=True))
    return out[["o_orderkey", "o_orderdate", "revenue"]]


def frame_q4(t):
    o, li = t["orders"], t["lineitem"]
    lo, hi = Q4_RANGE
    late = li[li.l_commitdate < li.l_receiptdate]
    sel = o[(o.o_orderdate >= lo) & (o.o_orderdate < hi)]
    sel = sel[sel.o_orderkey.isin(late.l_orderkey)]
    return (sel.groupby("o_orderpriority", observed=True)
            .agg(order_count=("o_orderkey", "count")).reset_index()
            .sort_values("o_orderpriority").reset_index(drop=True))


def frame_q5(t):
    r, n, c, o, li, s = (t[k] for k in ("region", "nation", "customer", "orders",
                                          "lineitem", "supplier"))
    lo, hi = Q5_RANGE
    df = r[r.r_name == "ASIA"].merge(n, left_on="r_regionkey", right_on="n_regionkey")
    df = df.merge(c, left_on="n_nationkey", right_on="c_nationkey")
    df = df.merge(o[(o.o_orderdate >= lo) & (o.o_orderdate < hi)],
                  left_on="c_custkey", right_on="o_custkey")
    df = df.merge(li, left_on="o_orderkey", right_on="l_orderkey")
    df = df.merge(s, left_on=["l_suppkey", "n_nationkey"],
                  right_on=["s_suppkey", "s_nationkey"])
    df["volume"] = df.l_extendedprice * (1 - df.l_discount)
    return (df.groupby("n_name", observed=True).agg(revenue=("volume", "sum"))
            .reset_index().sort_values("revenue", ascending=False).reset_index(drop=True))


def frame_q9(t):
    p, li, s, n, o = (t[k] for k in ("part", "lineitem", "supplier", "nation", "orders"))
    df = p[p.p_name.isin(Q9_PARTS)].merge(li, left_on="p_partkey", right_on="l_partkey")
    df = df.merge(s, left_on="l_suppkey", right_on="s_suppkey")
    df = df.merge(n, left_on="s_nationkey", right_on="n_nationkey")
    df = df.merge(o, left_on="l_orderkey", right_on="o_orderkey")
    df["amount"] = df.l_extendedprice * (1 - df.l_discount) - 10.0 * df.l_quantity
    return (df.groupby("n_name", observed=True).agg(sum_profit=("amount", "sum"))
            .reset_index().sort_values("n_name").reset_index(drop=True))


def frame_q10(t):
    c, o, li, n = (t[k] for k in ("customer", "orders", "lineitem", "nation"))
    lo, hi = Q10_RANGE
    df = c.merge(o[(o.o_orderdate >= lo) & (o.o_orderdate < hi)],
                 left_on="c_custkey", right_on="o_custkey")
    df = df.merge(li[li.l_returnflag == "R"], left_on="o_orderkey", right_on="l_orderkey")
    df = df.merge(n, left_on="c_nationkey", right_on="n_nationkey")
    df["revenue"] = df.l_extendedprice * (1 - df.l_discount)
    return (df.groupby(["c_custkey", "c_name", "c_acctbal", "n_name"], observed=True)
            .agg(revenue=("revenue", "sum")).reset_index()
            .sort_values(["revenue", "c_custkey"], ascending=[False, True])
            .head(20).reset_index(drop=True))


FRAME_QUERIES = {"q1": frame_q1, "q3": frame_q3, "q4": frame_q4, "q5": frame_q5,
                 "q6": frame_q6, "q9": frame_q9, "q10": frame_q10, "q12": frame_q12,
                 "q14": frame_q14}


def pandas_reference(tables, query: str):
    """The same query computed by pandas: ``FRAME_QUERIES[query]`` over the
    tables' ``to_pandas()``."""
    return FRAME_QUERIES[query]({k: v.to_pandas() for k, v in tables.items()})


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


def _in_codes(df, name, wanted) -> torch.Tensor:
    """bool per row: whether the dictionary column's key is in ``wanted``."""
    codes = _data(df, name)
    hit = torch.zeros_like(codes, dtype=torch.bool)
    for c in _codes_of(df, name, wanted):
        hit |= codes == c
    return hit


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
    rows = torch.nonzero(m & _in_codes(li, "l_shipmode", {"MAIL", "SHIP"})).squeeze(1)
    found, orow = _dense_lookup(_data(o, "o_orderkey"), _data(li, "l_orderkey")[rows])
    rows, orow = rows[found], orow[found]
    high = _in_codes(o, "o_orderpriority", {"1-URGENT", "2-HIGH"})[orow]
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
    promo_hit = _in_codes(p, "p_type", {PROMO})[prow]
    promo, total = torch.stack([torch.where(promo_hit, rev, 0.0).sum(), rev.sum()]).tolist()
    return 100.0 * promo / total if total else 0.0


def _top(keys, n):
    """Row positions in ascending lexicographic order of the key tensors
    (the first one most significant), the first n."""
    order = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k in reversed(keys):
        order = order[torch.sort(k[order], stable=True).indices]
    return order[:n]


def plain_q3(tables):
    """{o_orderkey, o_orderdate (ns ticks), revenue}: the top 10 orders."""
    c, o, li = tables["customer"], tables["orders"], tables["lineitem"]
    cut = _ns(Q3_CUTOFF)
    found, crow = _dense_lookup(_data(c, "c_custkey"), _data(o, "o_custkey"))
    building = _in_codes(c, "c_mktsegment", {"BUILDING"})
    o_ok = found & building[crow.clamp(min=0)] & (_data(o, "o_orderdate") < cut)
    found, orow = _dense_lookup(_data(o, "o_orderkey"), _data(li, "l_orderkey"))
    rows = torch.nonzero(found & (_data(li, "l_shipdate") > cut)).squeeze(1)
    orow = orow[rows]
    keep = o_ok[orow]
    rows, orow = rows[keep], orow[keep]
    rev = _data(li, "l_extendedprice")[rows] * (1.0 - _data(li, "l_discount")[rows])
    total = torch.zeros(len(o), dtype=torch.float64, device=rev.device).index_add_(0, orow, rev)
    hit = torch.nonzero(torch.bincount(orow, minlength=len(o))).squeeze(1)
    key, date, revenue = _data(o, "o_orderkey")[hit], _data(o, "o_orderdate")[hit], total[hit]
    top = _top([-revenue, date, key.long()], 10)
    return {"o_orderkey": key[top], "o_orderdate": date[top], "revenue": revenue[top]}


def plain_q4(tables):
    """(priorities in sorted order, order counts)."""
    o, li = tables["orders"], tables["lineitem"]
    late = _data(li, "l_commitdate") < _data(li, "l_receiptdate")
    found, orow = _dense_lookup(_data(o, "o_orderkey"), _data(li, "l_orderkey")[late])
    has_late = torch.zeros(len(o), dtype=torch.bool, device=orow.device)
    has_late[orow[found]] = True
    lo, hi = Q4_RANGE
    od = _data(o, "o_orderdate")
    m = has_late & (od >= _ns(lo)) & (od < _ns(hi))
    keys = o._table["o_orderpriority"].keys.host_strings()
    cnt = torch.bincount(_data(o, "o_orderpriority")[m].long(), minlength=len(keys))
    present = sorted(torch.nonzero(cnt).squeeze(1).tolist(), key=lambda i: keys[i].encode())
    return [keys[i] for i in present], cnt[torch.tensor(present, dtype=torch.int64,
                                                         device=cnt.device)]


def _by_nation(tables, nation_row, values, order):
    """(nation names, sums) over the nations a value falls in, ordered by
    ``order(names, sums)`` -> positions."""
    n = tables["nation"]
    total = torch.zeros(len(n), dtype=torch.float64, device=values.device).index_add_(
        0, nation_row, values)
    present = torch.nonzero(torch.bincount(nation_row, minlength=len(n))).squeeze(1)
    names = n._table["n_name"].to_numpy().tolist()
    sums = total[present]
    picked = order([names[i] for i in present.tolist()], sums)
    return [names[i] for i in present[picked].tolist()], sums[picked]


def plain_q5(tables):
    """(nation names by revenue, descending; revenues)."""
    li, o, c, s, n, r = (tables[k] for k in ("lineitem", "orders", "customer", "supplier",
                                             "nation", "region"))
    asia_region = _in_codes(r, "r_name", {"ASIA"})
    found, rrow = _dense_lookup(_data(r, "r_regionkey"), _data(n, "n_regionkey"))
    asia = found & asia_region[rrow.clamp(min=0)]                  # by nation row
    found, nrow_c = _dense_lookup(_data(n, "n_nationkey"), _data(c, "c_nationkey"))
    c_ok = found & asia[nrow_c.clamp(min=0)]
    lo, hi = Q5_RANGE
    od = _data(o, "o_orderdate")
    found, crow = _dense_lookup(_data(c, "c_custkey"), _data(o, "o_custkey"))
    crow = crow.clamp(min=0)
    o_ok = found & c_ok[crow] & (od >= _ns(lo)) & (od < _ns(hi))
    o_nation = nrow_c.clamp(min=0)[crow]                           # the order's nation row
    found, orow = _dense_lookup(_data(o, "o_orderkey"), _data(li, "l_orderkey"))
    orow = orow.clamp(min=0)
    sfound, srow = _dense_lookup(_data(s, "s_suppkey"), _data(li, "l_suppkey"))
    _, snrow = _dense_lookup(_data(n, "n_nationkey"), _data(s, "s_nationkey"))
    s_nation = snrow[srow.clamp(min=0)]
    rows = torch.nonzero(found & o_ok[orow] & sfound & (s_nation == o_nation[orow])
                         ).squeeze(1)
    vol = _data(li, "l_extendedprice")[rows] * (1.0 - _data(li, "l_discount")[rows])
    return _by_nation(tables, o_nation[orow[rows]], vol,
                      lambda names, sums: torch.sort(sums, descending=True, stable=True).indices)


def plain_q9(tables):
    """(nation names in sorted order, profits)."""
    li, s, n, p, o = (tables[k] for k in ("lineitem", "supplier", "nation", "part", "orders"))
    green = _in_codes(p, "p_name", set(Q9_PARTS))
    pfound, prow = _dense_lookup(_data(p, "p_partkey"), _data(li, "l_partkey"))
    sfound, srow = _dense_lookup(_data(s, "s_suppkey"), _data(li, "l_suppkey"))
    nfound, snrow = _dense_lookup(_data(n, "n_nationkey"), _data(s, "s_nationkey"))
    ofound, _ = _dense_lookup(_data(o, "o_orderkey"), _data(li, "l_orderkey"))
    srow = srow.clamp(min=0)
    rows = torch.nonzero(pfound & green[prow.clamp(min=0)] & sfound & nfound[srow]
                         & ofound).squeeze(1)
    amount = (_data(li, "l_extendedprice")[rows] * (1.0 - _data(li, "l_discount")[rows])
              - 10.0 * _data(li, "l_quantity")[rows])
    return _by_nation(tables, snrow[srow[rows]], amount,
                      lambda names, sums: torch.tensor(
                          sorted(range(len(names)), key=lambda i: names[i].encode()),
                          dtype=torch.int64, device=sums.device))


def plain_q10(tables):
    """{c_custkey, c_name (strings), c_acctbal, n_name (strings), revenue}:
    the top 20 customers."""
    c, o, li, n = (tables[k] for k in ("customer", "orders", "lineitem", "nation"))
    lo, hi = Q10_RANGE
    od = _data(o, "o_orderdate")
    cfound, crow = _dense_lookup(_data(c, "c_custkey"), _data(o, "o_custkey"))
    o_ok = cfound & (od >= _ns(lo)) & (od < _ns(hi))
    found, orow = _dense_lookup(_data(o, "o_orderkey"), _data(li, "l_orderkey"))
    orow = orow.clamp(min=0)
    nfound, nrow = _dense_lookup(_data(n, "n_nationkey"), _data(c, "c_nationkey"))
    crow_li = crow.clamp(min=0)[orow]
    rows = torch.nonzero(found & o_ok[orow] & _in_codes(li, "l_returnflag", {"R"})
                         & nfound[crow_li]).squeeze(1)
    cust = crow_li[rows]
    rev = _data(li, "l_extendedprice")[rows] * (1.0 - _data(li, "l_discount")[rows])
    total = torch.zeros(len(c), dtype=torch.float64, device=rev.device).index_add_(0, cust, rev)
    hit = torch.nonzero(torch.bincount(cust, minlength=len(c))).squeeze(1)
    key = _data(c, "c_custkey")[hit]
    top = hit[_top([-total[hit], key.long()], 20)]
    names = c._table["c_name"].keys.host_strings()
    nations = n._table["n_name"].to_numpy().tolist()
    return {"c_custkey": _data(c, "c_custkey")[top],
            "c_name": [names[i] for i in _data(c, "c_name")[top].tolist()],
            "c_acctbal": _data(c, "c_acctbal")[top],
            "n_name": [nations[i] for i in nrow[top].tolist()],
            "revenue": total[top]}


def answer(query: str, res):
    """A query's result (a LazyFrame query's or a frame query's) in its
    plain version's form: q6 and q14 a float;
    q1 (keys, {column: tensor}); q12 (modes, high, low); q4, q5 and q9
    (keys, values); q3 and q10 {column: tensor, or strings for a
    dictionary column}."""
    if query == "q14" or isinstance(res, float):
        return res
    t = res._table
    if query == "q6":
        return float(t["revenue"].data[0])
    if query == "q1":
        keys = list(zip(t["l_returnflag"].to_numpy().tolist(),
                        t["l_linestatus"].to_numpy().tolist()))
        return keys, {n: t[n].data for n in t.names if n not in ("l_returnflag",
                                                                  "l_linestatus")}
    if query == "q12":
        return (t["l_shipmode"].to_numpy().tolist(), t["high_line_count"].data,
                t["low_line_count"].data)
    if query in ("q4", "q5", "q9"):
        key, value = t.names
        return t[key].to_numpy().tolist(), t[value].data
    return {n: c.to_numpy().tolist() if c.dtype.is_dictionary else c.data
            for n, c in t.items()}


PLAIN = {"q1": plain_q1, "q3": plain_q3, "q4": plain_q4, "q5": plain_q5, "q6": plain_q6,
         "q9": plain_q9, "q10": plain_q10, "q12": plain_q12, "q14": plain_q14}
