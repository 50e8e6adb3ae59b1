"""The port's LazyFrame engine (``cudf_tpu_torch/engine``: expressions,
every ported IR node, the optimizer) against the reference's engine on
the JAX CPU backend and against pandas, on the same seeded numpy data.
The port's frame holds the string column as a dictionary (a pandas
Categorical), the reference's as strings; keys are compared as strings.

Tolerances: counts, integer, bool, temporal and key results exact;
float aggregates rtol 1e-12.  Also: the raises of what is not ported.
"""

import datetime

import numpy as np
import pandas as pd
import pytest
import torch

import torch_jax_cache  # noqa: F401  (the run's shared JAX compile cache)
import cudf_tpu
from cudf_tpu import engine as ref_engine
from cudf_tpu.engine.expr import when as ref_when
import cudf_tpu_torch as ct
from cudf_tpu_torch import engine as pe
from cudf_tpu_torch.engine import ir as IRs
from cudf_tpu_torch.engine.optimizer import cse, optimize
from cudf_tpu_torch.utils.config import option_context

torch.set_num_threads(1)

CPU = torch.device("cpu")
N = 300
MODES = ["MAIL", "SHIP", "AIR", "TRUCK"]


def _pandas(seed=0, n=N):
    rng = np.random.default_rng(seed)
    f = rng.uniform(0, 100, n)
    f[rng.random(n) < 0.1] = np.nan
    return pd.DataFrame({
        "k": rng.integers(0, 20, n),
        "j": rng.integers(0, 3, n).astype(np.int32),
        "f": f,
        "q": rng.integers(1, 51, n).astype(np.float64),
        "m": rng.choice(MODES, n),
        "d": (rng.integers(8000, 10500, n).astype("datetime64[D]")
              .astype("datetime64[ns]")),
    })


def _frames(pdf):
    """(the port's frame, the reference's LazyFrame source frame)."""
    port = ct.from_pandas(pdf.assign(m=pd.Categorical(pdf["m"])), device=CPU)
    return port, cudf_tpu.DataFrame.from_pandas(pdf)


@pytest.fixture(scope="module")
def data():
    pdf = _pandas()
    port, ref = _frames(pdf)
    dim = pd.DataFrame({"k": np.arange(25), "w": np.arange(25) * 1.5,
                        "g": pd.Categorical(np.array(["x", "y", "z"])[np.arange(25) % 3])})
    return pdf, port, ref, dim


def _plain(df: pd.DataFrame) -> pd.DataFrame:
    """Categoricals and string columns as object strings, a fresh index."""
    out = df.reset_index(drop=True).copy()
    for c in out.columns:
        if isinstance(out[c].dtype, pd.CategoricalDtype) or out[c].dtype == object or \
                str(out[c].dtype) in ("str", "string"):
            out[c] = out[c].astype(object).where(out[c].notna(), None)
    return out


def check(got: pd.DataFrame, exp: pd.DataFrame, rtol=1e-12, sort_by=None):
    got, exp = _plain(got), _plain(exp)
    assert list(got.columns) == list(exp.columns)
    if sort_by:
        got = got.sort_values(sort_by).reset_index(drop=True)
        exp = exp.sort_values(sort_by).reset_index(drop=True)
    assert len(got) == len(exp)
    for c in exp.columns:
        g, e = got[c], exp[c]
        if e.dtype == object:
            assert g.tolist() == e.tolist(), c
        elif e.dtype.kind == "f" or g.dtype.kind == "f":
            np.testing.assert_allclose(g.to_numpy(float), e.to_numpy(float), rtol=rtol,
                                       err_msg=c)
        else:
            np.testing.assert_array_equal(g.to_numpy(), e.to_numpy(), err_msg=c)


def both(data, build):
    """The plan built over each engine's namespace, collected by each."""
    pdf, port, ref, _ = data
    got = build(pe, pe.from_dataframe(port)).collect().to_pandas()
    exp = build(ref_engine, ref_engine.from_dataframe(ref)).collect().to_pandas()
    return got, exp


def _when(ns):
    return pe.when if ns is pe else ref_when


PLANS = {
    "select": lambda ns, lf: lf.select(ns.col("k"), (ns.col("f") * 2 + ns.col("q")).alias("x"),
                                       ns.col("d")),
    "hstack": lambda ns, lf: lf.with_columns((ns.col("q") / ns.lit(4.0)).alias("r"),
                                             (ns.col("k") % 7).alias("k7")),
    "filter_temporal": lambda ns, lf: lf.filter(
        (ns.col("d") >= ns.lit(np.datetime64("1994-01-01")))
        & (ns.col("d") < ns.lit(np.datetime64("1995-01-01")))),
    "filter_dict_eq": lambda ns, lf: lf.filter(ns.col("m") == ns.lit("SHIP")),
    "filter_dict_isin": lambda ns, lf: lf.filter(ns.col("m").is_in(["MAIL", "AIR"])),
    "filter_int_isin": lambda ns, lf: lf.filter(ns.col("k").is_in([1, 5, 7])),
    "filter_null": lambda ns, lf: lf.filter(ns.col("f").is_not_null() & ~(ns.col("q") > 40)),
    "fill_null": lambda ns, lf: lf.select(ns.col("f").fill_null(-1.0), ns.col("q").round(0),
                                          ns.col("q").cast("int32").alias("qi")),
    "ternary": lambda ns, lf: lf.with_columns(
        _when(ns)(ns.col("m") == ns.lit("AIR")).then(ns.col("q")).otherwise(ns.lit(0.0))
        .alias("t"),
        _when(ns)(ns.col("k") > 10).then(ns.lit(1)).otherwise(ns.lit(0)).alias("big")),
    "groupby_int": lambda ns, lf: lf.group_by("k").agg(
        ns.col("f").sum().alias("s"), ns.col("q").mean().alias("mq"),
        ns.col("f").count().alias("c")).sort("k"),
    # min/max are left out here: the reference's reset scans compile ~4 s a
    # dtype; the port's min/max are held to the reference in the sort-tier
    # and groupby-slice tests
    "groupby_dict": lambda ns, lf: lf.group_by("m").agg(
        ns.col("q").sum().alias("s"), ns.col("k").count().alias("n")).sort("m"),
    "groupby_two_keys": lambda ns, lf: lf.group_by("m", "j").agg(
        ns.col("q").sum().alias("s"), ns.col("f").mean().alias("mf"),
        ns.col("q").median().alias("med")).sort(["m", "j"]),
    "reduce": lambda ns, lf: lf.agg(ns.col("f").sum().alias("s"), ns.col("q").mean().alias("m"),
                                    ns.col("k").max().alias("kmax"),
                                    ns.col("f").count().alias("c")),
    "sort_desc": lambda ns, lf: lf.sort(["m", "q", "k"], descending=[True, False, True]),
    "sort_temporal": lambda ns, lf: lf.sort(["d", "k", "q"]),
    "distinct": lambda ns, lf: lf.select(ns.col("m"), ns.col("j")).unique().sort(["m", "j"]),
    "head_tail_slice": lambda ns, lf: lf.sort(["k", "q", "d"]).slice(10, 25).head(20).tail(7),
    "drop_rename": lambda ns, lf: lf.drop("f", "d").rename({"k": "key"}),
    "concat": lambda ns, lf: lf.filter(ns.col("k") < 3).concat(lf.filter(ns.col("k") > 17)),
    "cache": lambda ns, lf: lf.filter(ns.col("q") > 25).cache().select(ns.col("k")),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_plans_match_reference_engine(data, name):
    got, exp = both(data, PLANS[name])
    check(got, exp, sort_by=["m", "j"] if name == "distinct" else None)


@pytest.mark.parametrize("radix", [False, True])
def test_join_matches_reference_and_pandas(data, radix):
    """An inner join (the dense tier, then the radix tier's plain path)
    with a dictionary payload, a groupby on it and a sort."""
    pdf, port, ref, dim = data
    dim_p = ct.from_pandas(dim, device=CPU)
    dim_r = cudf_tpu.DataFrame.from_pandas(dim.assign(g=dim["g"].astype(object)))

    def plan(ns, lf, d):
        return (lf.join(ns.from_dataframe(d), left_on="k", right_on="k")
                .with_columns((ns.col("q") * ns.col("w")).alias("qw"))
                .group_by("g").agg(ns.col("qw").sum().alias("s"),
                                   ns.col("k").count().alias("n")).sort("g"))

    with option_context("join.fast_path_min_rows", 1 if radix else 1 << 16):
        got = plan(pe, pe.from_dataframe(port), dim_p).collect().to_pandas()
    exp = plan(ref_engine, ref_engine.from_dataframe(ref), dim_r).collect().to_pandas()
    check(got, exp)
    m = pdf.merge(dim, on="k")
    pexp = (m.assign(qw=m.q * m.w).groupby("g", observed=True)
            .agg(s=("qw", "sum"), n=("k", "count")).reset_index())
    check(got, pexp)


def test_join_keeps_left_columns_and_suffixes(data):
    pdf, port, ref, _ = data
    other = pdf[["k", "q"]].drop_duplicates("k").assign(f=1.0)

    def plan(ns, lf, o):
        return lf.select(ns.col("k"), ns.col("f"), ns.col("m")).join(
            ns.from_dataframe(o), on="k")

    got = plan(pe, pe.from_dataframe(port), ct.from_pandas(other, device=CPU))
    exp = plan(ref_engine, ref_engine.from_dataframe(ref), cudf_tpu.DataFrame.from_pandas(other))
    assert got.columns == exp.columns == ["k", "f", "m", "q", "f_right"]
    check(got.collect().to_pandas(), exp.collect().to_pandas())


def test_hconcat_empty_and_error_nodes(data):
    pdf, port, ref, _ = data
    a = IRs.Select(IRs.DataFrameScan(port._table), [pe.col("k")])
    b = IRs.Select(IRs.DataFrameScan(port._table), [pe.col("q").alias("q2")])
    t = IRs.HConcat(a, b).evaluate()
    assert t.names == ("k", "q2") and t.num_rows == N
    empty = IRs.Empty(["x", "y"], device=CPU).evaluate()
    assert empty.names == ("x", "y") and empty.num_rows == 0
    with pytest.raises(RuntimeError, match="boom"):
        IRs.ErrorNode("boom").evaluate()


def test_optimizer_pushes_projections_fuses_filters_and_shares_subplans(data):
    pdf, port, ref, _ = data
    lf = (pe.from_dataframe(port).filter(pe.col("q") > 10).filter(pe.col("k") < 15)
          .group_by("k").agg(pe.col("f").sum().alias("s")))
    node = optimize(lf._node)
    scan = node.children[0].children[0]
    assert isinstance(node.children[0], IRs.Filter) and isinstance(scan, IRs.DataFrameScan)
    assert sorted(scan.projection) == ["f", "k", "q"]
    assert "Filter" in lf.explain() and lf.explain(optimized=False).count("Filter") == 2
    check(lf.collect().to_pandas(), lf.collect(no_optimization=True).to_pandas())
    src = pe.from_dataframe(port).filter(pe.col("q") > 40)
    u = src.concat(pe.from_dataframe(port).filter(pe.col("q") > 40))
    shared = cse(u._node)
    assert shared.children[0].children[0] is shared.children[1].children[0]


def test_dictionary_groupby_takes_the_onehot_tier(monkeypatch):
    """DataFrame.groupby and the engine's GroupBy on one dictionary key
    call kernel A's wrapper (the one-hot tier over the codes, K = the
    entries) and equal pandas; the output key is a STRING column."""
    from cudf_tpu_torch.ops import groupby as ops_groupby

    calls = []
    real = ops_groupby.onehot_groupby_aggregate

    def counting(keys, vals, K, *args, **kw):
        calls.append(K)
        return real(keys, vals, K, *args, **kw)

    monkeypatch.setattr(ops_groupby, "onehot_groupby_aggregate", counting)
    pdf = _pandas(3).assign(m=lambda d: pd.Categorical(d["m"]))
    pdf.loc[::9, "m"] = None
    port = ct.from_pandas(pdf, device=CPU)
    got = port.groupby("m").agg({"q": ["sum", "mean", "count"], "f": "max"}).to_pandas()
    exp = pdf.groupby("m", observed=True).agg({"q": ["sum", "mean", "count"], "f": "max"})
    assert calls == [len(MODES)] * 2          # one call a mask: q's (the key's), f's
    assert got.index.astype(str).tolist() == exp.index.astype(str).tolist()
    for c in exp.columns:
        np.testing.assert_allclose(got[c].to_numpy(float), exp[c].to_numpy(float), rtol=1e-12)
    res = (pe.from_dataframe(port).group_by("m").agg(pe.col("q").sum().alias("s"))
           .collect())
    assert calls == [len(MODES)] * 3 and res._table["m"].dtype.is_string


def _stamps(days, kind):
    if kind == "datetime":
        return [d.astype("datetime64[us]").item() for d in days]
    return list(days) if kind == "datetime64" else [pd.Timestamp(d) for d in days]


@pytest.mark.parametrize("kind", ["datetime64", "datetime", "timestamp"])
@pytest.mark.parametrize("count", [3, 40])
def test_temporal_is_in_matches_pandas(data, kind, count):
    """``is_in`` over a timestamp column takes numpy's, the standard
    library's and pandas' timestamps as pandas' ``isin`` does: by one
    equality pass a value up to 16 values, by the search past them."""
    pdf, port, _, _ = data
    days = np.unique(pdf["d"].to_numpy())[::7][:count]
    values = _stamps(days, kind)
    got = (pe.from_dataframe(port).filter(pe.col("d").is_in(values))
           .select(pe.col("k"), pe.col("d")).collect().to_pandas())
    check(got, pdf.loc[pdf["d"].isin(values), ["k", "d"]])


def test_unported_paths_raise_naming_their_item(data):
    """Every path of ``collect`` is ported: a ``mesh`` that is neither a
    partition count, "auto" nor a ``parallel.Mesh`` raises TypeError; a
    partition count, "auto", ``streaming=True``, ``map_batches`` and
    ``PythonScan`` run (``tests/test_torch_streaming.py``; a Mesh:
    ``tests/test_torch_spmd.py``)."""
    pdf, port, ref, _ = data
    lf = pe.from_dataframe(port)
    cases = [
        (lambda: lf.collect(mesh=(2, 2)), "parallel.Mesh"),
        (lambda: lf.collect(mesh=4.0), "parallel.Mesh"),
        (lambda: lf.collect(mesh=object(), streaming=True), "parallel.Mesh"),
    ]
    for fn, item in cases:
        with pytest.raises(TypeError, match=item):
            fn()
    assert len(lf.collect(mesh=4)) == len(lf.collect(streaming=True)) == len(pdf)
    assert len(lf.map_batches(lambda t: t).collect()) == len(pdf)
    assert IRs.PythonScan(lambda: port).schema() == list(port._table.names)
