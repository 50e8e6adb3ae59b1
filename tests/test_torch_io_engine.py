"""The engine's file ``Scan`` and ``Sink`` (``engine/ir.py``), with the
projection and predicate pushed into the Parquet reader
(``engine/optimizer.py``), against the reference's engine over the same
files (``benchmarks/tpch.py``'s q6 with its sources swapped for
``scan_parquet``) and against the port's own in-memory answers.

The files are written by the port's writer from ``generate(0.002,
seed=7)`` (lineitem sorted by ``l_shipdate``, row groups of 2000 rows,
so that q6's dates prune row groups).  The whole slice runs once with
the join on its kernel path (kernels B, F, G, D, H as plain PyTorch on
the CPU): write, scan, q12, equal to q12 in memory.  q12 against the
reference's engine is in ``test_torch_io_engine_q12.py`` (its join
compiles for 20-30 s).  Keys and counts exact, float sums rtol 1e-9.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from benchmarks import tpch as ref_tpch
import torch_jax_cache  # noqa: F401  (the run's shared JAX compile cache)
from cudf_tpu.engine import lazy as ref_lazy

from cudf_tpu_torch.engine import col, lit, scan_parquet
from cudf_tpu_torch.engine import ir
from cudf_tpu_torch.io import IO_ROUTES
from cudf_tpu_torch.io import parquet_native as pn
from cudf_tpu_torch.models import tpch
from cudf_tpu_torch.utils.config import option_context

CPU = torch.device("cpu")
RTOL = 1e-9


@pytest.fixture(scope="module")
def tables():
    t = tpch.generate(0.002, seed=7, device=CPU)
    return dict(t, lineitem=t["lineitem"].sort_values("l_shipdate").reset_index(drop=True))


@pytest.fixture(scope="module")
def files(tables, tmp_path_factory):
    d = tmp_path_factory.mktemp("tpch")
    for name in ("lineitem", "orders", "part"):
        tables[name].to_parquet(d / f"{name}.parquet", row_group_size=2000)
    return {name: str(d / f"{name}.parquet") for name in ("lineitem", "orders", "part")}


def _scans(files):
    return {n: scan_parquet(p, device=CPU) for n, p in files.items()}


def _frame(df):
    out = df.to_pandas().reset_index(drop=True)
    for c in out.columns:
        if out[c].dtype.kind not in "fiub":
            out[c] = out[c].astype(str)
    return out


def _check(got, exp):
    if isinstance(exp, float):
        np.testing.assert_allclose(got, exp, rtol=RTOL)
        return
    got, exp = _frame(got), _frame(exp)
    assert list(got.columns) == list(exp.columns) and len(got) == len(exp)
    for c in exp.columns:
        if exp[c].dtype.kind == "f":
            np.testing.assert_allclose(got[c].to_numpy(), exp[c].to_numpy(), rtol=RTOL)
        else:
            assert got[c].tolist() == exp[c].tolist(), c


def test_q6_from_parquet_against_the_reference_engine(files, tables, monkeypatch):
    before = IO_ROUTES["pyarrow"]
    pn.PAGE_COUNTERS.update(decoded=0, skipped=0)
    got = tpch.q6(_scans(files))
    pushed = dict(pn.PAGE_COUNTERS)
    assert IO_ROUTES["pyarrow"] == before
    orig = ref_tpch.from_dataframe
    monkeypatch.setattr(ref_tpch, "from_dataframe",
                        lambda t: t if isinstance(t, ref_lazy.LazyFrame) else orig(t))
    exp = ref_tpch.q6({"lineitem": ref_lazy.scan_parquet(files["lineitem"])})
    _check(got, exp)
    _check(got, tpch.q6(tables))
    # the same answer without the pushdown, reading every row group of the
    # projected columns
    columns = ["l_shipdate", "l_discount", "l_quantity", "l_extendedprice"]
    pn.PAGE_COUNTERS.update(decoded=0, skipped=0)
    unpushed = tpch.q6({"lineitem": scan_parquet(files["lineitem"], columns, device=CPU)},
                       no_optimization=True)
    _check(got, unpushed)
    assert pushed["decoded"] < pn.PAGE_COUNTERS["decoded"] == 6 * len(columns)


def test_the_plan_holds_the_pushdown(files):
    lf = scan_parquet(files["lineitem"], device=CPU).filter(
        (col("l_discount") >= lit(0.05)) & (col("l_tax") < col("l_discount"))
    ).select("l_orderkey")
    node = lf.optimized()
    scan = node.children[0]
    assert isinstance(scan, ir.Scan) and scan.projection == ["l_orderkey"]
    assert scan._read_cols() == ["l_orderkey", "l_discount", "l_tax"]
    assert ir.predicate_to_filters(scan.predicate) == [("l_discount", ">=", 0.05)]
    got = _frame(lf.collect())
    pdf = pd.read_parquet(files["lineitem"])
    want = pdf[(pdf.l_discount >= 0.05) & (pdf.l_tax < pdf.l_discount)][["l_orderkey"]]
    assert got["l_orderkey"].tolist() == want["l_orderkey"].tolist()


@pytest.mark.parametrize("q", ["q1", "q14"])
def test_queries_from_parquet_equal_their_in_memory_answers(files, tables, q):
    _check(tpch.QUERIES[q](_scans(files)), tpch.QUERIES[q](tables))


def test_sink_parquet_reads_back(files, tmp_path):
    import cudf_tpu_torch as ct

    out = str(tmp_path / "q1.parquet")
    lf = scan_parquet(files["lineitem"], device=CPU).group_by("l_returnflag").agg(
        col("l_quantity").sum().alias("qty"), col("l_quantity").count().alias("n")
    ).sort("l_returnflag")
    written = lf.sink_parquet(out).collect()
    _check(ct.read_parquet(out, device=CPU), written)
    assert pd.read_parquet(out)["qty"].tolist() == written.to_pandas()["qty"].tolist()


def test_the_whole_slice_with_the_join_kernels(tables, tmp_path):
    """Write -> read -> q12 with the radix join tier (kernels B, F, G, D
    and H on their plain versions) equals q12 over the frames in memory."""
    paths = {}
    for name in ("lineitem", "orders"):
        paths[name] = str(tmp_path / f"{name}.parquet")
        tables[name].to_parquet(paths[name])
    with option_context("join.fast_path_min_rows", 1):
        got = tpch.q12(_scans(paths))
        exp = tpch.q12(tables)
    _check(got, exp)
    assert tpch.answer("q12", got)[0] == tpch.answer("q12", exp)[0] == ["MAIL", "SHIP"]


@pytest.mark.parametrize("name", ["read_json", "read_orc", "read_avro", "read_feather",
                                  "read_tpudf", "read_text"])
def test_the_rest_of_item_7_raises_naming_it(name, tmp_path):
    """The rest of item 7 is ported: each reader reads a file of its
    format (the Avro one from the G1 encoder of ``models/io_formats.py``)."""
    import cudf_tpu_torch as ct
    from cudf_tpu_torch.models import io_formats, io_paths

    g = io_paths.g1_frame(200, seed=1, device=CPU)
    path = str(tmp_path / "file")
    write = {"read_json": lambda: g.to_json(path, lines=True),
             "read_orc": lambda: g.to_orc(path),
             "read_avro": lambda: open(path, "wb").write(io_formats.g1_avro(g)),
             "read_feather": lambda: g.to_feather(path),
             "read_tpudf": lambda: g.to_tpudf(path),
             "read_text": lambda: g.to_json(path, lines=True)}
    write[name]()
    got = getattr(ct, name)(path, **({"lines": True} if name == "read_json" else {}),
                            device=CPU)
    assert len(got) == 200
    if name != "read_text":
        assert io_formats.g1_equal(got, g, name) <= 1.0
