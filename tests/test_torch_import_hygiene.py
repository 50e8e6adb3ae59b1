"""cudf_tpu_torch imports neither JAX nor the reference package (its
engine, models and ops modules included, the join family's too), and
the groupby (both the kernel tiers and the sort tier), merge (every
``how``, the sort-merge tier included) and LazyFrame engine paths on CPU
tensors (the nine TPC-H queries over dictionary, string and temporal
columns) and the nine TPC-H queries in pandas' API over the port's frames
(``tpch.FRAME_QUERIES``), Series methods among them, touch neither
pandas nor pyarrow; nor do the string and temporal modules (``ops/strings.py``,
``regex_engine.py``, ``string_spans.py``, ``unicode_case.py``,
``datetime.py``, ``timezone.py``, ``frame/accessors.py``,
``models/strings_dt.py``), nor the LIST, STRUCT and decimal modules
(``ops/lists.py``, ``structs.py``, ``decimal.py``, ``decimal128.py``, the
list aggregations of ``ops/groupby.py``, ``models/nested.py``), nor the
ops and windows (``ops/hashing.py``, ``partitioning.py``, ``bloom.py``,
``pack.py``, ``tdigest.py``, ``text.py``, ``frame/window.py``,
``resample.py``, ``asof.py``, ``eval_expr.py``, ``utils/tracing.py``,
``models/ops_windows.py``), nor the file formats (``io/``,
``arrow_cdata.py``, ``models/io_paths.py``: every request on the native
routes), nor the other formats (JSON, ORC, Avro, the tpudf file, text and
the stream consumer: every ``models/io_formats.py`` request), nor the
partitioned executor and its spilling (``engine/streaming.py``,
``utils/spill.py``, ``testing.py``: every ``models/partitioned.py``
request); the host IO
library builds only from the package's own C++ source into
``build/cudf_tpu_torch/``, and a failed build raises."""

import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "cudf_tpu_torch"

_PROBE = """
import sys
import torch
import cudf_tpu_torch as ct
from cudf_tpu_torch.utils.config import option_context
df = ct.DataFrame({"k": torch.tensor([3, 1, 3, 2], dtype=torch.int32),
                   "v": torch.tensor([1.0, 2.0, 3.0, 4.0])})
out = df.groupby("k").agg({"v": ["sum", "mean", "count"]})
assert len(out) == 3, len(out)
assert out._table[("v", "sum")].data.tolist() == [2.0, 4.0, 4.0]
two = ct.DataFrame({"k": df._table["k"].data, "j": torch.tensor([0, 1, 0, 1]),
                   "v": df._table["v"].data})
med = two.groupby(["k", "j"], sort=False).agg({"v": ["median", "std"]})   # the sort tier
assert med._table[("v", "median")].data.tolist() == [2.0, 2.0, 4.0], med
fact = ct.DataFrame({"k": torch.arange(100, dtype=torch.int32) % 4,
                     "v": torch.arange(100.0)})
dim = ct.DataFrame({"k": torch.tensor([3, 2]), "w": torch.tensor([5.0, 6.0])})
for rows in (0, 1 << 16):               # the radix tier, then the dense tier
    with option_context("join.fast_path_min_rows", rows):
        joined = fact.merge(dim, on="k")
    assert joined._table["w"].data.tolist() == [6.0, 5.0] * 25, rows
for how in ("left", "outer", "right", "semi", "anti", "cross"):  # the sort-merge tier
    fact.merge(dim, how=how, **({} if how == "cross" else {"on": "k"}))
two = fact.merge(fact, on=["k", "v"], how="left", sort=True)
assert len(two) == 100, len(two)
from cudf_tpu_torch.models import tpch
tables = tpch.generate_device(0.002, seed=1, device="cpu")
assert len(tpch.q1(tables)) == 6 and tpch.q14(tables) > 0
assert tpch.q6(tables)._table.names == ("revenue",) and len(tpch.q12(tables)) == 2
for q in ("q3", "q4", "q5", "q9", "q10"):
    tpch.QUERIES[q](tables)
for q, fn in tpch.FRAME_QUERIES.items():       # the pandas API on the port's frames
    fn(tables)
s = ct.Series(torch.tensor([1.0, float("nan"), 3.0]), name="s")
s.isin([1.0]).sum(), s.fillna(0.0).cumsum().max(), s.value_counts(), s.astype("category")
s.where(s > 1, 0.0).shift(1).ffill().dropna().sort_values().head(2).quantile(0.5)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "cudf_tpu", "pandas", "pyarrow"))
print("LOADED", bad)
"""


def test_groupby_on_cpu_tensors_imports_no_jax_reference_or_pandas():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "LOADED []" in proc.stdout, proc.stdout


_FRAME_API_PROBE = """
import sys
sys.modules["pandas"] = None            # neither can be imported from here on
sys.modules["jax"] = None
import torch
import cudf_tpu_torch as ct
df = ct.DataFrame({"k": torch.tensor([1, 2, 1, 2], dtype=torch.int32),
                   "c": torch.tensor([5, 5, 6, 6]), "v": torch.tensor([1.0, 2.0, 3.0, 4.0])})
grid = ct.pivot_table(df, values="v", index="k", columns="c", aggfunc="sum")
assert grid._table[5].data.tolist() == [1.0, 2.0], grid
assert ct.crosstab(df["k"], df["c"])._table[6].data.tolist() == [1, 1]
assert df.groupby(["k", "c"])["v"].sum().unstack()._table[6].data.tolist() == [3.0, 4.0]
assert len(ct.melt(df, id_vars="k")) == 8
assert len(ct.concat([df, df.iloc[:2]])) == 6
days = ct.date_range("2020-01-01", periods=3, freq="D", device="cpu")
assert days._column.data.tolist() == [(1577836800 + 86400 * i) * 10**6 for i in range(3)]
assert ct.cut(df["v"], 2, labels=False)._column.data.tolist() == [0, 0, 1, 1]
assert ct.cut(df["v"], 2).to_numpy().tolist() == ["(0.997, 2.5]"] * 2 + ["(2.5, 4.0]"] * 2
assert df["v"].apply(lambda x: x * 2.0 + 1.0)._column.data.tolist() == [3.0, 5.0, 7.0, 9.0]
assert ct.frame.series.UDF_ROUTES == {"vmap": 1, "host": 0}
print("FRAME API OK")
"""


def test_reshapes_tools_and_udfs_run_without_pandas_or_jax():
    """pivot_table, crosstab, unstack, melt, concat, date_range of a fixed
    frequency, cut and a vmapped Series.apply with pandas and jax
    unimportable."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _FRAME_API_PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "FRAME API OK" in proc.stdout, proc.stdout


_STRINGS_PROBE = """
import sys
sys.modules["pandas"] = None            # none of these can be imported from here on
sys.modules["pyarrow"] = None
sys.modules["jax"] = None
import torch
import cudf_tpu_torch as ct
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.models import strings_dt as sd, tpch
from cudf_tpu_torch.ops.strings import STRING_ROUTES
s = ct.Series(Column.from_strings(["id0000000123", "ñandú", None], device="cpu"))
assert s.str.len()._column.data.tolist()[:2] == [12, 5]
assert s.str.fullmatch(r".{5}")._column.data.tolist() == [False, True, False]
assert s.str.replace(r"0+", "-", regex=True)._column.host_strings()[0] == "id-123"
assert ct.to_numeric(s.str.slice(2), errors="coerce")._column.data[0].item() == 123.0
g = torch.Generator().manual_seed(1)
df = ct.DataFrame({"v1": torch.randint(1, 6, (400,), generator=g, dtype=torch.int32),
                   "v3": torch.rand(400, generator=g, dtype=torch.float64)})
for name, k, w in (("id1", 100, 3), ("id3", 80, 10)):
    keys = Column.from_strings([f"id{i:0{w}d}" for i in range(1, k + 1)], device="cpu")
    df[name] = Column.from_dictionary(torch.randint(0, k, (400,), generator=g,
                                                    dtype=torch.int32), keys)
li = tpch.generate_device(0.0002, seed=1, device="cpu")["lineitem"]
frames = sd.prepare({"g1": df, "lineitem": li})
for name, request in sd.REQUESTS.items():
    request(frames)
assert STRING_ROUTES["host"] == 0, STRING_ROUTES
print("STRINGS OK", sorted(m for m, mod in sys.modules.items()
                           if mod is not None and m.split(".")[0] in ("jax", "cudf_tpu")))
"""


def test_strings_and_temporals_run_without_pandas_pyarrow_or_jax():
    """The ``str``, ``dt`` and ``cat`` accessors, the device regex, the
    parsers and every ``models/strings_dt.py`` request with pandas,
    pyarrow and jax unimportable, none taking the host route."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _STRINGS_PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "STRINGS OK []" in proc.stdout, proc.stdout


_NESTED_PROBE = """
import sys
sys.modules["pandas"] = None            # none of these can be imported from here on
sys.modules["pyarrow"] = None
sys.modules["jax"] = None
import decimal
import torch
import cudf_tpu_torch as ct
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.models import nested, strings_dt as sd, tpch
from cudf_tpu_torch.ops import decimal128, lists, structs
from cudf_tpu_torch.ops._utils import HOST_ROUTES
from cudf_tpu_torch.ops.strings import STRING_ROUTES
g = torch.Generator().manual_seed(1)
n = 600
def ints(lo, hi):
    return torch.randint(lo, hi + 1, (n,), generator=g, dtype=torch.int32)
df = ct.DataFrame({"id4": ints(1, 100), "id6": ints(1, 60), "v1": ints(1, 5),
                   "v2": ints(1, 15), "v3": torch.rand(n, generator=g, dtype=torch.float64)})
for name, k, w in (("id1", 100, 3), ("id3", 120, 10)):
    keys = Column.from_strings([f"id{i:0{w}d}" for i in range(1, k + 1)], device="cpu")
    df[name] = Column.from_dictionary(torch.randint(0, k, (n,), generator=g,
                                                    dtype=torch.int32), keys)
li = tpch.generate_device(0.0002, seed=1, device="cpu")["lineitem"]
frames = sd.prepare({"g1": df, "lineitem": li})
for name, request in nested.REQUESTS.items():
    got = nested.ANSWERS[name](request(frames), frames)
    exp = nested.PLAIN[name](frames)
    assert all(torch.equal(got[k], exp[k]) for k in exp), name
assert STRING_ROUTES["host"] == 0 and HOST_ROUTES == {}, (STRING_ROUTES, HOST_ROUTES)
s = ct.Series([[1, 2], None, []], device="cpu")
assert s.explode().tolist()[:2] == [1, 2] and s.list.len().tolist()[0] == 2
assert structs.from_pydicts([{"a": 1}, None], device="cpu").to_pylist() == [{"a": 1}, None]
d = ct.Series([decimal.Decimal("1.25"), None], device="cpu")
assert (d * d).tolist()[0] == decimal.Decimal("1.5625")
print("NESTED OK", sorted(m for m, mod in sys.modules.items()
                          if mod is not None and m.split(".")[0] in ("jax", "cudf_tpu")))
"""


def test_nested_and_decimal_run_without_pandas_pyarrow_or_jax():
    """Every ``models/nested.py`` request (list aggregations, explode, the
    list and struct accessors, split and findall into lists, the decimal
    casts and arithmetic) with pandas, pyarrow and jax unimportable, none
    taking a host route."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _NESTED_PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "NESTED OK []" in proc.stdout, proc.stdout


_OPS_WINDOWS_PROBE = """
import sys
sys.modules["pandas"] = None            # none of these can be imported from here on
sys.modules["pyarrow"] = None
sys.modules["jax"] = None
import math
import numpy as np
import torch
import cudf_tpu_torch as ct
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.models import ops_windows as ow, tpch
from cudf_tpu_torch.ops import bloom, hashing, pack, partitioning, tdigest, text
from cudf_tpu_torch.utils import tracing
g = torch.Generator().manual_seed(1)
n = 1500
def ints(lo, hi):
    return torch.randint(lo, hi + 1, (n,), generator=g, dtype=torch.int32)
df = ct.DataFrame({"id4": ints(1, 100), "id6": ints(1, 1000), "v1": ints(1, 5),
                   "v2": ints(1, 15), "v3": torch.rand(n, generator=g, dtype=torch.float64) * 100,
                   "id5": ints(1, 100)})
for name, k, w in (("id1", 100, 3), ("id2", 100, 3), ("id3", 1000, 10)):
    keys = Column.from_strings([f"id{i:0{w}d}" for i in range(1, k + 1)], device="cpu")
    df[name] = Column.from_dictionary(torch.randint(0, k, (n,), generator=g,
                                                    dtype=torch.int32), keys)
ow.WINDOW, ow.TEXT_ROWS_SMALL = 40, 500
ow.HOST_ROWS.update({k: 100 for k in ow.HOST_ROWS})
frames = ow.prepare({"g1": df, "lineitem": tpch.generate_device(0.001, seed=1,
                                                                device="cpu")["lineitem"],
                     "dim": ct.DataFrame({"id": torch.randperm(300, generator=g,
                                                               dtype=torch.int32) + 1}),
                     "fact": ct.DataFrame({"id": ints(1, 330)})})
for name, request in ow.REQUESTS.items():
    got, exp = ow.ANSWERS[name](request(frames), frames), ow.PLAIN[name](frames)
    assert list(got) == list(exp), name
    for k in exp:
        a, b = got[k], exp[k]
        if a.is_floating_point():
            assert torch.allclose(a, b, rtol=max(ow.RTOL[name], 1e-12), equal_nan=True), name
        else:
            assert torch.equal(a, b), (name, k)
with tracing.enable_tracing() as t:
    with t.range("r"):
        ct.Series([1.0, 2.0], device="cpu").rolling(2).sum()
assert "r" in t.summary()
print("OPS OK", sorted(m for m, mod in sys.modules.items()
                       if mod is not None and m.split(".")[0] in ("jax", "cudf_tpu")))
"""


def test_ops_and_windows_run_without_pandas_pyarrow_or_jax():
    """Every ``models/ops_windows.py`` request (hashes, partitions, pack,
    tdigest, rolling, ewm, resample, merge_asof, query/eval, the text
    functions, the bloom filter, day units) equal to its plain version,
    and the tracer, with pandas, pyarrow and jax unimportable."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _OPS_WINDOWS_PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "OPS OK []" in proc.stdout, proc.stdout


_IO_PROBE = """
import sys, tempfile
sys.modules["pandas"] = None            # none of these can be imported from here on
sys.modules["pyarrow"] = None
sys.modules["jax"] = None
from cudf_tpu_torch.io import IO_ROUTES
from cudf_tpu_torch.models import io_paths as iop, tpch
d = tempfile.mkdtemp()
t = tpch.generate_device(0.002, seed=3, device="cpu")
g1 = iop.g1_frame(3000, device="cpu")
frames = {"dir": d, "device": "cpu", "taxi": iop.taxi_frame(3000, device="cpu"), "g1": g1,
          "tpch": dict(t, lineitem=t["lineitem"].sort_values("l_shipdate")
                       .reset_index(drop=True))}
iop.write_bytes(d + "/g1.csv", iop.g1_csv(g1))
frames["nested_list"], frames["nested_struct"] = iop.nested_frame(g1)
for group in ("taxi", "tpch", "g1"):
    for name in iop.GROUPS[group]:
        res = iop.REQUESTS[name](frames)
        if name == "g1_read_csv":
            frames["g1_csv"] = res
        err = iop.PLAIN[name](frames, res)
        assert err <= (1.0 if name == "g1_read_csv" else 1e-6), (name, err)
assert set(iop.ROUTE.values()) == {"native"} and set(iop.REQUESTS) == set(iop.PLAIN)
assert IO_ROUTES["pyarrow"] == 0 and IO_ROUTES["native"] > 0, IO_ROUTES
print("IO OK", sorted(m for m, mod in sys.modules.items()
                      if mod is not None and m.split(".")[0] in ("jax", "cudf_tpu")))
"""


def test_io_requests_run_without_pandas_pyarrow_or_jax():
    """Every ``models/io_paths.py`` request (the taxi month, TPC-H from
    Parquet with its sink, G1 from CSV with its questions, the nested
    columns, the Arrow C stream) equal to its plain check, on the native
    routes, with pandas, pyarrow and jax unimportable."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _IO_PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "IO OK []" in proc.stdout, proc.stdout


_IO_FORMATS_PROBE = """
import sys, tempfile
sys.modules["pandas"] = None            # none of these can be imported from here on
sys.modules["pyarrow"] = None
sys.modules["jax"] = None
from cudf_tpu_torch.io import IO_ROUTES
from cudf_tpu_torch.models import io_formats as iof, io_paths as iop
iof.RECORDS_ROWS = 400
frames = iof.prepare(iop.g1_frame(2000, device="cpu"), iop.taxi_frame(1500, device="cpu"),
                     tempfile.mkdtemp(), "cpu")
for group, names in iof.GROUPS.items():
    for name in names:
        res = iof.REQUESTS[name](frames)
        if name in iof.KEEP:
            frames[iof.KEEP[name]] = res
        assert iof.PLAIN[name](frames, res) <= 1.0, name
assert IO_ROUTES["pyarrow"] == 0 and IO_ROUTES["pandas"] == 0 and IO_ROUTES["native"] > 0, \
    IO_ROUTES
print("FORMATS OK", sorted(m for m, mod in sys.modules.items()
                           if mod is not None and m.split(".")[0] in ("jax", "cudf_tpu")))
"""


def test_the_other_formats_run_without_pandas_pyarrow_or_jax():
    """Every ``models/io_formats.py`` request (NDJSON written and read, G1
    q1-q5 over it, the records orient, ORC snappy and zlib both ways, Avro
    null and deflate, the tpudf file, read_text, the stream consumer) equal
    to its plain check, on the native routes, with pandas, pyarrow and jax
    unimportable."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _IO_FORMATS_PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "FORMATS OK []" in proc.stdout, proc.stdout


_PARTITIONED_PROBE = """
import sys, tempfile
sys.modules["pandas"] = None            # none of these can be imported from here on
sys.modules["pyarrow"] = None
sys.modules["jax"] = None
import numpy as np
import torch
import cudf_tpu_torch as ct
from cudf_tpu_torch import testing
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.engine import streaming
from cudf_tpu_torch.io import IO_ROUTES
from cudf_tpu_torch.models import partitioned as pm, tpch
from cudf_tpu_torch.ops import dictionary
from cudf_tpu_torch.utils import spill
from cudf_tpu_torch.utils.config import option_context
t = tpch.generate_device(0.002, seed=3, device="cpu")
paths = pm.write_tpch_dataset(t, tempfile.mkdtemp(), files=3)
frames = {"tpch": t, "dataset": pm.tpch_dataset(paths, "cpu"),
          "g1": pm.g1_frame(20_000, device="cpu")}
frames["fact"], frames["dim"] = pm.j1_frames(20_000, device="cpu")
pm.SPILL_BUDGET = 4 << 10
stats = spill.get_spill_manager().statistics
with option_context("executor.target_partition_size", 1 << 17):
    for name, request in pm.REQUESTS.items():
        before = stats.spills
        assert pm.PLAIN[name](frames, request(frames)) <= 1e-6, name
        assert name not in pm.SPILLS or stats.spills > before, name
assert IO_ROUTES["pyarrow"] == 0 and IO_ROUTES["native"] > 0, IO_ROUTES
days = Column.from_numpy(np.array([3, 1, 3], "datetime64[D]"), device="cpu")
assert dictionary.encode(days).keys.to_numpy().tolist() == \\
    np.array([1, 3], "datetime64[D]").tolist()
df = ct.DataFrame({"v": torch.arange(10.0)})
spill.spill(df)
spill.unspill(df)
assert df._table["v"].data.tolist() == list(range(10))
try:
    testing.assert_eq(1.0, 2.0)
except AssertionError:
    pass
print("PARTITIONED OK", sorted(m for m, mod in sys.modules.items()
                               if mod is not None and m.split(".")[0] in ("jax", "cudf_tpu")))
"""


def test_the_partitioned_executor_runs_without_pandas_pyarrow_or_jax():
    """Every ``models/partitioned.py`` request (the nine TPC-H queries
    streamed over a multi-file Parquet dataset, spilling off and on, the
    G1 groupby and the J1 joins at ``mesh=8``) equal to the in-memory
    executor, the spill round trip, a temporal dictionary and
    ``testing.assert_eq`` on scalars, with pandas, pyarrow and jax
    unimportable."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _PARTITIONED_PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "PARTITIONED OK []" in proc.stdout, proc.stdout


_DISTRIBUTED_PROBE = """
import sys
sys.modules["pandas"] = None            # none of these can be imported from here on
sys.modules["pyarrow"] = None
sys.modules["jax"] = None
from cudf_tpu_torch.engine import get_fallback_stats, reset_fallback_stats
from cudf_tpu_torch.models import distributed as dm, partitioned as pm, tpch
from cudf_tpu_torch.parallel import bootstrap, make_mesh
from cudf_tpu_torch.parallel.dryrun import main
mesh = make_mesh(device="cpu")              # one rank over gloo
frames = {"g1": dm.g1_frame(20_000, device="cpu"),
          "tpch": tpch.generate_device(0.002, seed=3, device="cpu")}
frames["fact"], frames["dim"] = pm.j1_frames(20_000, device="cpu")
for name, request in dm.REQUESTS.items():
    reset_fallback_stats()
    assert dm.PLAIN[name](frames, request(frames, mesh)) <= 1e-6, name
    assert get_fallback_stats()["count"] == 0, name
bootstrap.shutdown()
assert main(["2"]) == 0                     # the dry run over two gloo processes
bad = sorted(m for m, mod in sys.modules.items()
             if mod is not None and m.split(".")[0] in ("jax", "cudf_tpu"))
print("DISTRIBUTED OK", bad)
"""


def test_the_distributed_paths_run_without_pandas_pyarrow_or_jax():
    """Every ``models/distributed.py`` request over a one-rank gloo mesh
    equal to the in-memory executor with no fallback, then the dry run
    (``parallel/dryrun.py``) over two gloo processes, whose ranks report no
    jax, reference, pandas or pyarrow module loaded, with pandas, pyarrow
    and jax unimportable here."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _DISTRIBUTED_PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "DISTRIBUTED OK []" in proc.stdout, proc.stdout
    assert '"foreign_modules": []' in proc.stdout, proc.stdout


def test_the_distributed_modules_import_no_jax_or_reference():
    """The modules of the multi-rank slice exist and import neither jax
    nor the reference (``test_package_sources_import_no_jax_or_reference``
    checks every module; these are named so that none can go missing)."""
    files = [PACKAGE / "parallel" / f"{m}.py" for m in
             ("__init__", "bootstrap", "mesh", "shuffle", "dist", "dryrun")]
    files += [PACKAGE / "engine" / "spmd.py", PACKAGE / "models" / "distributed.py"]
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "cudf_tpu"), f"{path}: {name}"


def test_host_library_builds_from_the_package_source_only():
    """The loader compiles cudf_tpu_torch/csrc/host/io_host.cpp and loads
    from build/cudf_tpu_torch/, never the reference's csrc/ or build/native/."""
    from cudf_tpu_torch.io import _native

    assert _native.SOURCE == PACKAGE / "csrc" / "host" / "io_host.cpp"
    assert _native.library_path().parent == ROOT / "build" / "cudf_tpu_torch"
    assert _native.build().parent == ROOT / "build" / "cudf_tpu_torch"
    loaded = Path(_native.lib()._name)
    assert loaded.parent == ROOT / "build" / "cudf_tpu_torch"
    assert loaded.name.startswith("libio_host_")


def test_a_failed_host_library_build_raises(tmp_path, monkeypatch):
    """No silent fallback: a compiler that is not there raises."""
    from cudf_tpu_torch.io import _native

    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_native, "CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(_native, "_lib", None)
    import pytest

    with pytest.raises(RuntimeError, match="io_host.cpp"):
        _native.lib()
    with pytest.raises(RuntimeError):
        _native.snappy_compress(b"abc")


def test_package_sources_import_no_jax_or_reference():
    sources = sorted(PACKAGE.rglob("*.py"))
    assert sources
    for path in sources:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "cudf_tpu"), f"{path}: {name}"
