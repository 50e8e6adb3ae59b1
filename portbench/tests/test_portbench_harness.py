"""The harness end to end on the CPU: a tiny run through its own
functions (the command refuses without a CUDA device), pieces found by
name alone, the result line's keys, the import check, the byte counts
behind ``kernel_roofline_share``, and ``correct`` coming out false under
the control and under each fault a cell can have."""

import ast
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from portbench import harness
from portbench.datagen.common import Data
from portbench.tasks import groupby, join
from portbench.tests.conftest import ROOT, small_spec

TINY = r'''
import json, sys, time
t0 = time.perf_counter()
from portbench import harness, run
spec = json.loads(open("BENCHMARK.json").read())
device = {"platform": "cpu", "kind": "cpu", "count": 1}
for traced in (False, True):
    cell = harness.load_cell("tiny_cell", spec)
    assert run.finish(harness.run(cell, 2 ** 34 + 9, 0.2, traced, "cpu", t0), device,
                      traced) == 0
print(json.dumps({"forbidden": harness.forbidden_modules(),
                  "top": sorted({m.split(".")[0] for m in sys.modules})}))
print("jax cell", flush=True)
cell = harness.load_cell("tiny_jax_cell", spec)
rc = run.finish(harness.run(cell, 2 ** 34 + 9, 0.2, True, "cpu", t0), device, True)
print(json.dumps({"rc": rc}))
'''


def test_tiny_run_finds_pieces_by_name(tmp_path):
    """A throwaway mix and per-layer metric, added as files under a copy of
    the benchmark, are found by name alone; each result line carries every
    key a result has, ``checks`` last; no JAX module is loaded.  A metric
    that loads a module named ``jax`` after the window has closed stops
    the result: exit 3, no line."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = small_spec(tmp_path)
    (tmp_path / "portbench" / "mixes" / "tiny_mix.json").write_text(json.dumps(
        {"task": "groupby", "questions": ["q2", "q9"], "loop": "closed", "clients": 1,
         "order": "round robin"}))
    (tmp_path / "portbench" / "metrics" / "tiny_queries.py").write_text(
        "def read(trace):\n    return float(len(trace.queries)) or None\n")
    (tmp_path / "portbench" / "metrics" / "tiny_jax.py").write_text(
        "import jax\n\n\ndef read(trace):\n    return 1.0\n")
    (tmp_path / "stub" / "jax").mkdir(parents=True)
    (tmp_path / "stub" / "jax" / "__init__.py").write_text("")
    for cell, metric in (("tiny_cell", "tiny_queries"), ("tiny_jax_cell", "tiny_jax")):
        spec["workloads"].append({"name": cell, "config": "G1_1e8_1e2_0_0",
                                  "traffic": "tiny_mix", "chips": 1, "why": "a test's cell"})
        spec["per_layer"].append({"name": metric, "unit": "queries", "better": "higher",
                                  "source": "program_span", "layer": "frame",
                                  "moves": "rows_per_s", "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    proc = subprocess.run([sys.executable, "-c", TINY], cwd=tmp_path, capture_output=True,
                          text=True, timeout=300,
                          env={"PYTHONPATH": f"{ROOT}:{tmp_path / 'stub'}",
                               "PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    results = [json.loads(x) for x in lines if x.startswith('{"correct"')]
    plain, traced = results[:2]
    mods = json.loads(lines[lines.index("jax cell") - 1])
    for line in (plain, traced):
        assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 2
        assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
        assert list(line)[-1] == "checks"
        assert set(line["checks"]) == {"q2.mismatch", "q9.mismatch", "q9.value.gap"}
    assert list(plain) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(plain["metrics"]) == {"rows_per_s", "query_p95_ms", "peak_device_gib", "setup_s"}
    assert plain["metrics"]["rows_per_s"]["unit"] == "rows/s"
    assert set(traced["metrics"]) == {"tiny_queries"}          # no device: the others read None
    assert set(traced["device"]) >= {"busy_s", "window_s"} and "breakdown" in traced
    assert mods["forbidden"] == []
    assert not set(mods["top"]) & {"jax", "jaxlib", "flax", "cudf_tpu", "benchmarks"}
    # the jax cell: the check finds the module its metric loaded, and no result follows
    assert lines[lines.index("jax cell") + 1:] == [json.dumps({"rc": 3})]
    assert len(results) == 2
    assert "modules loaded that the run may not load: ['jax']" in proc.stderr
    assert proc.stderr.strip().splitlines()[-1].startswith("portbench: modules loaded")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_no_jax_anywhere_and_no_port_in_the_reference():
    for path in (ROOT / "portbench").rglob("*.py"):
        assert not set(_imports(path)) & set(harness.FORBIDDEN), path
    for path in (ROOT / "portbench" / "reference").rglob("*.py"):
        assert set(_imports(path)) <= {"__future__", "torch", "typing", "math"}, path


def _rows(frames):
    return Data({f: {"c": torch.empty(n, device="meta")} for f, n in frames.items()},
                config={})


def test_least_bytes_hand_worked():
    cfg = json.loads((ROOT / "portbench/configs/G1_1e8_1e2_0_0.json").read_text())
    data = _rows({"x": 10 ** 8})
    data.config = cfg
    # q2 reads id1, id2 (codes) and v1: 12 bytes a row
    assert groupby.least_bytes("q2", data, 0) == 1_200_000_000
    assert groupby.least_bytes("q2", data, 10_000) == 1_200_000_000 + 10_000 * 16
    cfg = json.loads((ROOT / "portbench/configs/J1_1e8_NA_0_0.json").read_text())
    data = _rows({"x": 10 ** 8, "big": 10 ** 8})
    data.config = cfg
    # q5: x and big read whole (32 bytes a row each), 9e7 answer rows of 60 bytes
    assert join.least_bytes("q5", data, 90_000_000) == 3_200_000_000 * 2 + 90_000_000 * 60


def _half(fn):
    def broken(f):
        x = f["x"]
        return fn(dict(f, x=x.head(len(x) // 2)))
    return broken


def _altered(fn):
    def broken(f):
        res = fn(f)
        col = res._table[res._table.names[-1]] if hasattr(res, "_table") else res._column
        col.data = col.data.clone()
        col.data[0] += 1
        return res
    return broken


def _unchanged(fn):
    return lambda f: f["x"]


@pytest.mark.parametrize("fault", [_half, _altered, _unchanged])
@pytest.mark.parametrize("name", ["g1_sort_questions", "j1_join_questions"])
def test_faults_come_out_incorrect(spec, monkeypatch, name, fault):
    """Half of the rows left out, an answer altered where it is produced,
    or the input handed back: the run reads ``correct`` false."""
    cell = harness.load_cell(name, spec)
    for q in cell.mix["questions"]:
        monkeypatch.setitem(cell.task.QUESTIONS, q, fault(cell.task.QUESTIONS[q]))
    out = harness.run(cell, 2 ** 36 + 3, 0.1, False, "cpu", time.perf_counter())
    assert out["correct"] is False
    assert out["failed"] == 0


@pytest.mark.parametrize("name", ["g1_sort_questions", "j1_join_questions"])
def test_sound_run_correct_and_control_fails(spec, name):
    cell = harness.load_cell(name, spec)
    out = harness.run(cell, 2 ** 36 + 5, 0.1, False, "cpu", time.perf_counter())
    assert out["correct"] is True, out["checks"]
    r = harness.Run(cell, 2 ** 36 + 5, "cpu")
    r.setup()
    ok, shown = harness.check.judge(r.control(), r.limits())
    assert not ok, shown


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["g1_sort_questions", "j1_join_questions"])
def test_cuda_tiny_traced_run(cuda_device, spec, name):
    cell = harness.load_cell(name, spec)
    out = harness.run(cell, 2 ** 36 + 7, 0.5, True, cuda_device, time.perf_counter())
    assert out["correct"] is True, out["checks"]
    assert out["busy_s"] > 0 and set(out["metrics"]) == {
        "host_syncs_per_query", "kernel_roofline_share", "device_idle_share"}
