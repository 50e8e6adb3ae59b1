"""The multi-rank path on the card: one NCCL rank (the card's machine gives
one card, and NCCL puts one rank on a card).

Marked ``cuda``: without a CUDA device every test here skips (decided in
the fixture, never at import).  On a machine with a card run
``python -m pytest tests/test_torch_cuda_distributed.py -q --noconftest``.

- ``models/distributed.py``'s requests at small sizes over the mesh, each
  equal to the in-memory answer on the card (``PLAIN``: integers exact,
  floats rtol 1e-9), with no fallback;
- the ``parallel`` ops on CUDA tensors against the same ops on CPU tensors
  over a one-rank gloo group in a process of its own (keys and counts
  exact, float sums rtol 1e-12);
- a table of every layout (nullable ints and floats, STRING, dictionary,
  LIST, bool) through ``gather_table`` and ``exchange`` comes back equal.
"""

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.core.table import Table

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cudf_tpu_torch.parallel import bootstrap, make_mesh

    formed = not torch.distributed.is_initialized()
    with tempfile.TemporaryDirectory() as d:
        if formed:
            bootstrap.initialize(0, 1, store=torch.distributed.FileStore(f"{d}/store", 1),
                                 device="cuda")
        yield make_mesh(device=torch.device("cuda", torch.cuda.current_device()))
        if formed:
            bootstrap.shutdown()


@pytest.fixture(scope="module")
def frames(mesh):
    from cudf_tpu_torch.models import distributed as dm
    from cudf_tpu_torch.models import partitioned as pm
    from cudf_tpu_torch.models import tpch

    out = {"g1": dm.g1_frame(200_000, device=mesh.device),
           "tpch": tpch.generate_device(0.01, seed=3, device=mesh.device)}
    out["fact"], out["dim"] = pm.j1_frames(200_000, device=mesh.device)
    return out


def test_the_distributed_requests_equal_memory(mesh, frames):
    from cudf_tpu_torch.engine import get_fallback_stats, reset_fallback_stats
    from cudf_tpu_torch.models import distributed as dm

    for name, request in dm.REQUESTS.items():
        reset_fallback_stats()
        err = dm.PLAIN[name](frames, request(frames, mesh))   # raises beyond rtol 1e-9
        assert np.isfinite(err), name
        assert get_fallback_stats()["count"] == 0, name


_CPU_OPS = """
import sys, json, numpy as np, torch
from cudf_tpu_torch.parallel import dist, make_mesh
mesh = make_mesh(device="cpu")
rng = np.random.default_rng(3)
k = torch.from_numpy(rng.integers(0, 50, 5000)); v = torch.from_numpy(rng.normal(size=5000))
ks, s, c, _, _ = dist.dist_groupby_sum_multi(mesh, [k], [v])
srt, p, _, _ = dist.dist_sort(mesh, k, [v])
d, _, _ = dist.dist_distinct(mesh, [k % 7, k % 5])
print(json.dumps({"k": ks[0].tolist(), "s": s[0].tolist(), "c": c.tolist(),
                  "sort": srt.tolist(), "pay": p[0].tolist(),
                  "distinct": sorted(zip(d[0].tolist(), d[1].tolist()))}))
"""


def test_the_parallel_ops_equal_their_cpu_run(mesh):
    from cudf_tpu_torch.parallel import dist

    root = Path(__file__).resolve().parent.parent
    proc = subprocess.run([sys.executable, "-c", _CPU_OPS], capture_output=True, text=True,
                          timeout=300, cwd=root, env=dict(os.environ, PYTHONPATH=str(root)))
    assert proc.returncode == 0, proc.stderr
    cpu = json.loads(proc.stdout.strip().splitlines()[-1])
    rng = np.random.default_rng(3)
    k = torch.from_numpy(rng.integers(0, 50, 5000)).to(mesh.device)
    v = torch.from_numpy(rng.normal(size=5000)).to(mesh.device)
    ks, s, c, ok, dropped = dist.dist_groupby_sum_multi(mesh, [k], [v])
    assert ks[0].tolist() == cpu["k"] and c.tolist() == cpu["c"] and int(dropped.sum()) == 0
    np.testing.assert_allclose(s[0].cpu().numpy(), cpu["s"], rtol=1e-12)
    srt, p, _, _ = dist.dist_sort(mesh, k, [v])
    assert srt.tolist() == cpu["sort"] and p[0].tolist() == cpu["pay"]
    d, _, _ = dist.dist_distinct(mesh, [k % 7, k % 5])
    assert sorted(zip(d[0].tolist(), d[1].tolist())) == [tuple(x) for x in cpu["distinct"]]


def test_every_layout_crosses_ranks_unchanged(mesh):
    from cudf_tpu_torch.ops.lists import make_list_column
    from cudf_tpu_torch.parallel.mesh import gather_table
    from cudf_tpu_torch.parallel.shuffle import exchange_by_ids

    dev = mesh.device
    n = 6
    valid = torch.tensor([True, False, True, True, False, True], device=dev)
    strings = Column.from_strings(["a", None, "ccc", "", "dd", "é"], device=dev)
    keys = Column.from_strings(["x", "y", "z"], device=dev)
    codes = Column.from_dictionary(torch.tensor([2, 0, 1, 1, 0, 2], dtype=torch.int32,
                                                device=dev), keys)
    lists = make_list_column(torch.tensor([0, 2, 2, 3, 6, 6, 7], device=dev),
                             Column.from_tensor(torch.arange(7.0, device=dev)), None)
    t = Table({"i": Column.from_tensor(torch.arange(n, dtype=torch.int32, device=dev), valid),
               "f": Column.from_tensor(torch.linspace(0, 1, n, dtype=torch.float64,
                                                      device=dev)),
               "b": Column.from_tensor(torch.tensor([True, False] * 3, device=dev)),
               "s": strings, "d": codes, "l": lists})
    for out in (gather_table(mesh, t),
                exchange_by_ids(mesh, t, torch.zeros(n, dtype=torch.int32, device=dev))):
        for name in t.names:
            assert out[name].to_pylist() == t[name].to_pylist(), name
