"""Tests of the benchmark's own code.  They run on the CPU at small
sizes; a test marked ``cuda`` needs a CUDA device and skips without one
(decided inside the ``cuda_device`` fixture, never at import)."""

import copy
import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
SMALL = {"G1_1e8_1e2_0_0": {"N": 20000, "K": 10},
         "J1_1e8_NA_0_0": {"N": 20000, "levels": [20, 2000, 20000]}}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device; skips without one")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def small_spec(tmp_path: Path) -> dict:
    """BENCHMARK.json with each configuration's file replaced by a copy at
    a small size (same keys, fewer rows)."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec = copy.deepcopy(spec)
    for c in spec["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg.update(SMALL[c["name"]])
        path = tmp_path / f"{c['name']}.json"
        path.write_text(json.dumps(cfg))
        c["file"] = str(path)
    return spec


@pytest.fixture
def spec(tmp_path):
    return small_spec(tmp_path)
