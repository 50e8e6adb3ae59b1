"""Ranks launched as several cards would launch them: ``torchrun`` starts
two CPU processes, each forms its group from torchrun's environment
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``:
``parallel/bootstrap.initialize``) over gloo and runs the dry run's
q5-shaped plan (``parallel/dryrun.py --torchrun``), each rank's answer
equal to the in-memory one with no fallback.  On cards the same command
without ``--cpu`` takes NCCL; that is not run (one card a machine)."""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def test_two_ranks_under_torchrun_answer_as_memory():
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node=2",
         "-m", "cudf_tpu_torch.parallel.dryrun", "--torchrun", "--cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    reports = [json.loads(line) for line in proc.stdout.replace("}{", "}\n{").splitlines()
               if line.startswith("{")]
    assert sorted(r["rank"] for r in reports) == [0, 1]
    for r in reports:
        assert r["ranks"] == 2 and r["equal_to_memory"] and r["fallbacks"] == 0
        assert r["collectives"]["all_to_all_single"]["calls"] > 0
        assert r["foreign_modules"] == []
