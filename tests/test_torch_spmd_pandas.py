"""``collect(mesh=<a parallel.Mesh>)`` (``engine/spmd.py``) over 2 and 4
gloo ranks on the CPU, each rank a process of one module-wide
``RankPool``, over the plans of ``tests/test_torch_spmd.py`` that the
reference cannot answer (held to pandas there), a plan that cannot be
lowered (counted once as a fallback) and a scan of several files.  The
plans against the reference's ``evaluate_spmd`` are in
``tests/test_torch_spmd.py``, whose tolerances hold here too."""

import numpy as np
import pandas as pd
import pytest

import torch_rank_tasks as tasks
from torch_spmd_helpers import FRAMES, PANDAS_PLANS, RANKS, pandas_answer, pools, run, same


@pytest.mark.parametrize("ranks", RANKS)
@pytest.mark.parametrize("name", PANDAS_PLANS)
def test_a_plan_equals_pandas(pools, ranks, name):
    same(run(pools, ranks, name), pandas_answer(name), name)


@pytest.mark.parametrize("ranks", RANKS)
def test_an_unlowerable_plan_falls_back_once(pools, ranks):
    """A median does not decompose: ``evaluate_spmd`` raises Unlowerable on
    every rank, ``collect`` counts one fallback and answers as pandas, and
    under ``executor.fallback_mode`` "raise" it raises Unlowerable."""
    exp = FRAMES["kv"].groupby("k")["v"].median().reset_index(name="med")
    for raised, got, stats, raised_again in pools[ranks].run(tasks.run_unlowerable, "median",
                                                            FRAMES):
        assert raised is not None and "median" in raised
        assert stats["count"] == 1 and any("median" in r for r in stats["reasons"])
        assert raised_again
        same(got, exp, "median")


@pytest.mark.parametrize("ranks", RANKS)
def test_a_scan_of_several_files_gives_file_i_to_rank_i_mod_world(pools, ranks, tmp_path):
    """Five Parquet files over 2 and 4 ranks: rank r reads files r, r +
    world, ...; the groupby over them equals pandas' over the files."""
    frames = [pd.DataFrame({"k": np.arange(i, i + 40) % 7, "v": np.arange(40.0) * (i + 1)})
              for i in range(5)]
    paths = []
    for i, f in enumerate(frames):
        paths.append(str(tmp_path / f"part-{i}.parquet"))
        f.to_parquet(paths[-1], index=False)
    exp = pd.concat(frames).groupby("k")["v"].sum().reset_index(name="s")
    answers = pools[ranks].run(tasks.scan_files, paths)
    for rank, (got, files) in enumerate(answers):
        assert files == len(paths[rank::ranks])
        same(got, exp, "files")
