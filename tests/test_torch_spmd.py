"""``collect(mesh=<a parallel.Mesh>)`` (``engine/spmd.py``) over 2 and 4
gloo ranks on the CPU, each rank a process of one module-wide
``RankPool``, against the reference's ``evaluate_spmd`` on its 8-device
CPU mesh (``tests/conftest.py``) over the plans of
``tests/test_spmd_engine.py``, on the same seeded numpy data.

Every rank gets the whole answer, and every rank's must be the same.
Where the order is the plan's (a sort) rows are compared in order, else
after a sort on all columns.  Integers, counts and strings exact; floats
rtol 1e-12 (standard deviations 1e-9, as the reference's own tests hold
them).  Where the reference is wrong the port is held to pandas: its
float join keys are never decoded (ROADMAP.md §3; the join's key column
comes back encoded), and a CASE with a null branch, whose mask its
zero-row probe does not see, fails to trace (TracerBoolConversionError).  Every plan runs with no
fallback but the median's, which is unlowerable and counted once.
"""

import pytest
import torch

import torch_jax_cache  # noqa: F401  (the run's shared JAX compile cache)
import cudf_tpu as rct
from cudf_tpu import engine as ref_engine
from cudf_tpu.engine.spmd import evaluate_spmd as ref_evaluate_spmd
from cudf_tpu.frame.dataframe import DataFrame as RefDataFrame
from cudf_tpu.frame.index import default_index as ref_default_index
from cudf_tpu.parallel.mesh import make_mesh as ref_make_mesh

import torch_rank_tasks as tasks
from torch_spmd_helpers import FRAMES, RANKS, pools, run, same

torch.set_num_threads(1)


# the plans each ranks' answer is held to the reference's SPMD answer on
REFERENCE_PLANS = ["q1", "q5", "minmax", "strings", "semi_distinct", "q13", "left_nulls",
                   "full", "multisort", "nullable", "over"]
ORDERED = {"q5", "multisort"}


@pytest.fixture(scope="module")
def reference():
    """The reference's SPMD answer to each plan, once a module (its
    programs compile for seconds each)."""
    mesh = ref_make_mesh(8)
    frames = {n: rct.DataFrame.from_pandas(f) for n, f in FRAMES.items()}
    out = {}
    for name in REFERENCE_PLANS:
        t = ref_evaluate_spmd(tasks.PLANS[name](ref_engine, frames).optimized(), mesh)
        out[name] = RefDataFrame._from(t, ref_default_index(t.num_rows)).to_pandas()
    return out


@pytest.mark.parametrize("ranks", RANKS)
@pytest.mark.parametrize("name", REFERENCE_PLANS)
def test_a_plan_equals_the_references_spmd_answer(pools, reference, ranks, name):
    got = run(pools, ranks, name)
    same(got, reference[name], name, ordered=name in ORDERED)


@pytest.mark.parametrize("ranks", RANKS)
def test_shuffle_joins_and_the_lowering_switched_off(pools, reference, ranks):
    """q5 with its join shuffled (no broadcast), shuffled after a bloom
    filter of the dim's keys (the filter's bits or-ed over the ranks by an
    ``all_reduce``), and with ``executor.spmd_lowering`` off (every rank
    runs the one-process executor over the mesh's size in partitions): the
    same answer."""
    shuffled = run(pools, ranks, "q5", options=("executor.broadcast_limit", 0))
    same(shuffled, reference["q5"], "q5", ordered=True)
    bloomed = run(pools, ranks, "q5", options=("executor.broadcast_limit", 1024))
    same(bloomed, reference["q5"], "q5", ordered=True)
    off = run(pools, ranks, "q5", spmd=False)
    same(off, reference["q5"], "q5", ordered=True)
