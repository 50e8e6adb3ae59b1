"""TPC-H q12 and q4 in pandas' API (``tpch.FRAME_QUERIES``) on the
reference's ``cudf_tpu.DataFrame`` tables and on the port's, from
``generate(0.001, seed=7)`` on both sides: the same function, the same
answers (keys exact, floats rtol 1e-9).  The reference's frame layer
compiles for seconds a query on the CPU, hence files of their own;
``check`` is ``test_torch_frame_tpch``'s."""

import pytest
import torch

from benchmarks import tpch as ref_tpch
from cudf_tpu_torch.models import tpch
from test_torch_frame_tpch import check

torch.set_num_threads(1)


@pytest.mark.parametrize("q", ["q12", "q4"])
def test_frame_query_matches_the_reference_frame_layer(q):
    got = tpch.FRAME_QUERIES[q](tpch.generate(0.001, seed=7, device=torch.device("cpu")))
    check(got, tpch.FRAME_QUERIES[q](ref_tpch.generate(0.001, seed=7)))
