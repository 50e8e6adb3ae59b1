"""The nine TPC-H queries in pandas' API (``tpch.FRAME_QUERIES``: the
bodies of the reference's ``pandas_reference`` over a dict of frames)
on the port's DataFrames, against pandas (``tpch.pandas_reference``:
the same functions over pandas frames), against the port's LazyFrame
queries (``tpch.QUERIES``) and, on ``generate_device`` tables, against
the plain PyTorch versions (``tpch.PLAIN``).  On pandas frames they
must give the reference's own ``pandas_reference`` answers, over the
reference's tables from the same seed: they are its pandas code.
``frame_of`` and ``check`` serve the ``test_torch_frame_tpch_ref_*``
files too.

Keys, counts and row order exact (dictionary keys compared as strings),
float aggregates rtol 1e-9 (``tests/test_tpch.py``'s tolerance).
"""

import numpy as np
import pandas as pd
import pytest
import torch

from benchmarks import tpch as ref_tpch
from cudf_tpu_torch.models import tpch

torch.set_num_threads(1)

CPU = torch.device("cpu")
RTOL = 1e-9
QUERIES = sorted(tpch.FRAME_QUERIES)


@pytest.fixture(scope="module")
def tables():
    return tpch.generate(0.002, seed=7, device=CPU)


@pytest.fixture(scope="module")
def ref_tables():
    return ref_tpch.generate(0.002, seed=7)


def frame_of(df) -> pd.DataFrame:
    out = (df.to_pandas() if hasattr(df, "to_pandas") else df).reset_index(drop=True)
    for c in out.columns:
        if out[c].dtype.kind not in "fiub":
            out[c] = out[c].astype(str)
    return out


def check(got, exp):
    if isinstance(exp, float):
        assert isinstance(got, float)
        np.testing.assert_allclose(got, exp, rtol=RTOL)
        return
    got, exp = frame_of(got), frame_of(exp)
    assert list(got.columns) == list(exp.columns) and len(got) == len(exp)
    for c in exp.columns:
        if exp[c].dtype.kind == "f":
            np.testing.assert_allclose(got[c].to_numpy(), exp[c].to_numpy(), rtol=RTOL,
                                       err_msg=c)
        else:
            assert got[c].tolist() == exp[c].tolist(), c


def same_answer(got, exp):
    """Two ``tpch.answer`` forms: tensors by dtype and value (floats rtol
    1e-9), the rest exactly."""
    if isinstance(exp, torch.Tensor):
        assert got.dtype == exp.dtype and got.shape == exp.shape
        if exp.is_floating_point():
            torch.testing.assert_close(got, exp, rtol=RTOL, atol=0)
        else:
            assert torch.equal(got, exp)
    elif isinstance(exp, dict):
        assert list(got) == list(exp)
        for k in exp:
            same_answer(got[k], exp[k])
    elif isinstance(exp, (tuple, list)) and exp and not isinstance(exp[0], (str, tuple)):
        for g, e in zip(got, exp):
            same_answer(g, e)
    elif isinstance(exp, float):
        np.testing.assert_allclose(got, exp, rtol=RTOL)
    else:
        assert got == exp


@pytest.mark.parametrize("q", QUERIES)
def test_frame_query_matches_pandas_and_the_lazyframe_query(tables, q):
    got = tpch.FRAME_QUERIES[q](tables)
    check(got, tpch.pandas_reference(tables, q))
    same_answer(tpch.answer(q, got), tpch.answer(q, tpch.QUERIES[q](tables)))


@pytest.mark.parametrize("q", QUERIES)
def test_frame_query_is_pandas_code(tables, ref_tables, q):
    pandas_tables = {k: v.to_pandas() for k, v in tables.items()}
    check(tpch.FRAME_QUERIES[q](pandas_tables), ref_tpch.pandas_reference(ref_tables, q))


@pytest.mark.parametrize("q", QUERIES)
def test_frame_query_matches_plain_torch_on_device_tables(q):
    tables = tpch.generate_device(0.002, seed=3, device=CPU)
    same_answer(tpch.answer(q, tpch.FRAME_QUERIES[q](tables)), tpch.PLAIN[q](tables))
