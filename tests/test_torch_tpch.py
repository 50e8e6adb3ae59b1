"""The nine TPC-H queries of ``benchmarks/tpch.py`` (q1, q3, q4, q5, q6,
q9, q10, q12 and q14) through the port's engine
(``cudf_tpu_torch/models/tpch.py``) against the reference's engine
(``benchmarks/tpch.py`` on the JAX CPU backend) and against
``pandas_reference``, from ``generate(0.002, seed=7)`` on both sides:
the same numpy draws, the port's strings dictionary-encoded.

q12 and q14 run once more with ``join.fast_path_min_rows`` at 1, so that
their joins take the radix tier's plain path (kernels B, F, G, D and H
as plain PyTorch); by default their small probes take the dense tier.
Both the optimised plan and ``collect(no_optimization=True)`` are held.
Keys are compared as strings, counts exactly, float aggregates to rtol
1e-9 (``tests/test_tpch.py``'s tolerance).  Every query's answer on
``generate_device`` tables is also held to its plain PyTorch version
(``tpch.PLAIN``), as the chip smoke holds it on the card.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from benchmarks import tpch as ref_tpch
from cudf_tpu_torch.models import tpch
from cudf_tpu_torch.utils.config import option_context

torch.set_num_threads(1)

CPU = torch.device("cpu")
RTOL = 1e-9


@pytest.fixture(scope="module")
def tables():
    return tpch.generate(0.002, seed=7, device=CPU)


@pytest.fixture(scope="module")
def ref_tables():
    return ref_tpch.generate(0.002, seed=7)


def _frame(df) -> pd.DataFrame:
    out = (df.to_pandas() if hasattr(df, "to_pandas") else df).reset_index(drop=True)
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
            np.testing.assert_allclose(got[c].to_numpy(), exp[c].to_numpy(), rtol=RTOL,
                                       err_msg=c)
        else:
            assert got[c].tolist() == exp[c].tolist(), c


def _result(out):
    """A query's answer: q6's one-row frame as its float."""
    if hasattr(out, "_table") and out._table.names == ("revenue",):
        return float(out._table["revenue"].data[0])
    return out


QUERIES = ["q1", "q3", "q4", "q5", "q6", "q9", "q10", "q12", "q14"]


@pytest.mark.parametrize("query", ["q1", "q4", "q6", "q12", "q14"])
def test_query_matches_reference_engine_and_pandas(tables, ref_tables, query):
    """q3, q5, q9 and q10 are held the same way in
    tests/test_torch_tpch_q3_q9.py, _q5.py and _q10.py: the reference
    engine compiles for 20-30 s a join query on the CPU."""
    check_query(tables, ref_tables, query)


def check_query(tables, ref_tables, query):
    """A query through the port's engine, optimised and not, against the
    reference's engine and both pandas versions."""
    got = _result(tpch.QUERIES[query](tables))
    ref = getattr(ref_tpch, query)(ref_tables)
    if query == "q6":
        ref = float(ref.to_pandas()["revenue"][0])
    _check(got, ref)
    _check(got, tpch.pandas_reference(tables, query))
    _check(got, ref_tpch.pandas_reference(ref_tables, query))
    _check(_result(tpch.QUERIES[query](tables, no_optimization=True)), ref)


@pytest.mark.parametrize("query", ["q12", "q14"])
def test_joins_on_the_radix_tier_plain_path(tables, query, monkeypatch):
    """With the radix tier taking every probe, both joins run the
    kernels' plain versions and give the default tiers' answer."""
    from cudf_tpu_torch.kernels import radix_partition as rp

    seen = []
    real = rp.window_probe

    def counting(*args, **kw):
        seen.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(rp, "window_probe", counting)
    default = _result(tpch.QUERIES[query](tables))
    with option_context("join.fast_path_min_rows", 1):
        for opt in (False, True):
            _check(_result(tpch.QUERIES[query](tables, no_optimization=opt)), default)
    assert seen


def _agree(got, exp, what):
    """The plain versions' forms: floats rtol 1e-9, tensors exact (float
    tensors rtol 1e-9), lists exact, tuples and dicts element by element."""
    if isinstance(exp, float):
        np.testing.assert_allclose(got, exp, rtol=RTOL, err_msg=what)
    elif isinstance(exp, torch.Tensor):
        assert got.dtype == exp.dtype and got.shape == exp.shape, (what, got.dtype, exp.dtype)
        if exp.is_floating_point():
            np.testing.assert_allclose(got.numpy(), exp.numpy(), rtol=RTOL, err_msg=what)
        else:
            assert torch.equal(got, exp), what
    elif isinstance(exp, dict):
        assert list(got) == list(exp), what
        for k in exp:
            _agree(got[k], exp[k], f"{what} {k}")
    elif isinstance(exp, tuple):
        for i, (g, e) in enumerate(zip(got, exp)):
            _agree(g, e, f"{what}[{i}]")
    else:
        assert got == exp, what


@pytest.mark.parametrize("query", QUERIES)
def test_device_tables_match_plain_torch(query):
    """generate_device's layouts (int32 keys, dictionary codes over keys
    out of byte order, ns dates) through the engine, against the plain
    PyTorch version the chip smoke checks it with."""
    t = tpch.generate_device(0.005, seed=11, device=CPU)
    _agree(tpch.answer(query, tpch.QUERIES[query](t)), tpch.PLAIN[query](t), query)
