"""``DataFrame.query`` / ``eval`` (``frame/eval_expr.py``) against pandas 3
and the reference (JAX on the CPU), and ``utils/tracing.py``'s spans, their
sums by name and the profiler trace that carries them.  ``merge_asof`` is in
``tests/test_torch_asof_eval.py``."""

import numpy as np
import pandas as pd
import pytest
import torch

import torch_jax_cache  # noqa: F401  (the run's shared JAX compile cache)
import cudf_tpu as R
import cudf_tpu_torch as ct
from cudf_tpu_torch.utils import tracing

CPU = "cpu"


EXPRESSIONS = ["a > 3 and b < 12", "a > 3 & b < 12 | c == 'x'", "(a + b) * 2 > 10",
               "a in [1, 5, 7]", "not (a > 4)", "c != 'y' and a >= 2", "b / 2 <= a - 1",
               "a > 2 or b > 13"]


@pytest.mark.parametrize("expr", EXPRESSIONS)
def test_query_matches_pandas_and_the_reference(expr):
    pdf = pd.DataFrame({"a": np.arange(10), "b": np.arange(10) * 1.5,
                        "c": list("xyxyxyxyxy")})
    got = ct.DataFrame.from_pandas(pdf, device=CPU).query(expr).to_pandas()
    exp = pdf.query(expr)
    pd.testing.assert_frame_equal(got, exp, check_index_type=False)
    ref = R.DataFrame.from_pandas(pdf).query(expr).to_pandas()
    assert list(ref.index) == list(got.index)


@pytest.mark.parametrize("expr", ["a * 2 + b", "a - b / 4", "a % 3 == 1", "-a + b ** 2",
                                  "a // 3 + b"])
def test_eval_matches_pandas(expr):
    pdf = pd.DataFrame({"a": np.arange(1, 11), "b": np.arange(10) * 1.5})
    got = ct.DataFrame.from_pandas(pdf, device=CPU).eval(expr).to_pandas()
    np.testing.assert_allclose(got.to_numpy(float), pdf.eval(expr).to_numpy(float))


def test_tracer_ranges_summary_and_profiler_trace(tmp_path):
    tr = tracing.tracer
    tr.clear()
    with tracing.enable_tracing() as t:
        assert t is tr and tr.enabled
        with tr.range("outer"):
            with tr.range("inner"):
                torch.ones(10).sum()
        with tr.range("inner"):
            pass

        @tracing.annotate("decorated")
        def work(x):
            return x + 1

        assert work(1) == 2
    assert not tr.enabled
    summary = tr.by_name()
    assert set(summary) == {"outer", "inner", "decorated"}
    assert summary["inner"]["count"] == 2 and summary["outer"]["ms"] >= 0
    assert len(tr.spans()) == 4
    with tr.range("off"):                      # no span while neither switch is on
        pass
    assert len(tr.spans()) == 4
    tracing.start_profiler_trace(str(tmp_path))
    with tr.range("profiled"):
        torch.ones(100).cumsum(0)
    prof = tracing.stop_profiler_trace()
    assert [s.name for s in tr.spans()] == ["profiled"]     # the start cleared the others
    assert '"profiled"' in (tmp_path / "trace.json").read_text()
    assert not any(e.key == "profiled" for e in prof.key_averages())   # no record_function
