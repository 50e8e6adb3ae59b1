"""``merge_asof`` (``frame/asof.py``), ``DataFrame.query`` / ``eval``
(``frame/eval_expr.py``) and ``utils/tracing.py`` against pandas 3 and the
reference (JAX on the CPU).

``merge_asof`` is held to pandas in every direction, with ``by=`` over
nanosecond timestamps (fault 4: the reference packs ``group * 2^40 + on``
into one int64, which 2024's timestamps overflow, and gives ``[10, nan,
10]`` where pandas gives ``[10, 20, 30]``) and with a tolerance; without
``by=`` also to the reference."""

import numpy as np
import pandas as pd
import pytest
import torch

import cudf_tpu as R

import cudf_tpu_torch as ct
from cudf_tpu_torch.utils import tracing

torch.set_num_threads(1)

CPU = "cpu"


def _frames(n_left=120, n_right=80, seed=0, groups=4):
    rng = np.random.default_rng(seed)
    base = np.datetime64("2024-01-01T00:00:00", "ns")
    lt = base + np.sort(rng.integers(0, 10 ** 12, n_left)).astype("timedelta64[ns]")
    rt = base + np.sort(rng.integers(0, 10 ** 12, n_right)).astype("timedelta64[ns]")
    left = pd.DataFrame({"t": lt, "g": rng.integers(0, groups, n_left), "lv": np.arange(n_left)})
    right = pd.DataFrame({"t": rt, "g": rng.integers(0, groups, n_right),
                          "v": rng.normal(size=n_right), "lv": -np.arange(n_right)})
    return left, right


def _same(got, exp):
    got = got.to_pandas()
    assert list(got.columns) == list(exp.columns)
    for c in exp.columns:
        g, e = got[c], exp[c]
        if e.dtype.kind in "MOT" or str(e.dtype) in ("str", "string"):
            assert g.tolist() == e.tolist(), c
        else:
            np.testing.assert_allclose(g.to_numpy(float), e.to_numpy(float), rtol=0,
                                       equal_nan=True, err_msg=c)


@pytest.mark.parametrize("direction", ["backward", "forward", "nearest"])
@pytest.mark.parametrize("by", [None, "g"])
@pytest.mark.parametrize("tolerance", [None, pd.Timedelta("3min"), pd.Timedelta("40s")])
def test_merge_asof_matches_pandas(direction, by, tolerance):
    left, right = _frames()
    got = ct.merge_asof(ct.DataFrame.from_pandas(left, device=CPU),
                        ct.DataFrame.from_pandas(right, device=CPU), on="t", by=by,
                        direction=direction, tolerance=tolerance)
    _same(got, pd.merge_asof(left, right, on="t", by=by, direction=direction,
                             tolerance=tolerance))


@pytest.mark.parametrize("direction", ["backward", "forward", "nearest"])
def test_merge_asof_without_by_equals_the_reference(direction):
    rng = np.random.default_rng(3)
    left = pd.DataFrame({"t": np.sort(rng.integers(0, 1000, 60)), "a": np.arange(60.0)})
    right = pd.DataFrame({"t": np.sort(rng.integers(0, 1000, 40)), "b": rng.normal(size=40)})
    got = ct.merge_asof(ct.DataFrame.from_pandas(left, device=CPU),
                        ct.DataFrame.from_pandas(right, device=CPU), on="t",
                        direction=direction)
    exp = R.merge_asof(R.DataFrame.from_pandas(left), R.DataFrame.from_pandas(right), on="t",
                       direction=direction)
    np.testing.assert_allclose(got.to_pandas()["b"].to_numpy(float),
                               exp.to_pandas()["b"].to_numpy(float), equal_nan=True)
    _same(got, pd.merge_asof(left, right, on="t", direction=direction))


def test_fault_4_by_over_nanosecond_timestamps():
    t = pd.to_datetime(["2024-01-01", "2024-02-01", "2024-03-01"])
    left = pd.DataFrame({"t": t, "g": [1, 2, 1]})
    right = pd.DataFrame({"t": t, "g": [1, 2, 1], "v": [10, 20, 30]})
    got = ct.merge_asof(ct.DataFrame.from_pandas(left, device=CPU),
                        ct.DataFrame.from_pandas(right, device=CPU), on="t", by="g")
    assert got["v"].tolist() == [10, 20, 30]
    _same(got, pd.merge_asof(left, right, on="t", by="g"))


def test_merge_asof_by_a_string_key_and_suffixes():
    left, right = _frames(40, 30, seed=5)
    left["g"] = left["g"].map(lambda k: f"k{k}")
    right["g"] = right["g"].map(lambda k: f"k{k}")
    got = ct.merge_asof(ct.DataFrame.from_pandas(left, device=CPU),
                        ct.DataFrame.from_pandas(right, device=CPU), on="t", by="g",
                        suffixes=("_l", "_r"))
    _same(got, pd.merge_asof(left, right, on="t", by="g", suffixes=("_l", "_r")))


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
    with tracing.enable_tracing() as t:
        assert t is tr and tr.enabled
        tr.clear()
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
    summary = tr.summary()
    assert set(summary) == {"outer", "inner", "decorated"}
    assert summary["outer"] >= 0 and len(tr.records) == 4
    with tr.range("off"):                      # no record while disabled
        pass
    assert len(tr.records) == 4
    tracing.start_profiler_trace(str(tmp_path))
    with tr.range("profiled"):
        torch.ones(100).cumsum(0)
    prof = tracing.stop_profiler_trace()
    assert (tmp_path / "trace.json").exists()
    assert any(e.key == "profiled" for e in prof.key_averages())
