"""The reference accelerator's faults (ROADMAP.md section 3), held to
pandas under the port's proxy: reflected and unary operators, round,
divmod and matmul the reference's proxy refuses; pickling, which it
breaks; hashing, which it allows.  Then the port's own contract: build,
launch and device errors are never caught by the fallback, other errors
are; pandas is the slow side only on the CPU; ``python -m
cudf_tpu_torch.pandas --device cpu script.py``, and the same with no
``--device`` on the card."""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from torch_pandas_helpers import plain, same, under

ROOT = Path(__file__).resolve().parent.parent

OPERATORS = ["2 ** s", "7 // s", "7 % s", "True & (s > 1)", "+s",
             "round(pd.Series([1.26, 2.5]), 1)", "divmod(s, 2)", "s @ s"]


@pytest.mark.parametrize("expr", OPERATORS)
def test_operators_the_reference_refuses_give_pandas_answer(expr):
    with under("pandas") as pd:
        s = pd.Series([1, 2, 3])
        exp = eval(expr)
    with under("reference") as pd:
        s = pd.Series([1, 2, 3])
        with pytest.raises(TypeError):
            eval(expr)
    with under("port") as pd:
        s = pd.Series([1, 2, 3])
        got = plain(eval(expr))
    same(got, exp, expr)


def test_a_proxy_pickles_to_its_pandas_object():
    with under("pandas") as pd:
        exp = pd.Series([1.0, 2.0, 3.0], name="x")
    with under("reference") as pd:
        with pytest.raises(pickle.PicklingError):
            pickle.dumps(pd.Series([1.0, 2.0, 3.0]))
    with under("port") as pd:
        s = pd.Series([1.0, 2.0, 3.0], name="x")
        back = pickle.loads(pickle.dumps(s))
        assert isinstance(back, pd.Series)
        frame = pickle.loads(pickle.dumps(pd.DataFrame({"a": [1, 2], "b": ["x", "y"]})))
        same(frame, pd.DataFrame({"a": [1, 2], "b": ["x", "y"]}).to_pandas(), "frame")
    same(back, exp, "pickled Series")
    real = pickle.loads(pickle.dumps(s))          # after uninstall: a pandas Series
    assert type(real).__module__.startswith("pandas")
    same(real, exp, "unpickled outside the proxy")


def test_a_proxy_is_unhashable_as_pandas_objects_are():
    with under("pandas") as pd:
        with pytest.raises(TypeError, match="unhashable"):
            hash(pd.Series([1, 2]))
    with under("reference") as pd:
        assert isinstance(hash(pd.Series([1, 2])), int)
    with under("port") as pd:
        with pytest.raises(TypeError, match="unhashable"):
            hash(pd.Series([1, 2]))
        with pytest.raises(TypeError, match="unhashable"):
            hash(pd.DataFrame({"a": [1]}))


def _raising(exc):
    def fn(self, *a, **k):
        raise exc
    return fn


@pytest.mark.parametrize("kind", ["build", "launch", "cuda"])
def test_build_launch_and_cuda_errors_are_never_caught(kind, monkeypatch):
    from cudf_tpu_torch.frame.dataframe import DataFrame
    from cudf_tpu_torch.kernels._build import BuildError, LaunchError

    exc = {"build": BuildError("nvcc failed"), "launch": LaunchError("cudf_x: CUDA error 700"),
           "cuda": RuntimeError("CUDA error: an illegal memory access was encountered")}[kind]
    import cudf_tpu_torch.pandas as accel

    with under("port") as pd:
        df = pd.DataFrame({"a": [1, 2, 3]})
        monkeypatch.setattr(DataFrame, "cumsum", _raising(exc))
        with accel.Profiler() as prof:
            with pytest.raises(type(exc)):
                df.cumsum()
        assert prof.stats["slow"] == 0


def test_other_errors_fall_back_to_pandas_and_count_as_slow(monkeypatch):
    from cudf_tpu_torch.frame.dataframe import DataFrame

    import cudf_tpu_torch.pandas as accel

    with under("port") as pd:
        df = pd.DataFrame({"a": [1, 2, 3]})
        monkeypatch.setattr(DataFrame, "cumsum", _raising(ValueError("not here")))
        with accel.Profiler() as prof:
            got = plain(df.cumsum())
        assert prof.stats["slow"] == 1 and prof.stats["calls"]["cumsum"] == (0, 1)
        assert got["a"].tolist() == [1, 3, 6]


@pytest.mark.parametrize("device", ["cuda", "cuda:0", "meta"])
def test_pandas_is_the_slow_side_only_on_the_cpu(device):
    import pandas as real

    import cudf_tpu_torch.pandas as accel
    from cudf_tpu_torch.pandas.proxy import NoSlowSide, state

    try:
        pd = accel.install(device="cpu")
        assert state["slow"] is real and pd.__proxy_for__ is real
        pd = accel.install(device=torch.device(device))
        assert state["slow"] is None and pd.__proxy_for__ is None
        with accel.Profiler() as prof:
            with pytest.raises(NoSlowSide):
                pd.eval("1 + 1")
        assert prof.stats["slow"] == 1 and prof.stats["calls"]["pandas.eval"] == (0, 1)
    finally:
        accel.uninstall()
    assert sys.modules["pandas"] is real


def test_a_missing_cuda_device_raises_on_the_first_construction():
    from cudf_tpu_torch.pandas.proxy import NoDevice

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import cudf_tpu_torch.pandas as accel

    pd = accel.install(device="cuda")
    try:
        with pytest.raises(NoDevice):
            pd.DataFrame({"a": [1, 2]})
        with pytest.raises(NoDevice):
            pd.Series([1.0])
    finally:
        accel.uninstall()


_SCRIPT = """
import sys
import pandas as pd
df = pd.DataFrame({"k": [2, 1, 2], "v": [1.5, 2.0, 4.0]})
out = df.groupby("k").agg(total=("v", "sum"))
print("PROXY", pd.__proxy_for__ is not None, type(df._fast).__module__)
print("ARGS", sys.argv[1:])
print("TOTAL", out["total"].tolist())
"""


def test_python_dash_m_runs_a_script_through_the_accelerator(tmp_path):
    script = tmp_path / "script.py"
    script.write_text(_SCRIPT)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-m", "cudf_tpu_torch.pandas", "--device", "cpu",
                           str(script), "a", "b"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "PROXY True cudf_tpu_torch.frame.dataframe" in proc.stdout, proc.stdout
    assert "ARGS ['a', 'b']" in proc.stdout
    assert "TOTAL [2.0, 5.5]" in proc.stdout
    if not torch.cuda.is_available():      # the default device is the card: never the CPU
        on_card = subprocess.run([sys.executable, "-m", "cudf_tpu_torch.pandas", str(script)],
                                 cwd=tmp_path, env=env, capture_output=True, text=True,
                                 timeout=120)
        assert on_card.returncode == 1 and "NoDevice" in on_card.stderr, on_card.stderr
        assert "TOTAL" not in on_card.stdout
    usage = subprocess.run([sys.executable, "-m", "cudf_tpu_torch.pandas"], cwd=tmp_path,
                           env=env, capture_output=True, text=True, timeout=120)
    assert usage.returncode == 1 and "usage" in usage.stderr
