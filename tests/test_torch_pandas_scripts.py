"""The slice as a whole on the CPU: the three pandas scripts of
``models/pandas_form.py`` (G1 at 1e4 rows read from CSV, TPC-H q1, q6,
q12 and q14 at SF 0.002 read from Parquet, the sweep) through the port's
accelerator with pandas as its slow side, each with Profiler slow 0;
every answer equal to the same script run directly on the port's frames
(``run_direct``: keys, counts, integers and order exact, floats rtol
1e-12) and to the script under plain pandas."""

import os
import runpy

import pytest

from torch_pandas_helpers import plain, same

G1_ROWS = 10_000
TPCH_SCALE = 0.002


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    from cudf_tpu_torch.models import io_paths as iop
    from cudf_tpu_torch.models import tpch

    d = tmp_path_factory.mktemp("pandas_form")
    iop.write_bytes(str(d / "g1.csv"), iop.g1_csv(iop.g1_frame(G1_ROWS, device="cpu")))
    tables = tpch.generate(TPCH_SCALE, seed=7, device="cpu")
    for name in ("lineitem", "orders", "part"):
        tables[name].to_parquet(str(d / f"{name}.parquet"))
    return str(d)


def _args(name, data_dir):
    return (data_dir,) if name != "sweep" else (2_000, 3)


def _pandas_answers(name, args):
    """The script under plain pandas (its globals' ANSWERS)."""
    import sys

    from cudf_tpu_torch.models.pandas_form import SCRIPTS

    saved = sys.argv
    sys.argv = [str(SCRIPTS[name]), *map(str, args)]
    try:
        return runpy.run_path(str(SCRIPTS[name]), run_name="__main__")["ANSWERS"]
    finally:
        sys.argv = saved


# absolute bounds beside rtol 1e-9 against plain pandas: q9's r2 carries
# the absolute rounding of its centred sums near 0 (as in
# tests/test_torch_g1_questions.py); a rolling mean's rounding is relative
# to the window's values (|v| < 5)
_ATOL = {("g1_csv", "q9"): 1e-15, ("sweep", "rolling_mean"): 5e-12}


@pytest.mark.parametrize("name", ["g1_csv", "tpch_parquet", "sweep"])
def test_the_script_runs_fast_and_equals_the_direct_port_and_pandas(name, data_dir):
    import cudf_tpu_torch.pandas as accel
    from cudf_tpu_torch.models import pandas_form as pf

    args = _args(name, data_dir)
    try:
        with accel.Profiler() as prof:
            g = pf.run_script(name, args, device="cpu")
        answers = g["ANSWERS"]
        assert prof.stats["slow"] == 0, prof.stats
        assert prof.stats["fast"] > 0
        direct = pf.run_direct(name, args, device="cpu")["ANSWERS"]
        assert list(answers) == list(direct) == list(g["REQUESTS"])
        for request in answers:
            pf.agree(f"{name} {request}", answers[request], direct[request],
                     atol=pf.atol_for(name, request, direct[request]))
        as_pandas = {k: plain(v) for k, v in answers.items()}
    finally:
        accel.uninstall()
    for request, exp in _pandas_answers(name, args).items():
        got, atol = as_pandas[request], _ATOL.get((name, request), 0.0)
        if (name, request) == ("sweep", "cut"):
            got, exp = got.astype(str), exp.astype(str)   # the port has no interval dtype
        if (name, request) == ("g1_csv", "q9"):
            # pandas 3's corr cell drops the group keys from its index
            got, exp = got.reset_index(drop=True), exp.reset_index(drop=True)
        same(got, exp, f"{name} {request}: port vs pandas", rtol=1e-9, atol=atol)


def test_the_scripts_name_their_requests_kernels():
    from cudf_tpu_torch.models import pandas_form as pf

    for name, path in pf.SCRIPTS.items():
        assert os.path.exists(path)
        requests = runpy.run_path(str(path), run_name="pandas_form")["REQUESTS"]
        assert set(pf.NEEDS[name]) <= set(requests), name
