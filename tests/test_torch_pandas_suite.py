"""pandas' own tests under each accelerator: ``tests/series/methods``'
``test_clip.py``, ``test_between.py`` and ``test_round.py`` of the
installed pandas, run in a pytest process with the reference's plugin
(``cudf_tpu.pandas._pytest_plugin``, JAX on the CPU) and in one with the
port's (``cudf_tpu_torch.pandas._pytest_plugin`` on the CPU, through
``suite.pytest_command``).  Every test the reference passes, the port
passes."""

import os
import subprocess
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
MODULES = ["tests/series/methods/test_clip.py", "tests/series/methods/test_between.py",
           "tests/series/methods/test_round.py"]


def test_the_ports_passing_pandas_tests_include_the_references(tmp_path):
    from cudf_tpu_torch.pandas import suite

    targets = [os.path.join(suite.pandas_dir(), m) for m in MODULES]
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu",
               CUDF_TPU_TORCH_PANDAS_DEVICE="cpu")
    procs = {}
    for kind, plugin in (("reference", "cudf_tpu.pandas._pytest_plugin"),
                         ("port", suite.PLUGIN)):
        xml = tmp_path / f"{kind}.xml"
        cmd = suite.pytest_command(targets, plugin=plugin,
                                   extra=[f"--junitxml={xml}", "-p", "no:xdist",
                                          "-p", "no:randomly"])
        procs[kind] = (xml, subprocess.Popen(cmd, cwd=tmp_path, env=env,
                                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                             text=True))
    outcomes = {}
    for kind, (xml, proc) in procs.items():
        out = proc.communicate(timeout=300)[0]
        assert xml.exists(), out[-3000:]
        outcomes[kind] = suite.junit_outcomes(xml)
    ref_passed = {t for t, o in outcomes["reference"].items() if o == "passed"}
    port_passed = {t for t, o in outcomes["port"].items() if o == "passed"}
    assert len(ref_passed) >= 100, len(ref_passed)
    assert set(outcomes["port"]) == set(outcomes["reference"])
    assert ref_passed <= port_passed, sorted(ref_passed - port_passed)
