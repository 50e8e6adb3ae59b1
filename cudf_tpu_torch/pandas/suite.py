"""Run pandas' own test suite under the cudf_tpu_torch.pandas proxy (port
of ``tools/pandas_suite.py``).

The upstream pandas test suite is the accelerator's strongest oracle
(cudf.pandas CI runs it with the accelerator installed and tracks the
pass rate).  Same idea here, on the CPU with pandas as the slow side
(``--device cpu``); on the card (the default device, ``cuda``) there is
no slow side, and a call the port does not serve fails its test:

    python -m cudf_tpu_torch.pandas.suite [--device DEV] [TARGET ...]
    python -m cudf_tpu_torch.pandas.suite [--device DEV] --dirs [--out PATH] [DIR ...]

installs the proxy in a pytest process (``-p
cudf_tpu_torch.pandas._pytest_plugin``) and runs modules of the
installed pandas package: the given targets, or the curated ``SMOKE``
list.  ``--dirs`` runs whole directories (``DIRECTORIES`` by default),
prints each one's pass rate and writes the matrix only to ``--out``.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time
import xml.etree.ElementTree as ET

from cudf_tpu_torch.pandas import _has_slow_side

PLUGIN = "cudf_tpu_torch.pandas._pytest_plugin"

SMOKE = [
    "tests/frame/methods/test_head_tail.py",
    "tests/series/methods/test_clip.py",
    "tests/series/methods/test_fillna.py",
    "tests/frame/methods/test_sort_values.py",
    "tests/reductions/test_reductions.py::TestSeriesReductions",
    "tests/series/methods/test_rank.py",
    "tests/series/methods/test_value_counts.py",
    "tests/frame/methods/test_rename.py",
    "tests/series/methods/test_isin.py",
    "tests/series/methods/test_round.py",
    "tests/series/methods/test_dropna.py",
    "tests/series/methods/test_diff.py",
    "tests/frame/methods/test_shift.py",
    "tests/series/methods/test_quantile.py",
    "tests/frame/methods/test_drop_duplicates.py",
    "tests/series/methods/test_astype.py",
    "tests/series/methods/test_nlargest.py",
    "tests/series/methods/test_duplicated.py",
    "tests/series/methods/test_unique.py",
    "tests/series/methods/test_searchsorted.py",
    "tests/series/methods/test_pct_change.py",
    "tests/series/methods/test_between.py",
]

# Directory-scale conformance runs (the reference runs pandas' ENTIRE
# suite; these directories are the equivalent non-curated oracle at repo
# scale)
DIRECTORIES = [
    "tests/series/methods",
    "tests/series/indexing",
    "tests/frame/methods",
    "tests/reductions",
    "tests/groupby/aggregate",
    "tests/base",
]


def pandas_dir() -> str:
    import pandas

    return os.path.dirname(pandas.__file__)


def pytest_command(targets, plugin=PLUGIN, extra=()):
    """The pytest command that runs ``targets`` with ``plugin`` loaded."""
    return [sys.executable, "-m", "pytest", "-q", "--no-header", "-p", plugin,
            "-p", "no:cacheprovider", *extra, *targets]


def _env(device):
    env = dict(os.environ)
    env["CUDF_TPU_TORCH_PANDAS_DEVICE"] = device
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join([root] + [p for p in
                                                  env.get("PYTHONPATH", "").split(os.pathsep)
                                                  if p])
    return env


def junit_counts(xml_path):
    """(tests, failed, skipped) of a junit file, failed counting errors."""
    suite = ET.parse(xml_path).getroot()
    suite = suite if suite.tag == "testsuite" else suite.find("testsuite")
    total = int(suite.get("tests"))
    failed = int(suite.get("failures")) + int(suite.get("errors"))
    return total, failed, int(suite.get("skipped"))


def junit_outcomes(xml_path):
    """{test id: "passed" | "failed" | "skipped"} of a junit file."""
    out = {}
    for case in ET.parse(xml_path).getroot().iter("testcase"):
        tid = f"{case.get('classname')}::{case.get('name')}"
        if case.find("skipped") is not None:
            out[tid] = "skipped"
        elif case.find("failure") is not None or case.find("error") is not None:
            out[tid] = "failed"
        else:
            out[tid] = "passed"
    return out


def main(targets, device="cuda"):
    pkg = pandas_dir()
    targets = targets or [os.path.join(pkg, t) for t in SMOKE]
    cmd = pytest_command(targets)
    print("running:", " ".join(cmd), file=sys.stderr)
    return subprocess.call(cmd, env=_env(device))


def run_directories(dirs=None, out_path=None, device="cuda"):
    """Run whole upstream pandas test directories under the proxy, print
    each one's pass rate, and write the matrix to ``out_path`` if given.
    Returns the rows (directory, ran, passed, rate, seconds)."""
    pkg = pandas_dir()
    rows = []
    for d in dirs or DIRECTORIES:
        fd, xml = tempfile.mkstemp(suffix=".xml")
        os.close(fd)
        t0 = time.time()
        subprocess.call(pytest_command([os.path.join(pkg, d)], extra=[f"--junitxml={xml}"]),
                        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL, env=_env(device))
        try:
            total, failed, skipped = junit_counts(xml)
        except (ET.ParseError, TypeError, AttributeError):
            total = failed = skipped = 0
        finally:
            os.unlink(xml)
        ran = total - skipped
        rate = (ran - failed) / ran * 100 if ran else 0.0
        rows.append((d, ran, ran - failed, rate, time.time() - t0))
        print(f"{d}: {ran - failed}/{ran} = {rate:.1f}%  ({time.time() - t0:.0f}s)",
              flush=True)
    total_ran = sum(r[1] for r in rows)
    total_pass = sum(r[2] for r in rows)
    slow = "pandas the slow side" if _has_slow_side(device) else "no slow side"
    lines = [
        "# cudf_tpu_torch.pandas conformance — upstream pandas test directories",
        "",
        f"pandas' own test directories under the `cudf_tpu_torch.pandas` proxy on "
        f"`{device}`, {slow}.  Skips excluded.",
        "",
        "| directory | passed / ran | rate |",
        "|---|---|---|",
    ]
    for d, ran, passed, rate, _ in rows:
        lines.append(f"| pandas/{d} | {passed} / {ran} | {rate:.1f}% |")
    lines.append(f"| **total** | **{total_pass} / {total_ran}** | "
                 f"**{total_pass / max(total_ran, 1) * 100:.1f}%** |")
    print("\n".join(lines))
    if out_path:
        with open(out_path, "w") as f:
            f.write("\n".join(lines) + "\n")
        print(f"wrote {out_path}")
    return rows


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--dirs", action="store_true", help="run whole directories")
    parser.add_argument("--out", help="write the --dirs matrix here")
    parser.add_argument("targets", nargs="*")
    a = parser.parse_args()
    if a.dirs:
        run_directories(a.targets or None, a.out, a.device)
        raise SystemExit(0)
    raise SystemExit(main(a.targets, a.device))
