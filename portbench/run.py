"""The benchmark's command: one run of one cell on the machine it is
started on.

    python -m portbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its
limit); the numbers compared are also the last lines of standard error.
A run without a CUDA device, or with fewer than the cell asks for,
prints no result and exits with 2; one that finds JAX or the JAX package
loaded once all of its work is done, just before the result would be
printed, prints none and exits with 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(prog="python -m portbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from portbench import harness

    cell = harness.load_cell(args.workload)
    t_imported = time.perf_counter()
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.zeros(1, device=device)               # the CUDA context, a phase of its own
    t_cuda = time.perf_counter()
    out = harness.run(cell, args.seed, args.seconds, bool(args.trace), device, T_START)
    out["setup_phases"] = dict(imports=t_imported - T_START, cuda_init=t_cuda - t_imported,
                               **out["setup_phases"])
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                   "count": cell.chips}
    return finish(out, device_info, bool(args.trace))


def finish(out: dict, device_info: dict, traced: bool) -> int:
    """Print a finished run's result, once nothing more is to be loaded:
    exits 3 with no result where ``sys.modules`` holds JAX or the JAX
    package, then the set-up's phases and each number compared beside
    its limit on standard error, the result's line on standard output."""
    from portbench import harness

    forbidden = harness.forbidden_modules()
    if forbidden:
        print(f"portbench: modules loaded that the run may not load: {forbidden}",
              file=sys.stderr)
        return 3
    print("portbench: import check: no module of top-level name "
          f"{', '.join(harness.FORBIDDEN)} loaded", flush=True)
    for name, seconds in out["setup_phases"].items():
        print(f"setup {name} {seconds!r} s", file=sys.stderr)
    for name, (value, limit) in out["checks"].items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result_line(out, device_info, traced)), flush=True)
    return 0


def result_line(out: dict, device_info: dict, traced: bool) -> dict:
    """The result's line from a run's fields, ``checks`` last."""
    device = dict(device_info, memory_peak_bytes=out["memory_peak_bytes"])
    line = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
            "metrics": out["metrics"], "device": device}
    if traced:
        device.update(busy_s=out["busy_s"], window_s=out["window_s"])
        line["breakdown"] = out["breakdown"]
    line["checks"] = out["checks"]
    return line
