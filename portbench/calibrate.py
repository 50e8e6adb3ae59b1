"""The readings the check's limits are set from, in one process:

    python -m portbench.calibrate --workload <name> --seed <first> --seeds 12 --control 3

For each of ``--seeds`` seeds (``--seed``, ``--seed`` + 1, ...) the cell's
data is generated, the mix's window runs one round and every answer is
compared with the reference, as in a run; for the first ``--control``
seeds the control, the reference computed in float32 in the program's
place, is compared as well.  One JSON line a seed, then the largest
program reading and the smallest control reading of each number, beside
its limit.  A CUDA device is required; the benchmark's runs never run
this.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m portbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control", type=int, default=3)
    args = p.parse_args(argv)
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    program, control = {}, {}
    for i in range(args.seeds):
        seed = args.seed + i
        r = harness.Run(cell, seed, "cuda")
        r.setup()
        w = r.window(0.0, {q: 0 for q in r.questions})
        line = {"seed": seed, "program": r.check(w.held)}
        del w
        if i < args.control:
            line["control"] = r.control()
        print(json.dumps(line), flush=True)
        for k, v in line["program"].items():
            program[k] = max(program.get(k, v), v)
        for k, v in line.get("control", {}).items():
            control[k] = min(control.get(k, v), v)
        del r
        torch.cuda.empty_cache()
    limits = cell.task.LIMITS
    print(json.dumps({"readings": {k: {"program_max": program[k], "control_min": control.get(k),
                                       "limit": limits.get(k)} for k in program}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
