#!/usr/bin/env python3
"""``chip_smoke.py``'s string and temporal phases alone, on one CUDA card.

Run from the repository root:  python3 tools/strings_probe.py

Builds the kernels, draws G1 at 1e8 rows as the smoke does and runs the
``models/strings_dt.py`` requests over G1's id3 as text and over the
dictionary id3, then draws TPC-H SF10 and runs the ship-date requests:
each phase is ``chip_smoke.strings_dt_phase`` (every answer against its
plain version, the launches against ``NEEDS``, every kernel call
replayed, ``STRING_ROUTES["host"]`` unmoved, host syncs counted, each
request timed beside its plain version).  Prints the card's name and
power limit first, the peak device memory after each phase, and the
times as its last line.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs                                                  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("strings_probe: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    import cudf_tpu_torch as ct
    from cudf_tpu_torch.kernels import _build
    from cudf_tpu_torch.kernels import hash_aggregate as ha
    from cudf_tpu_torch.kernels import radix_partition as rp
    from cudf_tpu_torch.kernels import tile_sort as ts
    from cudf_tpu_torch.models import tpch

    _build.library()
    dev = torch.device("cuda", 0)
    wrappers = {"onehot_groupby_aggregate": ha.onehot_groupby_aggregate,
                "digit_histogram": rp.digit_histogram, "radix_scatter": rp.radix_scatter,
                "tile_sort": ts.tile_sort, "tile_sort_data": ts.tile_sort_data,
                "merge_scatter": rp.merge_scatter, "bucket_aggregate": rp.bucket_aggregate,
                "window_probe": rp.window_probe}
    plains = {"onehot_groupby_aggregate": ha.onehot_groupby_aggregate_plain,
              "digit_histogram": rp.digit_histogram_plain,
              "tile_sort_data": ts.tile_sort_data_plain,
              "merge_scatter": rp.merge_scatter_plain,
              "bucket_aggregate": rp.bucket_aggregate_plain,
              "window_probe": rp.window_probe_plain}
    paths = {"strings_g1": cs.ONEHOT_TIER + cs.RADIX_TIER, "strings_g1_dict": [],
             "strings_lineitem": cs.ONEHOT_TIER}

    def drive(path, run):
        for fn in wrappers.values():
            fn.launches = 0
        out = run()
        torch.cuda.synchronize()
        for name in paths[path]:
            cs.check(wrappers[name].launches > 0, f"{name} was not launched by {path}")
        return out

    acc = ({}, {}, {})
    text = {"g1": cs.g1_frame(ct, dev, torch.Generator(device=dev).manual_seed(cs.SEED))}
    torch.cuda.reset_peak_memory_stats()
    for group in ("g1", "g1_dict"):
        cs.strings_dt_phase(group, text, smi, wrappers, drive, plains, acc)
        print(f"{group}: peak {torch.cuda.max_memory_allocated() / 1e9:.1f} GB, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    del text
    torch.cuda.empty_cache()
    tables = tpch.generate_device(10, seed=cs.SEED, device=dev)
    cs.strings_dt_phase("lineitem", {"lineitem": tables["lineitem"]}, smi, wrappers, drive,
                        plains, acc)
    print(f"lineitem: peak {torch.cuda.max_memory_allocated() / 1e9:.1f} GB, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"card": smi, "ms": acc[2]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
