#!/usr/bin/env python3
"""Where kernel C's time goes on one CUDA card, and what partition_offsets
costs.

Run from the repository root:  python3 tools/scatter_probe.py

At 1e8 uniform 20-bit keys (G1 K = 1e6's shape) it times, each as the
median of 7 warm runs (CUDA events):

- kernel C (radix_scatter) at 2^1, 2^4 and 2^7 buckets, tiles of 4096
  and 16384 keys, with no payload, one int32 payload, and int32 + f64
  payloads: the ranking and staging cost is the same at every bucket
  count, so the difference between 2 and 128 buckets is the cost of the
  write fan-out;
- a clone of the same columns (the bytes C must move, as one copy each);
- partition_offsets of the [tiles, 128] histogram at both tiles, beside
  the scan it replaced (torch.cumsum along dim 0 of the table).

Prints one line per measurement, the card's name and power limit first.
"""

import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs                                       # noqa: E402
from cudf_tpu_torch.kernels import radix_partition as rp      # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("scatter_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    n = cs.N
    keys = torch.randint(0, 1 << 20, (n,), generator=gen, device=dev, dtype=torch.int32)
    i32 = torch.randint(0, 16, (n,), generator=gen, device=dev, dtype=torch.int32)
    f64 = torch.rand(n, generator=gen, device=dev, dtype=torch.float64)
    columns = {"keys only": [], "int32": [i32], "int32 + f64": [i32, f64]}
    for nbits in (1, 4, 7):
        shift = 20 - nbits
        for tile in (4096, 16384):
            offsets, _ = rp.partition_offsets(rp.digit_histogram(keys, nbits, shift, tile))
            for name, pays in columns.items():
                ms = cs.device_ms(lambda: rp.radix_scatter(keys, pays, offsets, nbits, shift,
                                                           tile))
                print(f"C 2^{nbits} buckets, tile {tile}, {name}: {ms:.3f} ms", flush=True)
    ms = cs.device_ms(lambda: [c.clone() for c in [keys, i32, f64]])
    print(f"clone of the keys, int32 and f64 columns: {ms:.3f} ms", flush=True)
    for tile in (4096, 16384):
        h = rp.digit_histogram(keys, 7, 13, tile)
        new = cs.device_ms(lambda: rp.partition_offsets(h))
        old = cs.device_ms(lambda: torch.cumsum(h.long(), 0))
        print(f"partition_offsets of {list(h.shape)}: {new:.3f} ms; torch.cumsum along dim 0 "
              f"alone: {old:.3f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
