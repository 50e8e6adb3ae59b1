"""db-benchmark's join data (``_data/join-datagen.R N NA nas sort``),
made on the device from the seed.  Keys of each id level are split into
shared, lhs-only and rhs-only numbers (``split_xlr``: a permutation of
1..1.1n, its first 0.9n shared, the next 0.1n lhs-only, the last 0.1n
rhs-only), so about 90% of x's rows find a match:

    x       id1..id3  sample_all(shared and lhs-only keys, N)   int32
            id4..id6  "id" + id1..id3                           category
            v1        round(runif(N, max=100), 6)               float64
    small   id1, id4, v2                                        N/1e6 rows
    medium  id1, id2, id4, id5, v2                              N/1e3 rows
    big     id1..id6, v2                                        N rows

The right-hand tables draw from the shared and rhs-only keys.  The
levels' key counts are N/1e6, N/1e3 and N (``levels``); the categories
are read as pandas' join solution reads them (``category``).  R's
Mersenne Twister and ``set.seed(108)`` are not reproduced: every draw
comes from ``--seed``.
"""

from __future__ import annotations

import torch

from portbench.datagen.common import Data, category, generator, rounded_uniform, sample_all

RIGHT = ("small", "medium", "big")


def split_xlr(n: int, g: torch.Generator, device):
    key = torch.randperm(round(n * 1.1), generator=g, device=device) + 1
    a = round(n * 0.9)
    return key[:a], key[a:n], key[n:]


def generate(config: dict, seed: int, device) -> Data:
    n = int(config["N"])
    levels = [int(x) for x in config["levels"]]           # keys of id1, id2, id3
    if config.get("nas", 0) or config.get("sort", 0):
        raise NotImplementedError("join-datagen.R with nas > 0 or sort = 1 is not generated")
    g = generator(seed, 0, device)
    keys = [split_xlr(k, g, device) for k in levels]
    tables, dicts = {}, {}

    def table(name, rows, sides, value):
        ids = [sample_all(torch.cat([k[0], k[side]]), rows, g) for k, side in zip(keys, sides)]
        cols = {f"id{i + 1}": t.to(torch.int32) for i, t in enumerate(ids)}
        dicts[name] = {}
        for i, t in enumerate(ids):
            cols[f"id{i + 4}"], dicts[name][f"id{i + 4}"] = category(t)
        cols[value] = rounded_uniform(rows, g, device)
        tables[name] = cols

    table("x", n, (1, 1, 1), "v1")
    for i, name in enumerate(RIGHT):
        table(name, levels[i], (2,) * (i + 1), "v2")
    return Data(tables, dicts, config)
