"""db-benchmark's groupby data (``_data/groupby-datagen.R N K nas sort``),
made on the device from the seed:

    id1, id2  sample(sprintf("id%03d", 1:K), N, TRUE)        category
    id3       sample(sprintf("id%010d", 1:(N/K)), N, TRUE)   category
    id4, id5  sample(K, N, TRUE)                             int32
    id6       sample(N/K, N, TRUE)                           int32
    v1, v2    sample(5, N, TRUE), sample(15, N, TRUE)        int32
    v3        round(runif(N, max=100), 6)                    float64

The categories are read as pandas' groupby solution reads them
(``category``): a dictionary of the keys that occur, sorted.  R's
Mersenne Twister and ``set.seed(108)`` are not reproduced: every draw
comes from ``--seed``.
"""

from __future__ import annotations

import torch

from portbench.datagen.common import Data, category, generator, rounded_uniform

FRAME = "x"


def generate(config: dict, seed: int, device) -> Data:
    n, k = int(config["N"]), int(config["K"])
    if config.get("nas", 0) or config.get("sort", 0):
        raise NotImplementedError("groupby-datagen.R with nas > 0 or sort = 1 is not generated")
    g = generator(seed, 0, device)

    def ints(hi):
        return torch.randint(1, hi + 1, (n,), generator=g, device=device, dtype=torch.int32)

    cols, dicts = {}, {}
    for name, hi, width in (("id1", k, 3), ("id2", k, 3), ("id3", n // k, 10)):
        cols[name], dicts[name] = category(ints(hi), width)
    cols["id4"], cols["id5"], cols["id6"] = ints(k), ints(k), ints(n // k)
    cols["v1"], cols["v2"] = ints(5), ints(15)
    cols["v3"] = rounded_uniform(n, g, device)
    return Data({FRAME: cols}, {FRAME: dicts}, config)
