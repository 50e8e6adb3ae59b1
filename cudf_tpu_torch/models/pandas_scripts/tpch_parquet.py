"""TPC-H q1, q6, q12 and q14 as pandas code over lineitem, orders and
part read from Parquet (``tpch.FRAME_QUERIES``: the bodies of the
reference's pandas version of each query).

    python -m cudf_tpu_torch.pandas [--device DEV] tpch_parquet.py DIR

reads ``DIR/{lineitem,orders,part}.parquet`` and prints each answer.
"""

import os
import sys

import pandas as pd

from cudf_tpu_torch.models import tpch

TABLES = ("lineitem", "orders", "part")


def load(directory):
    return {n: pd.read_parquet(os.path.join(directory, f"{n}.parquet")) for n in TABLES}


REQUESTS = {q: tpch.FRAME_QUERIES[q] for q in ("q1", "q6", "q12", "q14")}

if __name__ == "__main__":
    FRAMES = load(sys.argv[1])
    ANSWERS = {name: fn(FRAMES) for name, fn in REQUESTS.items()}
    for name, ans in ANSWERS.items():
        print(name, getattr(ans, "shape", ans))
