"""db-benchmark's pandas solution over G1 read from CSV
(``pandas/groupby-pandas.py`` of h2oai db-benchmark): ``read_csv`` of
``G1_<n>_1e2_0_0`` with id1, id2 and id3 as categories, then the ten
questions in the solution's form (``cudf_tpu_torch/models/g1.py``, which
runs on pandas frames as on the port's).

    python -m cudf_tpu_torch.pandas [--device DEV] g1_csv.py DIR

reads ``DIR/g1.csv`` and prints each answer's shape.
"""

import os
import sys

import pandas as pd

from cudf_tpu_torch.models import g1

DTYPE = {"id1": "category", "id2": "category", "id3": "category"}


def load(directory):
    return {"x": pd.read_csv(os.path.join(directory, "g1.csv"), dtype=DTYPE)}


def _question(fn):
    return lambda frames: fn(frames["x"])


REQUESTS = {q: _question(fn) for q, fn in g1.QUESTIONS.items()}

if __name__ == "__main__":
    FRAMES = load(sys.argv[1])
    ANSWERS = {name: fn(FRAMES) for name, fn in REQUESTS.items()}
    for name, ans in ANSWERS.items():
        print(name, getattr(ans, "shape", ans))
