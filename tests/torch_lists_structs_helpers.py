"""Inputs and comparisons shared by tests/test_torch_lists_structs.py and
tests/test_torch_list_access.py."""

import numpy as np

from cudf_tpu.core.column import Column as RefColumn
from cudf_tpu.ops import lists as ref_lists
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.ops import lists


CPU = "cpu"
ROWS = 300


def _lists(seed, rows=ROWS, nulls=True, elem_nulls=True, strings=False):
    """Seeded host lists: lengths 0-6, about 8% null rows and 10% null
    elements, ints in [-20, 20) (or short strings)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(rows):
        if nulls and rng.random() < 0.08:
            out.append(None)
            continue
        vals = rng.integers(-20, 20, rng.integers(0, 7)).tolist()
        if strings:
            vals = ["s%d" % v for v in vals]
        out.append([None if elem_nulls and rng.random() < 0.1 else v for v in vals])
    return out


def _pair(data, dtype=None):
    return (ref_lists.from_pylists(data),
            lists.from_pylists(data, dtype, device=CPU))


def _norm(v):
    """NaN as None, in nested values too: the port gives a missing float
    pandas' NaN, the reference None."""
    if isinstance(v, list):
        return [_norm(x) for x in v]
    if isinstance(v, dict):
        return {k: _norm(x) for k, x in v.items()}
    return None if isinstance(v, float) and v != v else v


def _same(got: Column, exp: RefColumn):
    assert _norm(got.to_pylist()) == _norm(exp.to_pylist())


TEXT = ["a,b,,c", None, "", ",x", "abc", "q,", "id0012,7", "1,,2,,3"]
