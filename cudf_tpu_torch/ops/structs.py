"""STRUCT columns (port of ``cudf_tpu/ops/structs.py``; libcudf's
cpp/src/structs/).

A STRUCT column holds one child column a field, each of the column's
length, and the row mask in ``validity``.  ``field`` reads a field as
pandas' ``struct.field`` does: null where the row or the field is.
``from_pydicts`` and ``to_pydicts`` are the host factories, counted in
``HOST_ROUTES`` as the reference goes to the host there too.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from cudf_tpu_torch.core import bitmask as bm
from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.core.table import Table
from cudf_tpu_torch.ops._utils import count_host_route
from cudf_tpu_torch.utils import tracing


def make_struct_column(fields: Sequence[Tuple[str, Column]],
                       validity: Optional[torch.Tensor] = None) -> Column:
    dtype = dt.struct_dtype([(name, c.dtype) for name, c in fields])
    n = fields[0][1].length if fields else validity.shape[0]
    return Column(dtype, n, None, validity, children=[c for _, c in fields])


def from_pydicts(dicts, *, device) -> Column:
    """Host factory: dicts (None: a null row) onto ``device``, one field a
    key in order of first appearance (a row without a key: null there)."""
    count_host_route("from_pydicts")
    dicts = list(dicts)
    keys = list(dict.fromkeys(k for d in dicts if d is not None for k in d))
    mask = np.array([d is not None for d in dicts], bool)
    fields = [(k, Column.from_pylist([None if d is None else d.get(k) for d in dicts],
                                     device=device)) for k in keys]
    validity = bm.from_numpy_mask(mask, device)
    if not fields and validity is None:
        validity = torch.ones(len(dicts), dtype=torch.bool, device=device)
    return make_struct_column(fields, validity)


def to_pydicts(col: Column) -> list:
    """Host export: each row as a dict of its fields, None for a null row."""
    count_host_route("to_pydicts")
    names = [n for n, _ in col.dtype.fields]
    vals = [c.to_pylist() for c in col.children]
    valid = None if col.validity is None else tracing.tolist(col.validity, "export")
    return [None if valid is not None and not valid[i] else
            {n: vals[j][i] for j, n in enumerate(names)} for i in range(col.length)]


def field(col: Column, name_or_idx) -> Column:
    """One field (by name or position), null where the row is null."""
    names = [n for n, _ in col.dtype.fields]
    i = name_or_idx if isinstance(name_or_idx, int) else names.index(name_or_idx)
    child = col.children[i]
    if col.validity is None:
        return child
    return child.with_validity(bm.and_masks(child.validity, col.validity))


def explode_to_table(col: Column) -> Table:
    """One column a field (``struct.explode()``)."""
    return Table({n: field(col, n) for n, _ in col.dtype.fields})
