"""Shared helpers for the ops layer (port of ``cudf_tpu/ops/_utils.py``)."""

from __future__ import annotations

import torch

from cudf_tpu_torch.core.column import Column


def materialize_validity(col: Column) -> torch.Tensor:
    """bool[n] validity vector; all-True if the column has no mask."""
    if col.validity is not None:
        return col.validity
    return torch.ones(col.length, dtype=torch.bool, device=col.device)


def dense_key_table(rk: torch.Tensor, offset: int, domain: int) -> torch.Tensor:
    """Direct-address build for unique integer keys in [offset,
    offset + domain): table[d] = the row whose key is offset + d, -1
    where no row has it.  Keys outside the range are left out."""
    tbl = torch.full((domain + 1,), -1, dtype=torch.int64, device=rk.device)
    pos = rk.long() - offset
    safe = torch.where((pos >= 0) & (pos < domain), pos, domain)
    tbl[safe] = torch.arange(rk.shape[0], device=rk.device)
    return tbl[:domain]


def dense_probe(tbl: torch.Tensor, lk: torch.Tensor, offset: int):
    """(right_row_ids[nl], found[nl]): one gather per probe row."""
    domain = tbl.shape[0]
    pos = lk.long() - offset
    ok = (pos >= 0) & (pos < domain)
    r = tbl[pos.clamp(0, domain - 1)]
    return r, ok & (r >= 0)
