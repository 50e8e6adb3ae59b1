"""Shared helpers for the ops layer (port of ``cudf_tpu/ops/_utils.py``)."""

from __future__ import annotations

from typing import Optional

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


def maybe_mask(validity: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Drop an all-valid mask back to None (one host sync)."""
    if validity is None or bool(validity.all()):
        return None
    return validity


def segment_expand(offsets: torch.Tensor, total: int) -> torch.Tensor:
    """out[i] = j such that offsets[j] <= i < offsets[j + 1], for the flat
    positions [0, total) of segments given by offsets[g + 1]."""
    pos = torch.arange(total, dtype=offsets.dtype, device=offsets.device)
    return torch.searchsorted(offsets[1:-1].contiguous(), pos, right=True)


def inverse_permutation(order: torch.Tensor) -> torch.Tensor:
    """inv[order[i]] = i: one scatter (the reference sorts (order, iota)
    pairs because scatter is slow on a TPU)."""
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], dtype=order.dtype, device=order.device)
    return inv


_SIGNED = {torch.uint16: torch.int16, torch.uint32: torch.int32, torch.uint64: torch.int64}


def signed_view(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bits as the signed int of its width when it is
    uint16/32/64 (PyTorch indexes them on no CUDA device and scatters
    into them on no CPU), else the tensor itself."""
    return t.view(_SIGNED[t.dtype]) if t.dtype in _SIGNED else t


# how many calls took a host route, by function: the host factories and
# exports of LIST and STRUCT columns and the decimal text casts, where
# the reference goes to the host too
HOST_ROUTES = {}


def count_host_route(name: str) -> None:
    HOST_ROUTES[name] = HOST_ROUTES.get(name, 0) + 1
