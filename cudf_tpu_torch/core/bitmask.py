"""Validity mask utilities (port of ``cudf_tpu/core/bitmask.py``).

Validity is a byte-wide ``bool`` tensor of length n, or None when every
row is valid, as in the reference (``core/column.py:6-14``).  Arrow's
little-endian bitmask appears only at the interop boundary:
:func:`pack_bools` / :func:`unpack_bools` convert between the two.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from cudf_tpu_torch.utils import tracing

_BIT_WEIGHTS = (1 << np.arange(8)).astype(np.uint8)


def pack_bools(validity: torch.Tensor) -> torch.Tensor:
    """bool[n] -> uint8[ceil(n/8)] little-endian Arrow bitmask."""
    n = validity.shape[0]
    nbytes = -(-n // 8)
    padded = torch.zeros(nbytes * 8, dtype=torch.uint8, device=validity.device)
    padded[:n] = validity.to(torch.uint8)
    weights = torch.from_numpy(_BIT_WEIGHTS).to(validity.device)
    return (padded.view(nbytes, 8) * weights).sum(dim=1, dtype=torch.uint8)


def unpack_bools(bitmask: torch.Tensor, n: int) -> torch.Tensor:
    """uint8 little-endian Arrow bitmask -> bool[n]."""
    shifts = torch.arange(8, dtype=torch.uint8, device=bitmask.device)
    bits = (bitmask[:, None] >> shifts) & 1
    return bits.reshape(-1)[:n].to(torch.bool)


def and_masks(*masks: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """AND of validity vectors; None means all-valid (identity)."""
    out = None
    for m in masks:
        if m is None:
            continue
        out = m if out is None else (out & m)
    return out


def or_masks(*masks: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """OR of validity vectors; None (all valid) if any operand is."""
    if not masks or any(m is None for m in masks):
        return None
    out = masks[0]
    for m in masks[1:]:
        out = out | m
    return out


def valid_count(validity: Optional[torch.Tensor], n: int) -> int:
    return n - null_count(validity, n)


def null_count(validity: Optional[torch.Tensor], n: int) -> int:
    if validity is None:
        return 0
    return n - int(validity.sum())


def from_numpy_mask(mask, device) -> Optional[torch.Tensor]:
    """numpy bool array (True=valid) -> validity tensor on ``device``, or
    None if all valid."""
    if mask is None:
        return None
    mask = np.asarray(mask, dtype=bool)
    if mask.all():
        return None
    return tracing.synced("host_mask", device, torch.from_numpy(mask.copy()).to, device)
