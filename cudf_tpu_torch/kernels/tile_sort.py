"""Per-tile sort: kernels E and F.

Port of ``cudf_tpu/kernels/bitonic.py``:

- ``tile_sort`` (kernel E) replaces the Pallas ``tile_sort``: a key and
  riders, returned as a tuple;
- ``tile_sort_data`` (kernel F) replaces ``tile_sort_data``, the first
  step of every pass of the sorted partition route
  (``radix_partition.radix_partition`` with ``merge_tiles > 1``).

Both sort each tile of ``tile`` keys by the signed int32 key, or under
``mask_bits`` m by ``key & (2^m - 1)`` with negative keys first (the
reference's SENTINEL); the output keeps the full key.  ``alternate``
makes odd tiles the exact reverse of their ascending order.  One CUDA
kernel serves both wrappers (``csrc/tile_sort.cu``; its note says what
bounds it on the H100); each wrapper counts its own launches.

Differences from the reference:

- Data stays flat: keys ``int32[n]`` and columns ``[n]`` of 4 or 8 bytes,
  not plane-interleaved ``[P, R, 128]`` int32 rows, so float64 payloads
  are not rounded to float32 (``radix_partition.py:661-666`` rounds them).
- The sort is stable: ties keep their input order.  The reference's
  bitonic network breaks ties arbitrarily.
- The last tile may be short; a tile holds at most ``MAX_TILE`` keys.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from cudf_tpu_torch.kernels import _build

SOURCE = "cudf_tpu_torch/csrc/tile_sort.cu"
REPLACES = {          # the Pallas kernel of the same name, file:line
    "tile_sort": "cudf_tpu/kernels/bitonic.py:198",
    "tile_sort_data": "cudf_tpu/kernels/bitonic.py:175",
}

MAX_TILE = 4096       # keys per tile: the kernel's shared-memory staging
MAX_MASK_BITS = 30

_SORT_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                  ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                  ctypes.c_void_p, ctypes.c_void_p]


def check_mask_bits(mask_bits: Optional[int]) -> int:
    """mask_bits as the kernels take it: 0 for None, else 1..MAX_MASK_BITS."""
    if mask_bits is None:
        return 0
    if not 1 <= mask_bits <= MAX_MASK_BITS:
        raise ValueError(f"mask_bits {mask_bits} outside [1, {MAX_MASK_BITS}]")
    return mask_bits


def _sort(wrapper, keys, columns, tile, alternate, mask_bits):
    n = _build.check_columns(keys, columns)
    mask = check_mask_bits(mask_bits)
    if not 1 <= tile <= MAX_TILE:
        raise ValueError(f"tile {tile} outside [1, {MAX_TILE}]")
    if keys.device.type == "cpu":
        return tile_sort_data_plain(keys, columns, tile, alternate, mask_bits)
    out_keys = torch.empty_like(keys)
    outs = [torch.empty_like(c) for c in columns]
    if n:
        src, dst, widths = _build.column_arrays(columns, outs)
        _build.launch("cudf_tile_sort", _SORT_ARGTYPES, keys.device, keys.data_ptr(), n,
                      tile, int(alternate), mask, out_keys.data_ptr(), len(columns),
                      ctypes.addressof(src), ctypes.addressof(dst), ctypes.addressof(widths))
        wrapper.launches += 1
    return out_keys, outs


def tile_sort_data(keys: torch.Tensor, payloads: Sequence[torch.Tensor], tile: int,
                   alternate: bool = False, mask_bits: Optional[int] = None
                   ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(keys, payloads) sorted per tile of ``tile`` keys (kernel F).

    keys: int32[n].  payloads: at most MAX_PAYLOADS 4- or 8-byte tensors [n]
    that move with their keys.  Each tile is sorted stably by the signed
    key, or with ``mask_bits`` m by ``key & (2^m - 1)``, negative keys
    first; ``alternate`` reverses odd tiles.  CUDA tensors launch kernel F,
    counted in ``tile_sort_data.launches``."""
    return _sort(tile_sort_data, keys, list(payloads), tile, alternate, mask_bits)


tile_sort_data.launches = 0


def tile_sort(key: torch.Tensor, *riders: torch.Tensor, tile: int,
              alternate: bool = False, mask_bits: Optional[int] = None
              ) -> Tuple[torch.Tensor, ...]:
    """(key, *riders) sorted per tile of ``tile`` keys (kernel E): the
    reference's ``tile_sort`` over flat tensors, with tile_sort_data's
    order.  CUDA tensors launch the kernel, counted in
    ``tile_sort.launches``."""
    out_key, outs = _sort(tile_sort, key, list(riders), tile, alternate, mask_bits)
    return (out_key, *outs)


tile_sort.launches = 0


def sort_key_plain(keys: torch.Tensor, mask_bits: Optional[int]) -> torch.Tensor:
    """int64 order key: the key, or under mask_bits m ``key & (2^m - 1)``
    with -1 for a negative key."""
    k = keys.long()
    if mask_bits is None:
        return k
    return torch.where(k >= 0, k & ((1 << mask_bits) - 1), -1)


def tile_permutation(keys: torch.Tensor, tile: int, alternate: bool = False,
                     mask_bits: Optional[int] = None) -> torch.Tensor:
    """int64[n]: for each output row of the tile sort, its input row.  A
    stable torch.sort per tile on a [tiles, tile] view; a short last tile
    is padded with keys past every real one, which stay last."""
    n = keys.shape[0]
    nt = -(-n // tile)
    order = sort_key_plain(keys, mask_bits)
    pad = nt * tile - n
    if pad:
        order = torch.cat([order, order.new_full((pad,), 1 << 40)])
    idx = torch.sort(order.view(nt, tile), dim=1, stable=True).indices
    idx += torch.arange(nt, device=keys.device).unsqueeze(1) * tile
    if alternate:
        idx[1::2] = idx[1::2].flip(1)
    idx = idx.view(-1)
    return idx[idx < n] if pad else idx


def tile_sort_data_plain(keys, payloads, tile, alternate=False, mask_bits=None):
    """The same sort in plain PyTorch: the tile permutation, then one
    gather per column."""
    perm = tile_permutation(keys, tile, alternate, mask_bits)
    return keys[perm], [p[perm] for p in payloads]
