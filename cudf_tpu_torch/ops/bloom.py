"""Device bloom filter for join-filter pushdown (port of
``cudf_tpu/ops/bloom.py``).

A row's k bit positions are Kirsch–Mitzenmacher double hashing over two
murmur3 hashes (seeds 0 and 0x9747B28C): ``(h1 + i * h2) mod 2^32 mod m``,
i < k, the reference's uint32 wraparound kept by computing in int64 and
masking to 32 bits before the remainder.  Build is one scatter of True,
probe k gathers and an AND; the bits are the reference's.
"""

from __future__ import annotations

from typing import Sequence

import torch

from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.ops.hashing import M32, murmurhash3_x86_32
from cudf_tpu_torch.utils import tracing

__all__ = ["BloomFilter"]

SEED2 = 0x9747B28C


class BloomFilter:
    """m bits, k positions a row.  The bits live on the device of the
    first columns added or probed."""

    def __init__(self, num_bits: int = 1 << 23, num_hashes: int = 4):
        self.m = int(num_bits)
        self.k = int(num_hashes)
        self.bits = None

    def _bits_on(self, device) -> torch.Tensor:
        if self.bits is None:
            self.bits = torch.zeros(self.m, dtype=torch.bool, device=device)
        return self.bits

    def _positions(self, cols: Sequence[Column]) -> torch.Tensor:
        """int64 [k * n]: hash i of every row, then hash i + 1."""
        h1 = murmurhash3_x86_32(cols, seed=0).data.view(torch.int32).long() & M32
        h2 = murmurhash3_x86_32(cols, seed=SEED2).data.view(torch.int32).long() & M32
        i = torch.arange(self.k, dtype=torch.int64, device=h1.device)[:, None]
        return (((h1[None, :] + i * h2[None, :]) & M32) % self.m).reshape(-1)

    def add(self, cols: Sequence[Column]) -> "BloomFilter":
        self._bits_on(cols[0].device)[self._positions(cols)] = True
        return self

    def maybe_contains(self, cols: Sequence[Column]) -> torch.Tensor:
        """bool[n]: False guarantees absence; True may be a false positive."""
        n = cols[0].length
        return self._bits_on(cols[0].device)[self._positions(cols)].view(self.k, n).all(0)

    def fill_ratio(self) -> float:
        if self.bits is None:
            return 0.0
        return tracing.to_int(self.bits.sum(), "scalar_result") / self.m
