"""Fixtures and helpers shared by tests/test_torch_radix_partition.py,
test_torch_radix_layout.py and test_torch_tile_sort.py."""

import numpy as np
import pytest

from cudf_tpu_torch.kernels import radix_partition as rp


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def _windows(keys, vals, base, G):
    """Per-window sorted (key, val) pairs of a partition."""
    out = []
    for w in range(G):
        k, v = keys[base[w]:base[w + 1]], vals[base[w]:base[w + 1]]
        inw = (k >= w * rp.SPAN) & (k < (w + 1) * rp.SPAN)
        out.append(sorted(zip(k[inw].tolist(), v[inw].tolist())))
    return out
