"""t-digest sketches for approximate quantiles (port of
``cudf_tpu/ops/tdigest.py``; libcudf's tdigest_aggregation.cu).

A digest is the sorted values clustered by the k1 scale function
(resolution at the tails) into at most ``delta`` centroids: each value's
centroid is ``floor(k1(q) * delta)`` of its cumulative-weight quantile
q, and a centroid's mean and weight are the sums over its values.
Merging re-clusters the concatenated centroids sorted by mean (the
MergingDigest), so digests of partitions combine.  ``percentile_approx``
interpolates between the centroids' cumulative-weight midpoints, with
the exact min and max as the end nodes.  Everything runs on the values'
device; a digest's ``min`` and ``max`` are host floats (one host sync).
The per-group digests of ``groupby().agg("tdigest")`` are
``ops/groupby.py`` ``group_tdigest``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import numpy as np
import torch

from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import Column

__all__ = ["TDigest", "build_tdigest", "merge_tdigests", "percentile_approx"]


class TDigest(NamedTuple):
    means: torch.Tensor    # float64 [delta]
    weights: torch.Tensor  # float64 [delta]
    min: float
    max: float


def k_scale(q: torch.Tensor) -> torch.Tensor:
    """The k1 scale function, in [0, 1]."""
    return torch.asin(2.0 * torch.clamp(q, 0.0, 1.0) - 1.0) / math.pi + 0.5


def _cluster(sorted_x: torch.Tensor, w: torch.Tensor, delta: int) -> TDigest:
    """Sorted (value, weight) pairs into <= delta centroids."""
    total = w.sum()
    q = (torch.cumsum(w, 0) - w * 0.5) / torch.clamp(total, min=1e-300)
    cid = torch.clamp(torch.floor(k_scale(q) * delta).long(), 0, delta - 1)
    wsum = torch.zeros(delta, dtype=torch.float64, device=w.device).index_add_(0, cid, w)
    xsum = torch.zeros(delta, dtype=torch.float64, device=w.device).index_add_(
        0, cid, sorted_x * w)
    means = torch.where(wsum > 0, xsum / torch.clamp(wsum, min=1e-300), 0.0)
    if sorted_x.shape[0] == 0:
        return TDigest(means, wsum, float("nan"), float("nan"))
    lo, hi = torch.stack([sorted_x[0], sorted_x[-1]]).tolist()
    return TDigest(means, wsum, lo, hi)


def build_tdigest(col: Column, delta: int = 100) -> TDigest:
    """Sketch one column (nulls and NaN left out) in <= delta centroids."""
    x = col.data.double()
    valid = ~torch.isnan(x)
    if col.validity is not None:
        valid &= col.validity
    xs = torch.sort(x[valid]).values
    return _cluster(xs, torch.ones_like(xs), delta)


def merge_tdigests(digests: Sequence[TDigest], delta: int = 100) -> TDigest:
    """Combine the digests of partitions (MERGE_TDIGEST)."""
    means = torch.cat([d.means for d in digests])
    weights = torch.cat([d.weights for d in digests])
    order = torch.sort(means, stable=True).indices
    out = _cluster(means[order], weights[order], delta)
    return TDigest(out.means, out.weights, float(np.nanmin([d.min for d in digests])),
                   float(np.nanmax([d.max for d in digests])))


def percentile_approx(digest: TDigest, percentiles) -> Column:
    """FLOAT64 estimates at ``percentiles`` (cudf::percentile_approx)."""
    w = digest.weights
    dev = w.device
    ps = torch.as_tensor(np.atleast_1d(np.asarray(percentiles, np.float64)), device=dev)
    total = w.sum()
    cum = torch.cumsum(w, 0) - w * 0.5
    keep = w > 0
    # interpolation nodes: min at 0, the non-empty centroids' midpoints, max at total
    nodes_m = torch.cat([torch.tensor([digest.min], dtype=torch.float64, device=dev),
                         digest.means[keep],
                         torch.tensor([digest.max], dtype=torch.float64, device=dev)])
    nodes_c = torch.cat([torch.zeros(1, dtype=torch.float64, device=dev), cum[keep],
                         total.reshape(1)])
    k = nodes_c.shape[0]
    target = ps * total
    hi = torch.clamp(torch.searchsorted(nodes_c, target), 0, k - 1)
    lo = torch.clamp(hi - 1, 0, k - 1)
    c_lo, c_hi = nodes_c[lo], nodes_c[hi]
    m_lo, m_hi = nodes_m[lo], nodes_m[hi]
    frac = torch.where(c_hi > c_lo, (target - c_lo) / torch.clamp(c_hi - c_lo, min=1e-300), 0.0)
    est = torch.clamp(m_lo + frac * (m_hi - m_lo), digest.min, digest.max)
    return Column(dt.FLOAT64, est.shape[0], est)
