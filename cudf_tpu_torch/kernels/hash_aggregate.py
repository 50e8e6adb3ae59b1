"""Low-cardinality groupby aggregation: kernel A.

Port of ``cudf_tpu/kernels/hash_aggregate.py``.  The CUDA kernel
(``csrc/hash_aggregate.cu``) replaces the Pallas kernel
``onehot_groupby_aggregate`` (body ``_kernel``, ``_dd_update``); its
source note says what bounds it on the H100 and what the design does
about that.  The TPU's one-hot MXU matmuls, bf16 term splits and
double-float accumulators are not carried over: Hopper has shared-memory
atomics and native int64 and fp64.

The contract differs from the reference where the reference was bound by
the TPU: values keep their own width.  Integer and bool values give exact
int64 sums, float32/float64 values float64 sums, and min/max come back in
the values' own dtype.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from cudf_tpu_torch.kernels import _build

SOURCE = "cudf_tpu_torch/csrc/hash_aggregate.cu"
REPLACES = "cudf_tpu/kernels/hash_aggregate.py:145"     # onehot_groupby_aggregate

MAX_GROUPS = 4096      # the one-hot tier's K (ops/groupby.py tier split)

_SIGN = -(1 << 63)     # int64 with only the sign bit set
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]

Result = Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor],
               Optional[torch.Tensor]]


def onehot_groupby_aggregate(keys: torch.Tensor, vals: torch.Tensor,
                             num_groups: int,
                             valid: Optional[torch.Tensor] = None,
                             with_minmax: bool = True) -> Result:
    """(sums[K], counts[K], mins[K], maxs[K]) for group codes in [0, K).

    keys: int32 codes; vals: numeric or bool values; valid: bool mask or
    None.  Rows that are invalid or whose code is out of range are
    dropped.  sums are int64 for integer/bool values and float64 for
    floats; counts int64; mins/maxs in vals' dtype, None unless
    with_minmax.  min/max skip NaN (a group of only NaN gives NaN).  A
    group with no rows has min = the dtype's largest value (+inf for
    floats) and max = its smallest (-inf).

    CPU tensors take the plain PyTorch version; CUDA tensors launch the
    kernel, counted in ``onehot_groupby_aggregate.launches``.
    """
    n = keys.shape[0]
    _build.check_vector("keys", keys, torch.int32, n, keys.device)
    _build.check_vector("vals", vals, vals.dtype, n, keys.device)
    if valid is not None:
        _build.check_vector("valid", valid, torch.bool, n, keys.device)
    if not 1 <= num_groups <= MAX_GROUPS:
        raise ValueError(f"num_groups {num_groups} outside [1, {MAX_GROUPS}]")
    if keys.device.type == "cpu":
        return onehot_groupby_aggregate_plain(keys, vals, num_groups, valid,
                                              with_minmax)
    if keys.device.type != "cuda":
        raise ValueError(f"unsupported device {keys.device}")
    return _launch(keys, vals, num_groups, valid, with_minmax)


onehot_groupby_aggregate.launches = 0


def _launch(keys, vals, K, valid, with_minmax) -> Result:
    kv, kind, acc = _build.kernel_values(vals)
    dev = keys.device
    sums = torch.zeros(K, dtype=acc, device=dev)
    counts = torch.zeros(K, dtype=torch.int64, device=dev)
    mins = maxs = None
    if with_minmax:
        mins = torch.full((K,), -1, dtype=torch.int64, device=dev)  # all ones
        maxs = torch.zeros(K, dtype=torch.int64, device=dev)
    if keys.shape[0]:
        _build.launch("cudf_onehot_aggregate", _ARGTYPES, dev,
                      keys.data_ptr(), kv.data_ptr(), kind, _build.ptr(valid),
                      keys.shape[0], K, int(with_minmax), sums.data_ptr(),
                      counts.data_ptr(), _build.ptr(mins), _build.ptr(maxs))
        onehot_groupby_aggregate.launches += 1
    if with_minmax:
        mins = _decode_order_key(mins, acc)
        maxs = _decode_order_key(maxs, acc)
        mins, maxs = _finish_minmax(mins, maxs, counts, vals.dtype)
    return sums, counts, mins, maxs


def _decode_order_key(enc: torch.Tensor, acc: torch.dtype) -> torch.Tensor:
    """Inverse of csrc/common.cuh order_key: int64 or float64 values.  The
    identities a group of only NaN leaves behind (all ones for min, zero
    for max) decode to NaN."""
    if acc == torch.int64:
        return enc ^ _SIGN
    return torch.where(enc < 0, enc ^ _SIGN, ~enc).view(torch.float64)


def _finish_minmax(mins, maxs, counts, dtype: torch.dtype):
    """Empty groups get the identity, then extrema are cast to the values'
    dtype: the fill happens in the widened dtype, since torch has no
    masked_fill for uint16 and uint32."""
    empty = counts == 0
    lo, hi = _extremes(dtype)
    mins = mins.masked_fill(empty, hi).to(dtype)
    maxs = maxs.masked_fill(empty, lo).to(dtype)
    return mins, maxs


def _extremes(dtype: torch.dtype):
    if dtype == torch.bool:
        return False, True
    if dtype.is_floating_point:
        return float("-inf"), float("inf")
    info = torch.iinfo(dtype)
    return info.min, info.max


def onehot_groupby_aggregate_plain(keys: torch.Tensor, vals: torch.Tensor,
                                   num_groups: int,
                                   valid: Optional[torch.Tensor] = None,
                                   with_minmax: bool = True) -> Result:
    """The same function in plain PyTorch (index_add_ / bincount /
    scatter_reduce_)."""
    K = num_groups
    kv, _, acc = _build.kernel_values(vals)
    ok = (keys >= 0) & (keys < K)
    if valid is not None:
        ok &= valid
    k = keys[ok].long()
    v = kv[ok]
    sums = torch.zeros(K, dtype=acc, device=keys.device).index_add_(0, k, v.to(acc))
    counts = torch.bincount(k, minlength=K)
    if not with_minmax:
        return sums, counts, None, None
    mins, maxs = segment_minmax_plain(k, v, K)
    mins, maxs = _finish_minmax(mins, maxs, counts, vals.dtype)
    return sums, counts, mins, maxs


def segment_minmax_plain(k: torch.Tensor, v: torch.Tensor, K: int):
    """(mins[K], maxs[K]) in v's dtype over int64 group ids k in [0, K).

    NaN is skipped, as pandas skips it, and a group whose values are all
    NaN gives NaN; the kernel follows the same rule.  A group with no
    values gives the identity (min = the dtype's largest value)."""
    lo, hi = _extremes(v.dtype)
    vmin = vmax = v
    if v.dtype.is_floating_point:
        nan = torch.isnan(v)
        vmin, vmax = v.masked_fill(nan, hi), v.masked_fill(nan, lo)
    mins = torch.full((K,), hi, dtype=v.dtype, device=v.device).scatter_reduce_(
        0, k, vmin, "amin")
    maxs = torch.full((K,), lo, dtype=v.dtype, device=v.device).scatter_reduce_(
        0, k, vmax, "amax")
    if v.dtype.is_floating_point:
        only_nan = (torch.bincount(k, minlength=K) > 0) & (
            torch.bincount(k[~nan], minlength=K) == 0)
        mins = mins.masked_fill(only_nan, float("nan"))
        maxs = maxs.masked_fill(only_nan, float("nan"))
    return mins, maxs
