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
the values' own dtype.  One call takes several value columns under one
mask (the groupby's requests that share a mask), so the keys are read
once for all of them.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple, Union

import torch

from cudf_tpu_torch.kernels import _build

SOURCE = "cudf_tpu_torch/csrc/hash_aggregate.cu"
REPLACES = "cudf_tpu/kernels/hash_aggregate.py:145"     # onehot_groupby_aggregate

MAX_GROUPS = 4096      # the one-hot tier's K (ops/groupby.py tier split)
MAX_COLUMNS = 4        # value columns per kernel A launch (csrc kMaxColumns)
MAX_SHARED = 232_448   # dynamic shared memory of one block (csrc kMaxBlockShared)

_SIGN = -(1 << 63)     # int64 with only the sign bit set
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_int] + [ctypes.c_void_p] * 6

Result = Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor],
               Optional[torch.Tensor]]
# the list form: (sums, counts, mins, maxs), one entry a column in each list
ListResult = Tuple[List[torch.Tensor], torch.Tensor, List[Optional[torch.Tensor]],
                   List[Optional[torch.Tensor]]]


def onehot_groupby_aggregate(keys: torch.Tensor,
                             vals: Union[torch.Tensor, Sequence[torch.Tensor]],
                             num_groups: int,
                             valid: Optional[torch.Tensor] = None,
                             with_minmax: Union[bool, Sequence[bool]] = True
                             ) -> Union[Result, ListResult]:
    """(sums[K], counts[K], mins[K], maxs[K]) for group codes in [0, K).

    keys: int32 codes; vals: numeric or bool values; valid: bool mask or
    None.  Rows that are invalid or whose code is out of range are
    dropped.  sums are int64 for integer/bool values and float64 for
    floats; counts int64; mins/maxs in vals' dtype, None unless
    with_minmax.  min/max skip NaN (a group of only NaN gives NaN).  A
    group with no rows has min = the dtype's largest value (+inf for
    floats) and max = its smallest (-inf).

    ``vals`` may also be a non-empty list of value tensors, dtypes mixed,
    under the one mask: then sums, mins and maxs are lists with an entry
    a column (mins[j] and maxs[j] None unless with_minmax, a bool or a
    bool a column, asks), counts is shared, and the keys are read once.

    CPU tensors take the plain PyTorch version; CUDA tensors launch the
    kernel, counted in ``onehot_groupby_aggregate.launches``: one launch
    for all the columns unless their bins outgrow one block's shared
    memory (see ``column_launches``).
    """
    single = isinstance(vals, torch.Tensor)
    vlist = [vals] if single else list(vals)
    flags = _minmax_flags(vlist, with_minmax)
    n = keys.shape[0]
    _build.check_vector("keys", keys, torch.int32, n, keys.device)
    for v in vlist:
        _build.check_vector("vals", v, v.dtype, n, keys.device)
    if valid is not None:
        _build.check_vector("valid", valid, torch.bool, n, keys.device)
    if not 1 <= num_groups <= MAX_GROUPS:
        raise ValueError(f"num_groups {num_groups} outside [1, {MAX_GROUPS}]")
    if n >= 1 << 31:
        raise ValueError("the kernel counts a block's rows in uint32: n < 2^31")
    if keys.device.type == "cpu":
        return onehot_groupby_aggregate_plain(keys, vals, num_groups, valid, with_minmax)
    if keys.device.type != "cuda":
        raise ValueError(f"unsupported device {keys.device}")
    outs = _launch(keys, vlist, num_groups, valid, flags)
    return outs[0] if single else _as_lists(outs)


onehot_groupby_aggregate.launches = 0


def _minmax_flags(vlist: Sequence[torch.Tensor],
                  with_minmax: Union[bool, Sequence[bool]]) -> List[bool]:
    """One min/max flag a value tensor; raises unless there is at least one
    value tensor and, for a list of flags, one flag each."""
    flags = ([with_minmax] * len(vlist) if isinstance(with_minmax, bool)
             else [bool(f) for f in with_minmax])
    if not vlist or len(flags) != len(vlist):
        raise ValueError("onehot_groupby_aggregate: at least one value tensor, and one "
                         "with_minmax flag a value tensor")
    return flags


def column_launches(num_groups: int, with_minmax: Sequence[bool]) -> List[List[int]]:
    """Kernel A's launches for columns with these min/max flags: runs of
    consecutive column indices, each at most MAX_COLUMNS columns whose bins
    (a uint32 count, an 8-byte sum a column, two 8-byte order keys a
    min/max column) fit one block's shared memory at one replica, as
    csrc/hash_aggregate.cu lays them out."""
    launches: List[List[int]] = []
    slots = 0
    for j, mm in enumerate(with_minmax):
        need = 3 if mm else 1
        if (not launches or len(launches[-1]) == MAX_COLUMNS
                or num_groups * (8 * (slots + need) + 4) > MAX_SHARED):
            launches.append([])
            slots = 0
        launches[-1].append(j)
        slots += need
    return launches


def onehot_aggregate_occupancy(num_groups: int, with_minmax: Sequence[bool]) -> dict:
    """Kernel A's registers a thread, resident blocks per SM, threads per
    block, dynamic shared memory per block (bytes) and bin replicas on the
    current CUDA device for one launch of columns with these flags."""
    out = [ctypes.c_int(0) for _ in range(5)]
    dev = torch.device("cuda", torch.cuda.current_device())
    _build.launch("cudf_onehot_aggregate_occupancy", [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5,
                  dev, num_groups, sum(3 if mm else 1 for mm in with_minmax),
                  *[ctypes.addressof(v) for v in out])
    return dict(zip(("registers", "blocks_per_sm", "threads", "smem_bytes", "replicas"),
                    (v.value for v in out)))


def _launch(keys, vlist, K, valid, flags) -> List[Result]:
    dev = keys.device
    kvs = [_build.kernel_values(v) for v in vlist]
    counts = torch.zeros(K, dtype=torch.int64, device=dev)
    sums = [torch.zeros(K, dtype=acc, device=dev) for _, _, acc in kvs]
    mins = [torch.full((K,), -1, dtype=torch.int64, device=dev) if mm else None   # all ones
            for mm in flags]
    maxs = [torch.zeros(K, dtype=torch.int64, device=dev) if mm else None for mm in flags]
    if keys.shape[0]:
        for i, part in enumerate(column_launches(K, flags)):
            arrays = [(ctypes.c_void_p * MAX_COLUMNS)(*[_build.ptr(t[j]) for j in part])
                      for t in ([kv for kv, _, _ in kvs], sums, mins, maxs)]
            kinds = (ctypes.c_int * MAX_COLUMNS)(*[kvs[j][1] for j in part])
            vals_p, sums_p, mins_p, maxs_p = (ctypes.addressof(a) for a in arrays)
            _build.launch("cudf_onehot_aggregate", _ARGTYPES, dev, keys.data_ptr(),
                          _build.ptr(valid), keys.shape[0], K, len(part), vals_p,
                          ctypes.addressof(kinds), sums_p, mins_p, maxs_p,
                          counts.data_ptr() if i == 0 else None,
                          counter=onehot_groupby_aggregate,
                          nbytes=onehot_bytes(keys, valid, [kvs[j][0] for j in part],
                                              [t[j] for t in (sums, mins, maxs) for j in part]
                                              + [counts if i == 0 else None]))
    outs = []
    for j, v in enumerate(vlist):
        mn = mx = None
        if flags[j]:
            acc = kvs[j][2]
            mn, mx = _finish_minmax(_decode_order_key(mins[j], acc),
                                    _decode_order_key(maxs[j], acc), counts, v.dtype)
        outs.append((sums[j], counts, mn, mx))
    return outs


def onehot_bytes(keys: torch.Tensor, valid: Optional[torch.Tensor],
                 vals: Sequence[torch.Tensor], outs: Sequence[Optional[torch.Tensor]]) -> int:
    """One launch of kernel A's least bytes: keys, mask and value columns
    read once, its bins (sums, min/max keys, counts) written once."""
    return _build.nbytes(keys, valid, *vals, *outs)


def _as_lists(outs: Sequence[Result]) -> ListResult:
    return ([o[0] for o in outs], outs[0][1], [o[2] for o in outs], [o[3] for o in outs])


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


def onehot_groupby_aggregate_plain(keys: torch.Tensor,
                                   vals: Union[torch.Tensor, Sequence[torch.Tensor]],
                                   num_groups: int,
                                   valid: Optional[torch.Tensor] = None,
                                   with_minmax: Union[bool, Sequence[bool]] = True
                                   ) -> Union[Result, ListResult]:
    """The same function in plain PyTorch (index_add_ / bincount /
    scatter_reduce_), for one value tensor or a list of them, as
    ``onehot_groupby_aggregate``."""
    if isinstance(vals, torch.Tensor):
        return _plain(keys, vals, num_groups, valid, with_minmax)
    flags = _minmax_flags(vals, with_minmax)
    return _as_lists([_plain(keys, v, num_groups, valid, mm) for v, mm in zip(vals, flags)])


def _plain(keys, vals, num_groups, valid, with_minmax) -> Result:
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
