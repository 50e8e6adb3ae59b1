"""Whole-column reductions, null- and NaN-skipping as pandas' skipna
(port of ``cudf_tpu/ops/reductions.py``).  Each returns a host scalar
(one host sync).  Integer and bool sums accumulate in int64; float sums,
means and moments in float64, whatever the column's width."""

from __future__ import annotations

import numpy as np
import torch

from cudf_tpu_torch.core.column import Column


def _masked(col: Column, identity) -> torch.Tensor:
    if col.validity is None:
        return col.data
    return torch.where(col.validity, col.data, torch.tensor(identity, dtype=col.data.dtype,
                                                            device=col.device))


def _nan_aware_validity(col: Column):
    """pandas' skipna also skips NaN values in float columns."""
    v = col.validity
    if col.dtype.is_float:
        notnan = ~torch.isnan(col.data)
        v = notnan if v is None else v & notnan
    return v


def _numeric(col: Column, what: str) -> None:
    if col.dtype.is_string or col.dtype.is_dictionary:
        raise TypeError(f"{what} of a {col.dtype!r} column")


def count(col: Column) -> int:
    v = _nan_aware_validity(col)
    return col.length if v is None else int(v.sum())


def _accumulated(col: Column, fill, as_float: bool = False):
    """The values in int64 (integers, bool; uint64 as its bits, which
    add and multiply as uint64 does) or float64 (floats, or any column
    with as_float), fill where skipped."""
    _numeric(col, "sum")
    v = _nan_aware_validity(col)
    if col.dtype.is_float or as_float:
        x = col.data.double()
    elif col.data.dtype == torch.uint64:
        x = col.data.view(torch.int64)
    else:
        x = col.data.long()
    return x if v is None else torch.where(v, x, fill), v


def _int_result(col: Column, total: int) -> int:
    """An int64-held total as the column's integer (uint64 modulo 2^64)."""
    return int(total) % (1 << 64) if col.data.dtype == torch.uint64 else int(total)


def sum(col: Column, min_count: int = 0):  # noqa: A001
    x, v = _accumulated(col, 0)
    n = torch.tensor(col.length, device=x.device) if v is None else v.sum()
    total, n = torch.stack([x.sum(), n.to(x.dtype)]).tolist()
    if min_count > 0 and n < min_count:
        return None
    return float(total) if col.dtype.is_float else _int_result(col, total)


def product(col: Column, min_count: int = 0):
    x, _ = _accumulated(col, 1)
    return float(x.prod()) if col.dtype.is_float else _int_result(col, x.prod())


def sum_of_squares(col: Column):
    x, _ = _accumulated(col, 0)
    return float((x * x).sum()) if col.dtype.is_float else _int_result(col, (x * x).sum())


def minmax(col: Column):
    return min(col), max(col)


def min(col: Column):  # noqa: A001
    return _minmax(col, "min")


def max(col: Column):  # noqa: A001
    return _minmax(col, "max")


def _minmax(col: Column, which: str):
    if count(col) == 0:
        return None
    if col.dtype.is_dictionary:
        return _minmax(col.decode_dictionary(), which)
    if col.dtype.is_string:
        from cudf_tpu_torch.ops.sort import sorted_order

        return _string_at(col, int(sorted_order([col], [which == "min"], "last")[0]))
    v = _nan_aware_validity(col)
    d = col.data
    if col.dtype.is_float:
        fill = float("inf") if which == "min" else float("-inf")
    elif col.dtype.is_bool:
        fill = which == "min"
    else:
        info = torch.iinfo(d.dtype if d.dtype != torch.uint64 else torch.int64)
        fill = info.max if which == "min" else info.min
    flip = d.dtype == torch.uint64        # order-preserving int64: bits ^ 2^63
    if d.dtype in (torch.uint16, torch.uint32):
        d = d.long()
    elif flip:
        d = d.view(torch.int64) ^ (-(1 << 63))
    if v is not None:
        d = torch.where(v, d, torch.tensor(fill, dtype=d.dtype, device=d.device))
    val = (d.min() if which == "min" else d.max()).item()
    if flip:
        val = (val ^ (-(1 << 63))) % (1 << 64)
    if col.dtype.is_temporal:
        return np.int64(val).astype(col.dtype.to_numpy())
    if col.dtype.is_bool:
        return bool(val)
    return val


def _string_at(col: Column, row: int) -> str:
    from cudf_tpu_torch.ops.copying import gather

    return gather(col, torch.tensor([row], device=col.device), bounds_check=False
                  ).host_strings()[0]


def mean(col: Column):
    n = count(col)
    if n == 0:
        return float("nan")
    if col.data.dtype == torch.uint64:     # its exact sum wraps at 2^64
        return float(_accumulated(col, 0, as_float=True)[0].sum()) / n
    return float(sum(col)) / n


def var(col: Column, ddof: int = 1):
    n = count(col)
    if n - ddof <= 0:
        return float("nan")
    x, v = _accumulated(col, 0, as_float=True)
    centered = x - x.sum() / n
    if v is not None:
        centered = torch.where(v, centered, 0.0)
    return float((centered * centered).sum() / (n - ddof))


def std(col: Column, ddof: int = 1):
    return float(np.sqrt(var(col, ddof)))


def any(col: Column) -> bool:  # noqa: A001
    return bool(_masked(col, False).to(torch.bool).any())


def all(col: Column) -> bool:  # noqa: A001
    return bool(_masked(col, True).to(torch.bool).all())


def _arg_extreme(col: Column, which: str) -> int:
    v = _nan_aware_validity(col)
    if col.dtype.is_float:
        data = col.data.double()
    elif col.data.dtype == torch.uint64:           # order-preserving int64
        data = col.data.view(torch.int64) ^ (-(1 << 63))
    else:
        data = col.data.long()
    if v is not None:
        fill = (float("inf") if which == "min" else float("-inf")) if col.dtype.is_float else (
            torch.iinfo(torch.int64).max if which == "min" else torch.iinfo(torch.int64).min)
        data = torch.where(v, data, fill)
    return int(data.argmin() if which == "min" else data.argmax())


def argmin(col: Column) -> int:
    return _arg_extreme(col, "min")


def argmax(col: Column) -> int:
    return _arg_extreme(col, "max")


def nunique(col: Column, dropna: bool = True) -> int:
    from cudf_tpu_torch.ops import stream_compaction

    return stream_compaction.distinct_count(col, dropna=dropna)


def quantile(col: Column, q, interpolation: str = "linear"):
    """cudf::quantile, pandas' interpolations ("linear" by default)."""
    _numeric(col, "quantile")
    v = _nan_aware_validity(col)
    data = col.data.double() if v is None else col.data[v].double()
    scalar = np.isscalar(q)
    if data.shape[0] == 0:
        return float("nan") if scalar else np.full(len(q), np.nan)
    data = torch.sort(data).values
    qs = np.atleast_1d(np.asarray(q, dtype=np.float64))
    pos = qs * (data.shape[0] - 1)
    lo = np.floor(pos).astype(np.int64)
    hi = np.ceil(pos).astype(np.int64)
    picked = data[torch.from_numpy(np.concatenate([lo, hi])).to(data.device)].cpu().numpy()
    dlo, dhi = picked[:len(qs)], picked[len(qs):]
    if interpolation == "linear":
        out = dlo + (pos - lo) * (dhi - dlo)
    elif interpolation == "lower":
        out = dlo
    elif interpolation == "higher":
        out = dhi
    elif interpolation == "nearest":
        out = np.where(pos - lo <= 0.5, dlo, dhi)
    elif interpolation == "midpoint":
        out = (dlo + dhi) / 2
    else:
        raise ValueError(interpolation)
    return float(out[0]) if scalar else out


def median(col: Column):
    return quantile(col, 0.5)


def _moments(col: Column, orders):
    x, v = _accumulated(col, 0, as_float=True)
    n = count(col)
    d = x - x.sum() / n
    if v is not None:
        d = torch.where(v, d, 0.0)
    return n, torch.stack([(d ** k).sum() / n for k in orders]).tolist()


def skew(col: Column):
    """Fisher-Pearson adjusted skewness, pandas semantics."""
    if count(col) < 3:
        return float("nan")
    n, (m2, m3) = _moments(col, (2, 3))
    if m2 == 0:
        return float("nan")
    return float(m3 / m2 ** 1.5 * np.sqrt(n * (n - 1)) / (n - 2))


def kurtosis(col: Column):
    if count(col) < 4:
        return float("nan")
    n, (m2, m4) = _moments(col, (2, 4))
    if m2 == 0:
        return float("nan")
    g2 = m4 / m2 ** 2 - 3
    return float(((n - 1) / ((n - 2) * (n - 3))) * ((n + 1) * g2 + 6))

