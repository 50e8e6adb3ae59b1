"""Inclusive scans with pandas' skipna (port of ``cudf_tpu/ops/scan.py``).

``cumsum``, ``cumprod``, ``cummin`` and ``cummax`` are ``torch.cumsum``,
``torch.cumprod``, ``torch.cummin`` and ``torch.cummax`` over the column
with each skipped row replaced by the operation's identity (``cummin``
and ``cummax`` in rows of 4096: ``running_extreme``).  A null row
stays null; a NaN that is not null is skipped as pandas skips it and
comes back at its own row (the reference lets it run through every later
row).  Output dtypes are the reference's: a bool or narrower-than-64-bit
integer cumsum, and a bool cumprod, give int64.

``ewm_mean`` is the reference's affine scan of (a, b) pairs, y <- a*y +
b.  PyTorch has no associative scan, so it is built by doubling: log2(n)
passes, each composing every pair with the one ``d`` rows before it.
"""

from __future__ import annotations

import torch

from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import Column

_OPS = ("cumsum", "cumprod", "cummin", "cummax")
_I64_MIN = -(1 << 63)


def _out_dtype(col: Column, op: str) -> dt.DType:
    if op == "cumsum" and (col.dtype.is_bool or (col.dtype.is_integer
                                                 and col.dtype.itemsize < 8)):
        return dt.INT64
    if op == "cumprod" and col.dtype.is_bool:
        return dt.INT64
    return col.dtype


_BLOCK = 4096


def running_extreme(x: torch.Tensor, op: str) -> torch.Tensor:
    """torch.cummin / torch.cummax values (op "cummin" or "cummax") of a
    1-D tensor without NaN, in blocks: PyTorch's scan of one long row runs
    in few threads on a card (~0.3 s for 1e8 rows on an H100), so the
    column is scanned as rows of 4096, then each row takes the extreme of
    the rows before it."""
    n = x.shape[0]
    if n <= _BLOCK:
        return (torch.cummin if op == "cummin" else torch.cummax)(x, 0).values
    fill = _identity(op, x)
    rows = -(-n // _BLOCK)
    padded = torch.cat([x, x.new_full((rows * _BLOCK - n,), fill)]).view(rows, _BLOCK)
    fn = torch.cummin if op == "cummin" else torch.cummax
    within = fn(padded, 1).values
    carry = fn(within[:, -1], 0).values
    before = torch.cat([carry.new_full((1,), fill), carry[:-1]])
    pick = torch.minimum if op == "cummin" else torch.maximum
    return pick(within, before[:, None]).reshape(-1)[:n]


def _identity(op: str, x: torch.Tensor):
    if op == "cumsum":
        return 0
    if op == "cumprod":
        return 1
    if x.is_floating_point():
        return float("inf") if op == "cummin" else float("-inf")
    info = torch.iinfo(x.dtype)
    return info.max if op == "cummin" else info.min


def scan(col: Column, op: str) -> Column:
    """op in {cumsum, cumprod, cummin, cummax}."""
    if op not in _OPS:
        raise ValueError(op)
    if col.dtype.is_string or col.dtype.is_dictionary or col.dtype.is_timestamp:
        if not (col.dtype.is_timestamp and op in ("cummin", "cummax")):
            raise TypeError(f"{op} of a {col.dtype!r} column")
    out = _out_dtype(col, op)
    x = col.data
    back = None
    if out.is_integer and out.itemsize == 8 and not x.dtype.is_floating_point:
        if x.dtype == torch.uint64:
            x = x.view(torch.int64)
            if op in ("cummin", "cummax"):           # order-preserving int64
                x, back = x ^ _I64_MIN, _I64_MIN
        else:
            x = x.long()
    elif x.dtype in (torch.uint16, torch.uint32):
        x = x.long()
    elif x.dtype == torch.bool:
        x = x.to(torch.uint8)
    skip = None if col.validity is None else ~col.validity
    nan = torch.isnan(x) if x.is_floating_point() else None
    if nan is not None:
        skip = nan if skip is None else skip | nan
    if skip is not None:
        x = torch.where(skip, torch.tensor(_identity(op, x), dtype=x.dtype, device=x.device), x)
    if op == "cumsum":
        y = torch.cumsum(x, 0, dtype=x.dtype)
    elif op == "cumprod":
        y = torch.cumprod(x, 0, dtype=x.dtype)
    else:
        y = running_extreme(x, op)
    if back is not None:
        y = y ^ back
    if nan is not None:
        y = torch.where(nan, x.new_tensor(float("nan")), y)
    if out.torch_storage == torch.uint64:
        y = y.view(torch.uint64)
    else:
        y = y.to(out.torch_storage)
    return Column(out, col.length, y, col.validity)


def cumsum(col: Column) -> Column:
    return scan(col, "cumsum")


def cumprod(col: Column) -> Column:
    return scan(col, "cumprod")


def cummin(col: Column) -> Column:
    return scan(col, "cummin")


def cummax(col: Column) -> Column:
    return scan(col, "cummax")


def cumcount(col: Column) -> Column:
    """Running count of valid rows."""
    v = col.validity
    ones = torch.ones(col.length, dtype=torch.int64, device=col.device) if v is None \
        else v.long()
    return Column(dt.INT64, col.length, torch.cumsum(ones, 0))


def affine_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """y[i] = a[i] * y[i - 1] + b[i] with y[-1] = 0, by doubling: after the
    pass at distance d every (a, b) composes the 2d maps ending at it."""
    a, b = a.clone(), b.clone()
    n, d = a.shape[0], 1
    while d < n:
        a_prev, b_prev = a[:-d], b[:-d]
        b = torch.cat([b[:d], a[d:] * b_prev + b[d:]])
        a = torch.cat([a[:d], a_prev * a[d:]])
        d *= 2
    return b


def ewm_mean(col: Column, alpha: float, adjust: bool = True,
             ignore_na: bool = False) -> Column:
    """Exponentially weighted mean, pandas' semantics (the reference's
    ``ewm_mean``).  With ``adjust`` the mean is the ratio of two scans that
    decay by (1 - alpha) a row (a valid row with ``ignore_na``) and add
    weight 1 at each valid row; without it, the recurrence y <- (1 - beta)
    y + beta x at each valid row, beta taking the decay through the gap
    since the last valid row."""
    x = col.data.double()
    dev, n = col.device, col.length
    had_mask = col.validity is not None
    valid = col.validity if had_mask else torch.ones(n, dtype=torch.bool, device=dev)
    one_m = 1.0 - alpha
    seen_before = torch.zeros(n, dtype=torch.bool, device=dev)
    if n:
        seen_before[1:] = torch.cumsum(valid.int(), 0)[:-1] > 0
    xv = torch.where(valid, x, 0.0)
    if adjust:
        a = torch.full((n,), one_m, dtype=torch.float64, device=dev)
        if ignore_na:
            a = torch.where(valid, a, 1.0)
        w = valid.double()
        out = affine_scan(a, w * xv) / affine_scan(a, w)
    else:
        if ignore_na:
            beta = torch.full((n,), alpha, dtype=torch.float64, device=dev)
        else:
            pos = torch.arange(n, dtype=torch.int64, device=dev)
            last_valid = running_extreme(torch.where(valid, pos, -1), "cummax")
            prev_valid = torch.cat([last_valid.new_full((1,), -1), last_valid[:-1]])
            g = (pos - 1 - prev_valid).double()
            beta = alpha / (one_m ** (g + 1.0) + alpha)
        a = torch.where(valid, torch.where(seen_before, 1.0 - beta, 0.0), 1.0)
        b = torch.where(valid, torch.where(seen_before, beta * xv, xv), 0.0)
        out = affine_scan(a, b)
    # pandas carries the running mean through null rows; only the rows
    # before the first valid one are null
    validity = (seen_before | valid) if had_mask else None
    return Column(dt.FLOAT64, n, out, validity)
