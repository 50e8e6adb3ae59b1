"""Two-limb DECIMAL128: int128 arithmetic on (hi, lo) int64 pairs (port
of ``cudf_tpu/ops/decimal128.py``; libcudf's ``fixed_point<__int128_t>``,
fixed_point.hpp:37-38).

The value is ``hi * 2^64 + lo``, two's complement over the pair: ``hi``
carries the sign, ``lo`` is an unsigned 64-bit limb held in int64 bits
(PyTorch has no uint64 arithmetic or compare on CUDA).  Additions and
products wrap as uint64 does; a carry is an explicit unsigned compare,
made signed by flipping the top bit (a bias of 2^63).  A DECIMAL128
column holds ``data = lo`` and one child, the ``hi`` INT64 column; a
single-limb DECIMAL128 (``ops/decimal.py``) promotes by sign extension.

Products of two 64-bit limbs take four 32x32-bit partial products; a
division by a small constant (a rescale to a coarser scale) is a long
division over four 32-bit limbs.  The full 128 bits of a product are
kept; what passes 128 bits wraps, as the reference and libcudf leave it.
"""

from __future__ import annotations

import decimal as _pydec
from typing import List, Optional, Tuple

import numpy as np
import torch

from cudf_tpu_torch.core import bitmask as bm
from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.ops._utils import count_host_route

_MASK32 = 0xFFFFFFFF
_TOP = -(1 << 63)
_CTX = _pydec.Context(prec=60)          # 38-digit values never round
_COMPARE = {"eq": torch.eq, "ne": torch.ne, "lt": torch.lt, "le": torch.le,
            "gt": torch.gt, "ge": torch.ge}


def make_decimal128(hi: torch.Tensor, lo: torch.Tensor, scale: int,
                    validity: Optional[torch.Tensor] = None) -> Column:
    n = lo.shape[0]
    return Column(dt.decimal_dtype(scale, 128), n, lo.long(), validity,
                  children=(Column(dt.INT64, n, hi.long()),))


def limbs(col: Column) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) int64 limbs; a single-limb column sign-extends."""
    if col.children:
        return col.children[0].data, col.data
    rep = col.data.long()
    return torch.where(rep < 0, -1, 0), rep


def _ult(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a < b as unsigned 64-bit limbs."""
    return (a ^ _TOP) < (b ^ _TOP)


def _shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bits."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def i128_add(ah, al, bh, bl):
    lo = al + bl
    return ah + bh + _ult(lo, al).long(), lo


def i128_neg(h, l):
    nl = ~l + 1
    return ~h + (nl == 0).long(), nl


def i128_sub(ah, al, bh, bl):
    return i128_add(ah, al, *i128_neg(bh, bl))


def i128_cmp(ah, al, bh, bl) -> torch.Tensor:
    """int8 -1 / 0 / 1 (signed order)."""
    lt = (ah < bh) | ((ah == bh) & _ult(al, bl))
    gt = (ah > bh) | ((ah == bh) & _ult(bl, al))
    return lt.to(torch.int8) * -1 + gt.to(torch.int8)


def _mulu64(a: torch.Tensor, b) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of the unsigned 64x64-bit product, by 32-bit halves."""
    a0, a1 = a & _MASK32, _shr(a, 32)
    if isinstance(b, int):
        b0, b1 = b & _MASK32, b >> 32
    else:
        b0, b1 = b & _MASK32, _shr(b, 32)
    p00, p01, p10, p11 = a0 * b0, a0 * b1, a1 * b0, a1 * b1
    mid = _shr(p00, 32) + (p01 & _MASK32) + (p10 & _MASK32)
    lo = (p00 & _MASK32) | (mid << 32)
    hi = p11 + _shr(p01, 32) + _shr(p10, 32) + _shr(mid, 32)
    return hi, lo


def i128_mul(ah, al, bh, bl):
    """The low 128 bits of the product."""
    hi, lo = _mulu64(al, bl)
    return hi + al * bh + ah * bl, lo


def i128_mul_small(h, l, k: int):
    """Times a positive constant below 2^31."""
    hi, lo = _mulu64(l, k)
    return hi + h * k, lo


def i128_div_small(h, l, k: int):
    """Truncating signed division by a positive constant below 2^31."""
    neg = h < 0
    nh, nl = i128_neg(h, l)
    uh, ul = torch.where(neg, nh, h), torch.where(neg, nl, l)
    rem = torch.zeros_like(uh)
    qs = []
    for limb in (_shr(uh, 32), uh & _MASK32, _shr(ul, 32), ul & _MASK32):
        cur = (rem << 32) | limb                # rem < k < 2^31: no overflow
        qs.append(torch.div(cur, k, rounding_mode="floor"))
        rem = cur - qs[-1] * k
    qh, ql = (qs[0] << 32) | qs[1], (qs[2] << 32) | qs[3]
    oh, ol = i128_neg(qh, ql)
    return torch.where(neg, oh, qh), torch.where(neg, ol, ql)


def rescale128(col: Column, new_scale: int) -> Column:
    """The same values at another scale (``rescaled()``): a finer scale
    multiplies, a coarser one divides truncating toward zero, 10^9 at a
    step."""
    old = col.dtype.scale
    if new_scale == old:
        return col
    h, l = limbs(col)
    k = 10 ** abs(new_scale - old)
    step = i128_mul_small if new_scale < old else i128_div_small
    while k > (1 << 31) - 1:
        h, l = step(h, l, 10 ** 9)
        k //= 10 ** 9
    if k > 1:
        h, l = step(h, l, k)
    return make_decimal128(h, l, new_scale, col.validity)


def from_ints128(reps, scale: int, *, device) -> Column:
    """A two-limb column of Python ints (unscaled values; None: null)."""
    valid = [r is not None for r in reps]
    vals = [0 if r is None else int(r) for r in reps]
    lo = np.array([v & 0xFFFFFFFFFFFFFFFF for v in vals], np.uint64).view(np.int64)
    hi = np.array([v >> 64 for v in vals], np.int64)
    return make_decimal128(torch.from_numpy(hi).to(device), torch.from_numpy(lo).to(device),
                           scale, bm.from_numpy_mask(np.array(valid, bool), device))


def from_decimals128(values, scale: Optional[int] = None, *, device) -> Column:
    """A two-limb DECIMAL128 column of host Decimals (None: null), built
    on the host."""
    count_host_route("from_decimals128")
    decs = [None if v is None else _pydec.Decimal(v) for v in values]
    if scale is None:
        scale = min((int(d.as_tuple().exponent) for d in decs if d is not None), default=0)
    return from_ints128([None if d is None else int(d.scaleb(-scale, _CTX)) for d in decs],
                        scale, device=device)


def to_ints128(col: Column) -> List[Optional[int]]:
    """The unscaled values as Python ints (None: null)."""
    h, l = limbs(col)
    hi = h.cpu().tolist()
    lo = l.cpu().numpy().view(np.uint64).tolist()
    valid = [True] * col.length if col.validity is None else col.validity.cpu().tolist()
    return [(a << 64) + b if ok else None for a, b, ok in zip(hi, lo, valid)]


def to_decimals128(col: Column) -> List[Optional[_pydec.Decimal]]:
    """Host export: Python Decimals, None for nulls."""
    count_host_route("to_decimals128")
    s = col.dtype.scale
    return [None if r is None else _pydec.Decimal(r).scaleb(s, _CTX) for r in to_ints128(col)]


def binary128(lhs: Column, rhs: Column, op: str) -> Column:
    """add, sub, mul and the comparisons with libcudf's scale rules."""
    ls, rs = lhs.dtype.scale, rhs.dtype.scale
    validity = bm.and_masks(lhs.validity, rhs.validity)
    if op == "mul":
        return make_decimal128(*i128_mul(*limbs(lhs), *limbs(rhs)), ls + rs, validity)
    s = min(ls, rs)
    a, b = limbs(rescale128(lhs, s)), limbs(rescale128(rhs, s))
    if op in ("add", "sub"):
        return make_decimal128(*(i128_add if op == "add" else i128_sub)(*a, *b), s, validity)
    if op in _COMPARE:
        return Column(dt.BOOL8, lhs.length, _COMPARE[op](i128_cmp(*a, *b), 0), validity)
    raise TypeError(f"binary op {op!r} is not supported for two-limb decimals")
