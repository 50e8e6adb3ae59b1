"""Masked: the (value, valid) pair a null-aware UDF receives (port of
``cudf_tpu/utils/masked.py``).

``Series.apply(func, masked=True)`` and ``DataFrame.apply(func, axis=1,
engine="torch", masked=True)`` hand the function a ``Masked`` of tensors
inside ``torch.func.vmap``.  Arithmetic and comparisons propagate
validity as column binary operations do (the result is valid where every
Masked operand is); ``fillna`` and ``is_na`` give the UDF explicit control
of nulls, and ``where`` selects with a Masked condition whose nulls make
the result null.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Masked(NamedTuple):
    value: torch.Tensor
    valid: torch.Tensor

    # ---- null control -------------------------------------------------
    def is_na(self):
        return ~self.valid

    def fillna(self, default):
        return torch.where(self.valid, self.value, default)

    # ---- arithmetic (validity: the and of the operands') --------------
    def _bin(self, other, fn):
        if isinstance(other, Masked):
            return Masked(fn(self.value, other.value), self.valid & other.valid)
        return Masked(fn(self.value, other), self.valid)

    def _rbin(self, other, fn):
        return Masked(fn(other, self.value), self.valid)

    def __add__(self, o):
        return self._bin(o, torch.add)

    def __radd__(self, o):
        return self._rbin(o, torch.add)

    def __sub__(self, o):
        return self._bin(o, torch.sub)

    def __rsub__(self, o):
        return self._rbin(o, torch.sub)

    def __mul__(self, o):
        return self._bin(o, torch.mul)

    def __rmul__(self, o):
        return self._rbin(o, torch.mul)

    def __truediv__(self, o):
        return self._bin(o, torch.true_divide)

    def __rtruediv__(self, o):
        return self._rbin(o, torch.true_divide)

    def __pow__(self, o):
        return self._bin(o, torch.pow)

    def __mod__(self, o):
        return self._bin(o, torch.remainder)

    def __neg__(self):
        return Masked(-self.value, self.valid)

    def __abs__(self):
        return Masked(torch.abs(self.value), self.valid)

    # ---- comparisons ---------------------------------------------------
    def __eq__(self, o):  # type: ignore[override]
        return self._bin(o, torch.eq)

    def __ne__(self, o):  # type: ignore[override]
        return self._bin(o, torch.ne)

    def __lt__(self, o):
        return self._bin(o, torch.lt)

    def __le__(self, o):
        return self._bin(o, torch.le)

    def __gt__(self, o):
        return self._bin(o, torch.gt)

    def __ge__(self, o):
        return self._bin(o, torch.ge)

    def __hash__(self):  # NamedTuple equality is overridden; stay hashable
        return object.__hash__(self)


def where(cond, a, b):
    """A Masked-aware select: ``cond`` may be a Masked, whose nulls make
    the result null."""
    c = cond.value if isinstance(cond, Masked) else cond
    aval = a.value if isinstance(a, Masked) else a
    bval = b.value if isinstance(b, Masked) else b
    av = a.valid if isinstance(a, Masked) else True
    bv = b.valid if isinstance(b, Masked) else True
    out = torch.where(c, aval, bval)
    valid = torch.where(c, torch.as_tensor(av, device=out.device),
                        torch.as_tensor(bv, device=out.device))
    if isinstance(cond, Masked):
        valid = valid & cond.valid
    return Masked(out, valid)
