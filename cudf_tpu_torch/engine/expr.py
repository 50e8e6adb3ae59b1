"""Expression tree for the query engine (port of
``cudf_tpu/engine/expr.py``).

Each Expr evaluates against a ``core.Table`` and returns a Column on the
table's device.  A literal beside a column in a ``BinOp`` or a
``Ternary`` stays a host scalar, broadcast by PyTorch: only a literal
evaluated alone becomes a full column.
"""

from __future__ import annotations

from typing import Tuple

import torch

from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.core.table import Table


class Expr:
    """Base expression.  Immutable; hashable by its repr."""

    children: Tuple["Expr", ...] = ()

    def evaluate(self, table: Table) -> Column:
        raise NotImplementedError

    # named ops -----------------------------------------------------------
    def alias(self, name: str) -> "Expr":
        return Alias(self, name)

    @property
    def output_name(self) -> str:
        return getattr(self, "_name", repr(self))

    def cast(self, dtype_) -> "Expr":
        return Cast(self, dt.dtype(dtype_))

    def is_null(self) -> "Expr":
        return Unary(self, "is_null")

    def is_not_null(self) -> "Expr":
        return Unary(self, "is_not_null")

    def abs(self):
        return Unary(self, "abs")

    def floor(self):
        return Unary(self, "floor")

    def ceil(self):
        return Unary(self, "ceil")

    def round(self, decimals=0):
        return Round(self, decimals)

    def fill_null(self, value):
        return FillNull(self, value)

    def is_in(self, values):
        return IsIn(self, list(values))

    def is_between(self, lo, hi, closed="both"):
        left = self >= lo if closed in ("both", "left") else self > lo
        right = self <= hi if closed in ("both", "right") else self < hi
        return left & right

    # aggregations --------------------------------------------------------
    def sum(self):
        return Agg(self, "sum")

    def mean(self):
        return Agg(self, "mean")

    def min(self):
        return Agg(self, "min")

    def max(self):
        return Agg(self, "max")

    def count(self):
        return Agg(self, "count")

    def n_unique(self):
        return Agg(self, "nunique")

    def first(self):
        return Agg(self, "first")

    def last(self):
        return Agg(self, "last")

    def median(self):
        return Agg(self, "median")

    def std(self, ddof=1):
        return Agg(self, "std")

    def var(self, ddof=1):
        return Agg(self, "var")

    # operators -----------------------------------------------------------
    def _bin(self, other, op):
        return BinOp(self, _wrap(other), op)

    def __add__(self, o):
        return self._bin(o, "add")

    def __radd__(self, o):
        return BinOp(_wrap(o), self, "add")

    def __sub__(self, o):
        return self._bin(o, "sub")

    def __rsub__(self, o):
        return BinOp(_wrap(o), self, "sub")

    def __mul__(self, o):
        return self._bin(o, "mul")

    def __rmul__(self, o):
        return BinOp(_wrap(o), self, "mul")

    def __truediv__(self, o):
        return self._bin(o, "truediv")

    def __rtruediv__(self, o):
        return BinOp(_wrap(o), self, "truediv")

    def __floordiv__(self, o):
        return self._bin(o, "floordiv")

    def __mod__(self, o):
        return self._bin(o, "mod")

    def __pow__(self, o):
        return self._bin(o, "pow")

    def __eq__(self, o):  # type: ignore[override]
        return self._bin(o, "eq")

    def __ne__(self, o):  # type: ignore[override]
        return self._bin(o, "ne")

    def __lt__(self, o):
        return self._bin(o, "lt")

    def __gt__(self, o):
        return self._bin(o, "gt")

    def __le__(self, o):
        return self._bin(o, "le")

    def __ge__(self, o):
        return self._bin(o, "ge")

    def __and__(self, o):
        return self._bin(o, "and")

    def __or__(self, o):
        return self._bin(o, "or")

    def __invert__(self):
        return Unary(self, "not")

    def __hash__(self):
        return hash(repr(self))

    def references(self) -> set:
        """The column names this expression reads."""
        out = set()
        for ch in self.children:
            out |= ch.references()
        if isinstance(self, Col):
            out.add(self.name)
        return out


def _wrap(v) -> Expr:
    return v if isinstance(v, Expr) else Literal(v)


def _operand(e: Expr, table: Table):
    """A literal's host value, or the expression's column."""
    return e.value if isinstance(e, Literal) else e.evaluate(table)


class Col(Expr):
    def __init__(self, name: str):
        self.name = name
        self._name = name

    def evaluate(self, table: Table) -> Column:
        return table[self.name]

    def __repr__(self):
        return f"col({self.name!r})"


class Literal(Expr):
    def __init__(self, value):
        self.value = value
        self._name = "literal"

    def evaluate(self, table: Table) -> Column:
        if table.device is None:
            raise ValueError("a literal needs a table with a column to take its device from")
        return Column.full(table.num_rows, self.value, device=table.device)

    def __repr__(self):
        return f"lit({self.value!r})"


class Alias(Expr):
    def __init__(self, child: Expr, name: str):
        self.children = (child,)
        self._name = name

    def evaluate(self, table: Table) -> Column:
        return self.children[0].evaluate(table)

    def __repr__(self):
        return f"{self.children[0]!r}.alias({self._name!r})"


class BinOp(Expr):
    def __init__(self, left: Expr, right: Expr, op: str):
        self.children = (left, right)
        self.op = op
        self._name = left.output_name

    def evaluate(self, table: Table) -> Column:
        from cudf_tpu_torch.ops.binaryop import binary_operation

        l, r = self.children
        if isinstance(l, Literal) and isinstance(r, Literal):
            return binary_operation(l.evaluate(table), r.value, self.op)
        return binary_operation(_operand(l, table), _operand(r, table), self.op)

    def __repr__(self):
        return f"({self.children[0]!r} {self.op} {self.children[1]!r})"


class Unary(Expr):
    def __init__(self, child: Expr, op: str):
        self.children = (child,)
        self.op = op
        self._name = child.output_name

    def evaluate(self, table: Table) -> Column:
        from cudf_tpu_torch.ops import unary
        from cudf_tpu_torch.ops._utils import materialize_validity

        v = self.children[0].evaluate(table)
        if self.op in ("is_null", "is_not_null"):
            # a NaN counts as null, as polars' is_null on pandas data
            data = ~materialize_validity(v)
            if v.dtype.is_float:
                data = data | torch.isnan(v.data)
            return Column(dt.BOOL8, v.length, ~data if self.op == "is_not_null" else data)
        return unary.unary_operation(v, self.op)

    def __repr__(self):
        return f"{self.op}({self.children[0]!r})"


class Cast(Expr):
    def __init__(self, child: Expr, dtype_: dt.DType):
        self.children = (child,)
        self.dtype = dtype_
        self._name = child.output_name

    def evaluate(self, table: Table) -> Column:
        from cudf_tpu_torch.ops.unary import cast

        return cast(self.children[0].evaluate(table), self.dtype)

    def __repr__(self):
        return f"cast({self.children[0]!r}, {self.dtype!r})"


class Round(Expr):
    def __init__(self, child: Expr, decimals: int):
        self.children = (child,)
        self.decimals = decimals
        self._name = child.output_name

    def evaluate(self, table: Table) -> Column:
        from cudf_tpu_torch.ops.unary import round as _round

        return _round(self.children[0].evaluate(table), self.decimals)

    def __repr__(self):
        return f"round({self.children[0]!r}, {self.decimals})"


class FillNull(Expr):
    def __init__(self, child: Expr, value):
        self.children = (child,)
        self.value = value
        self._name = child.output_name

    def evaluate(self, table: Table) -> Column:
        from cudf_tpu_torch.ops.replace import replace_nulls_scalar

        return replace_nulls_scalar(self.children[0].evaluate(table), self.value)

    def __repr__(self):
        return f"fill_null({self.children[0]!r}, {self.value!r})"


class IsIn(Expr):
    """Membership in a host list.  Over a dictionary column it is decided
    once per dictionary entry on the host, then by code on the device
    (one equality a matching code, up to 16; else a gather from a table
    of K booleans): no row is decoded."""

    def __init__(self, child: Expr, values: list):
        self.children = (child,)
        self.values = values
        self._name = child.output_name

    def evaluate(self, table: Table) -> Column:
        from cudf_tpu_torch.ops.search import is_in_list

        v = self.children[0].evaluate(table)
        return Column(dt.BOOL8, v.length, is_in_list(v, self.values))

    def __repr__(self):
        return f"{self.children[0]!r}.is_in({self.values!r})"


class Agg(Expr):
    """Aggregation marker: GroupBy reads it; alone (a Reduce node) it is
    a whole-column reduction from ``ops/reductions.py``, by its name."""

    def __init__(self, child: Expr, agg: str):
        self.children = (child,)
        self.agg = agg
        self._name = child.output_name

    def evaluate(self, table: Table) -> Column:
        from cudf_tpu_torch.ops import reductions

        v = self.children[0].evaluate(table)
        fn = getattr(reductions, self.agg, None)
        if fn is None:
            raise NotImplementedError(f"whole-table {self.agg!r}: ops/reductions.py has no "
                                      "such reduction, nor has the reference's (ROADMAP.md, "
                                      "beyond the reference)")
        return Column.full(1, fn(v), device=v.device)

    def __repr__(self):
        return f"{self.children[0]!r}.{self.agg}()"

    def over(self, *keys) -> "Over":
        flat = []
        for k in keys:
            flat.extend(k if isinstance(k, (list, tuple)) else [k])
        return Over(self, [k if isinstance(k, str) else k.output_name for k in flat])


class Over(Expr):
    """``agg().over(keys)``: a per-row windowed aggregate (SQL ``agg()
    OVER (PARTITION BY keys)``): the aggregate of each partition, the
    null-key partition included, gathered back to every member row by
    its group id."""

    def __init__(self, agg: Agg, keys):
        self.children = (agg,)
        self.keys = list(keys)
        self._name = agg.output_name

    def evaluate(self, table: Table) -> Column:
        from cudf_tpu_torch.ops import copying
        from cudf_tpu_torch.ops import groupby as gb

        agg = self.children[0]
        value = agg.children[0].evaluate(table)
        grouper = gb.make_grouper([table[k] for k in self.keys], dropna=False)
        per_group = gb.aggregate(value, grouper, agg.agg)
        return copying.gather(per_group, grouper.group_ids, bounds_check=False)

    def references(self):
        return self.children[0].references() | set(self.keys)

    def __repr__(self):
        return f"{self.children[0]!r}.over({self.keys})"


class Ternary(Expr):
    """when(cond).then(a).otherwise(b); a null condition takes b."""

    def __init__(self, cond: Expr, then: Expr, otherwise: Expr):
        self.children = (cond, then, otherwise)
        self._name = then.output_name

    def evaluate(self, table: Table) -> Column:
        from cudf_tpu_torch.ops.copying import copy_if_else

        c = self.children[0].evaluate(table)
        m = c.data.to(torch.bool)
        if c.validity is not None:
            m = m & c.validity
        return copy_if_else(m, *(_operand(e, table) for e in self.children[1:]))

    def __repr__(self):
        return (f"when({self.children[0]!r}).then({self.children[1]!r})"
                f".otherwise({self.children[2]!r})")


class _When:
    def __init__(self, cond: Expr):
        self._cond = cond

    def then(self, value) -> "_Then":
        return _Then(self._cond, _wrap(value))


class _Then:
    def __init__(self, cond: Expr, then: Expr):
        self._cond = cond
        self._then = then

    def otherwise(self, value) -> Ternary:
        return Ternary(self._cond, self._then, _wrap(value))


def when(cond: Expr) -> _When:
    return _When(cond)


def col(name: str) -> Col:
    return Col(name)


def lit(value) -> Literal:
    return Literal(value)
