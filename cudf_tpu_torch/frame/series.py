"""Series (port of ``cudf_tpu/frame/series.py``): one column and its
index, with pandas' column API.

- ``Series(data, index, dtype, name, *, device)`` is pandas' constructor.
  A tensor, Column or Series stays on its device; host data (lists,
  numpy arrays, scalars, dicts) needs an explicit ``device``.
  ``Series._from(column, index, name)`` wraps parts without a copy.
- Operators align the two indexes by label first (``_align``): one
  index object, or two views of one range, costs nothing; other
  indexes are compared once, and differing ones meet over the sorted
  union of their labels, missing labels null.  Comparisons follow
  pandas' numpy-dtype rule: a missing value compares False (True for
  ``!=``); nullable dtypes keep null.
- Reductions return a host scalar through one sync; NaT for temporal
  columns and the port's own ``NA`` (``utils/missing.py``) for nullable
  ones where pandas gives pd.NA.  pandas is imported only by
  ``to_pandas``.
- ``__setitem__`` never writes into a buffer: it rebinds the Series to a
  new column, so a Series and any other holder of the old column never
  see each other's writes.

Its index may be a MultiIndex, as a multi-key groupby's ``size()`` gives.
``groupby`` gives a SeriesGroupBy (``frame/groupby.py``); ``corr``,
``cov`` and ``autocorr`` take two passes over the pairwise-complete rows;
``agg``, ``transform``, ``pipe`` and ``describe`` are pandas'.
``map`` of a dict or Series is a sorted search on the device; ``apply``
runs the UDF under ``torch.func.vmap`` (``masked=True`` hands it a
``utils/masked.py`` ``Masked``), and ``map`` of a callable, or a UDF vmap
cannot trace, loops on the host, as the reference's does; ``UDF_ROUTES``
counts each route.  ``interpolate`` (linear), ``combine_first`` and
``update`` are pandas'.  The ``str``, ``dt`` and ``cat`` accessors are
``frame/accessors.py``'s, and so are ``list`` and ``struct`` of LIST and
STRUCT Series; ``explode`` unnests a LIST Series.  ``rolling``, ``ewm``
and ``resample`` are ``frame/window.py``'s and ``frame/resample.py``'s,
``hash_values`` ``ops/hashing.py``'s.
"""

from __future__ import annotations

import numbers
from typing import Optional

import numpy as np
import torch

from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import Column, holds, is_null_scalar
from cudf_tpu_torch.frame.index import (Index, MultiIndex, as_index, default_index,
                                         label_column)
from cudf_tpu_torch.ops import binaryop, copying, reductions
from cudf_tpu_torch.ops import replace as replace_ops
from cudf_tpu_torch.ops import scan as scan_ops
from cudf_tpu_torch.ops import sort as sort_ops
from cudf_tpu_torch.ops import stream_compaction as sc
from cudf_tpu_torch.ops import unary
from cudf_tpu_torch.ops._utils import materialize_validity, maybe_mask
from cudf_tpu_torch.ops.replace import nans_to_nulls
from cudf_tpu_torch.utils.missing import NA

_BINOPS = {
    "__add__": "add", "__sub__": "sub", "__mul__": "mul",
    "__truediv__": "truediv", "__floordiv__": "floordiv", "__mod__": "mod",
    "__pow__": "pow",
    "__eq__": "eq", "__ne__": "ne", "__lt__": "lt", "__gt__": "gt",
    "__le__": "le", "__ge__": "ge",
    "__and__": "bitand", "__or__": "bitor", "__xor__": "bitxor",
}
_RBINOPS = {
    "__radd__": "add", "__rsub__": "sub", "__rmul__": "mul",
    "__rtruediv__": "truediv", "__rfloordiv__": "floordiv", "__rmod__": "mod",
    "__rpow__": "pow", "__rand__": "bitand", "__ror__": "bitor", "__rxor__": "bitxor",
}
_COMPARISONS = ("eq", "ne", "lt", "gt", "le", "ge")

# pandas methods the port does not have yet, and the ROADMAP.md item
# that brings each
_DESCRIBE = ("count", "mean", "std", "min", "25%", "50%", "75%", "max")
# what the reference package lacks too: ROADMAP.md's line for it
BEYOND = "ROADMAP.md, beyond the reference"
# how many UDFs took each route: "vmap" (torch.func.vmap on the column's
# device) or "host" (a Python loop over the values)
UDF_ROUTES = {"vmap": 0, "host": 0}


def where_ported(item) -> str:
    """The ROADMAP.md place of something not ported: a queue 1 item
    number, or a line's text."""
    return f"ROADMAP.md queue 1, item {item}" if isinstance(item, int) else item


def not_ported(name: str, item):
    def method(self, *args, **kwargs):
        raise NotImplementedError(f"{type(self).__name__}.{name}: {where_ported(item)}")
    method.__name__ = name
    return method


def _vmap_error(err: Exception) -> bool:
    """torch.func.vmap's own refusal (data-dependent control flow, .item(),
    a result that is not a tensor), which sends a UDF to the host; any
    other error is the UDF's and propagates."""
    return str(err).startswith("vmap")


def vmap_udf(func, arg, device):
    """func vmapped over arg's first dimension (a tensor, a Masked, or a
    dict of them) on ``device``: Python floats promote integers to float64
    as in numpy and pandas, and a Python number the UDF returns becomes a
    tensor.  None when vmap cannot trace the UDF (the host route)."""
    from torch.func import vmap

    from cudf_tpu_torch.utils.masked import Masked

    def one(x):
        out = func(x)
        if isinstance(out, (torch.Tensor, Masked)):
            return out
        if isinstance(out, (bool, int, float, np.number, np.bool_)):
            return torch.as_tensor(out, device=device)
        raise ValueError(f"vmap: the UDF returned a {type(out).__name__}")

    default = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        return vmap(one)(arg)
    except (RuntimeError, ValueError, TypeError) as err:
        if not _vmap_error(err):
            raise
        return None
    finally:
        torch.set_default_dtype(default)


def udf_column(out, n: int, validity=None) -> Column:
    """A vmapped UDF's result as a column: a Masked gives its validity, a
    tensor keeps ``validity`` (the input's nulls)."""
    from cudf_tpu_torch.utils.masked import Masked

    if isinstance(out, Masked):
        return Column(dt.from_torch(out.value.dtype), n, out.value.reshape(n).contiguous(),
                      maybe_mask(out.valid.reshape(n)))
    return Column(dt.from_torch(out.dtype), n, out.reshape(n).contiguous(), validity)


def _is_listlike(x) -> bool:
    return isinstance(x, (list, tuple, np.ndarray, torch.Tensor))


def column_of(data, device=None, dtype=None) -> Column:
    """A column from a tensor (kept on its device), a Column, or host data
    (a list, tuple or numpy array), which needs ``device``."""
    if isinstance(data, Series):
        col = data._column
    elif isinstance(data, Column):
        col = data
    elif isinstance(data, torch.Tensor):
        col = Column.from_tensor(data.reshape(-1))
    elif isinstance(data, (list, tuple, np.ndarray)):
        if device is None:
            raise ValueError("host data needs an explicit device=")
        if isinstance(data, np.ndarray):
            col = Column.from_numpy(data, device=device)
        else:
            target = dt.dtype(dtype) if dtype is not None and not _is_category(dtype) else None
            col = Column.from_pylist(list(data), target, device=device)
    elif type(data).__name__ in ("Series", "Categorical") and hasattr(data, "dtype"):
        if device is None:
            raise ValueError("host data needs an explicit device=")
        import pandas as pd

        col = Column.from_pandas(pd.Series(data), device=device)
    else:
        raise TypeError(f"cannot build a column from {type(data).__name__}")
    if device is not None and not _on(col.device, torch.device(device)):
        raise ValueError(f"data is on {col.device}, asked for {device}")
    if dtype is not None:
        col = unary.cast(col, dt.dtype(dtype))
    return col


def _is_category(dtype) -> bool:
    return isinstance(dtype, str) and dtype == "category" or (
        isinstance(dtype, dt.DType) and dtype.is_dictionary)


def _on(have: torch.device, want: torch.device) -> bool:
    """Whether a tensor on ``have`` is on ``want`` ("cuda" names the
    current card, as torch.device("cuda") does)."""
    if have.type != want.type:
        return False
    index = want.index if want.index is not None or want.type != "cuda" \
        else torch.cuda.current_device()
    return have.index == index


def _clone(col: Column) -> Column:
    def copy(t):
        return None if t is None else t.clone()
    return Column(col.dtype, col.length, copy(col.data), copy(col.validity), copy(col.offsets),
                  col.children)


class Series:
    def __init__(self, data=None, index=None, dtype=None, name=None, *, device=None):
        if isinstance(index, (list, tuple, np.ndarray)) and device is None \
                and isinstance(data, (torch.Tensor, Column, Series)):
            device = data.device
        if index is not None:
            index = as_index(index, device)
            if device is None and index.device is not None:
                device = index.device
        if isinstance(data, Series):
            col = data._column if dtype is None else unary.cast(data._column, dt.dtype(dtype))
            index = index if index is not None else data._index
            name = name if name is not None else data.name
        elif isinstance(data, dict):
            index = as_index(list(data.keys()), device) if index is None else index
            col = column_of(list(data.values()), device, dtype)
        elif data is None or np.isscalar(data) or is_null_scalar(data):
            if device is None:
                raise ValueError("a scalar Series needs an explicit device=")
            n = len(index) if index is not None else (0 if data is None else 1)
            col = Column.full(n, data, dt.dtype(dtype) if dtype is not None else (
                dt.FLOAT64 if data is None else None), device=device)
        else:
            col = column_of(data, device, dtype)
            if type(data).__name__ == "Series" and hasattr(data, "index"):
                # a pandas Series keeps its labels and name, as in pandas
                index = as_index(data.index, device) if index is None else index
                name = data.name if name is None else name
        self._column = col
        self._index = index if index is not None else default_index(col.length)
        if len(self._index) != col.length:
            raise ValueError("index length mismatch")
        self.name = name

    @classmethod
    def _from(cls, column: Column, index: Index, name=None) -> "Series":
        s = cls.__new__(cls)
        s._column = column
        s._index = index
        s.name = name
        return s

    def _new(self, column: Column, index: Optional[Index] = None) -> "Series":
        return Series._from(column, self._index if index is None else index, self.name)

    @property
    def str(self):
        from cudf_tpu_torch.frame.accessors import StringMethods

        return StringMethods(self)

    @property
    def dt(self):
        from cudf_tpu_torch.frame.accessors import DatetimeProperties

        return DatetimeProperties(self)

    @property
    def cat(self):
        from cudf_tpu_torch.frame.accessors import CategoricalAccessor

        return CategoricalAccessor(self)

    @property
    def list(self):
        from cudf_tpu_torch.frame.accessors import ListMethods

        return ListMethods(self)

    @property
    def struct(self):
        from cudf_tpu_torch.frame.accessors import StructMethods

        return StructMethods(self)

    def explode(self, ignore_index: bool = False) -> "Series":
        """One row an element of a LIST Series, an empty or null list one
        null row, each under its row's label (``ops/lists.py``
        ``explode(outer=True)``); any other Series as it is."""
        if not self.dtype.is_list:
            return self.copy(deep=False)
        from cudf_tpu_torch.ops import lists

        child, rows = lists.explode(self._column, outer=True)
        index = default_index(child.length) if ignore_index else self._index.take(rows)
        return Series._from(child, index, self.name)

    def to_arrow(self):
        return self._column.to_arrow()

    def __arrow_c_array__(self, requested_schema=None):
        from cudf_tpu_torch import arrow_cdata

        return arrow_cdata.column_capsules(
            self._column, name=str(self.name) if self.name is not None else "",
            requested_schema=requested_schema)

    def to_csv(self, path=None, **kw):
        """pandas' ``to_csv`` of the Series (a counted host route, as the
        frame's ``to_csv``)."""
        from cudf_tpu_torch.io.csv import write_csv

        return write_csv(self, path, **kw)

    def to_json(self, path=None, orient="records", lines=False, **kw):
        """The Series' JSON text: the records orient of one unnamed value
        a record is pandas' list of values (``[1,2]``), written by the
        frame's writer on the device; other orients pandas'."""
        from cudf_tpu_torch.io.json import write_series_json

        return write_series_json(self, path, orient=orient, lines=lines, **kw)

    # ------------------------------------------------------------------
    # attributes
    # ------------------------------------------------------------------
    @property
    def index(self) -> Index:
        return self._index

    @index.setter
    def index(self, value):
        idx = as_index(value, self.device)
        if len(idx) != len(self):
            raise ValueError("length mismatch")
        self._index = idx

    @property
    def device(self) -> torch.device:
        return self._column.device

    @property
    def dtype(self) -> dt.DType:
        return self._column.dtype

    @property
    def shape(self):
        return (len(self),)

    @property
    def size(self) -> int:
        return len(self)

    @property
    def ndim(self) -> int:
        return 1

    @property
    def empty(self) -> bool:
        return len(self) == 0

    @property
    def values(self) -> np.ndarray:
        return self._column.to_numpy()

    @property
    def hasnans(self) -> bool:
        return self._has_nulls_or_nans()

    @property
    def nbytes(self) -> int:
        col = self._column
        return sum(t.numel() * t.element_size() for t in (col.data, col.validity, col.offsets)
                   if t is not None)

    def __len__(self) -> int:
        return self._column.length

    def __iter__(self):
        return iter(self.tolist())

    def __array__(self, dtype=None, copy=None):
        arr = self._column.to_numpy()
        return arr.astype(dtype) if dtype is not None else arr

    def __bool__(self):
        raise ValueError("The truth value of a Series is ambiguous.")

    def copy(self, deep: bool = True) -> "Series":
        return self._new(_clone(self._column) if deep else self._column, self._index.copy())

    def rename(self, name=None) -> "Series":
        """A new name, or with a dict or callable new index labels (each
        label mapped on the host, a label a dict lacks kept)."""
        if callable(name) or isinstance(name, dict):
            return Series._from(self._column, relabel(self._index, name, self.device),
                                self.name)
        return Series._from(self._column, self._index, name)

    def to_numpy(self) -> np.ndarray:
        return self._column.to_numpy()

    def tolist(self) -> list:
        return self._column.to_numpy().tolist()

    to_list = tolist
    to_pylist = tolist

    def to_frame(self, name=None):
        from cudf_tpu_torch.core.table import Table
        from cudf_tpu_torch.frame.dataframe import DataFrame

        nm = name if name is not None else (self.name if self.name is not None else 0)
        return DataFrame._from(Table({nm: self._column}), self._index)

    def to_pandas(self):
        import pandas as pd

        return pd.Series(self._column.to_pandas_array(), index=self._index.to_pandas(),
                         name=self.name)

    def __repr__(self) -> str:
        return f"Series({self.name!r}, {self._column!r})"

    # ------------------------------------------------------------------
    # operators
    # ------------------------------------------------------------------
    def _operand(self, other):
        """other as a Series aligned to self, or a host scalar."""
        if isinstance(other, Series):
            return other
        if isinstance(other, Column) or _is_listlike(other):
            return Series._from(column_of(other, self.device), self._index)
        return other

    def _binop(self, other, op: str, reflect: bool = False) -> "Series":
        other = self._operand(other)
        if isinstance(other, Series):
            lhs, rhs, index = _align(self, other)
        else:
            lhs, rhs, index = self._column, other, self._index
        if reflect:
            lhs, rhs = rhs, lhs
        out = binaryop.binary_operation(lhs, rhs, op)
        if op in _COMPARISONS and out.validity is not None:
            # pandas' numpy dtypes: a missing value compares False (True
            # for !=); nullable dtypes keep null
            nullable = self.dtype.nullable or (isinstance(other, Series)
                                               and other.dtype.nullable)
            if not nullable:
                out = Column(dt.BOOL8, out.length,
                             torch.where(out.validity, out.data, op == "ne"))
        name = self.name if not isinstance(other, Series) or other.name == self.name else None
        return Series._from(out, index, name)

    def __invert__(self) -> "Series":
        return self._new(unary.unary_operation(self._column,
                                               "not" if self.dtype.is_bool else "bit_invert"))

    def __neg__(self) -> "Series":
        return self._new(unary.unary_operation(self._column, "negate"))

    def __abs__(self) -> "Series":
        return self.abs()

    def abs(self) -> "Series":
        return self._new(unary.unary_operation(self._column, "abs"))

    def _fill_binop(self, other, op: str, fill_value, reflect: bool = False) -> "Series":
        """pandas' flex arithmetic: align first, then fill_value stands for
        a value missing on one side (missing on both stays missing)."""
        if fill_value is None:
            return self._binop(other, op, reflect)
        other = self._operand(other)
        if not isinstance(other, Series):
            return self.fillna(fill_value)._binop(other, op, reflect)
        lhs, rhs, index = _align(self, other)
        both_missing = None
        if lhs.validity is not None and rhs.validity is not None:
            both_missing = ~(lhs.validity | rhs.validity)
        a = Series._from(lhs, index, self.name).fillna(fill_value)
        b = Series._from(rhs, index, other.name).fillna(fill_value)
        out = a._binop(b, op, reflect)
        if both_missing is not None:
            col = out._column
            out = Series._from(col.with_validity(materialize_validity(col) & ~both_missing),
                               index, out.name)
        return out

    # ------------------------------------------------------------------
    # indexing
    # ------------------------------------------------------------------
    @property
    def iloc(self):
        return _SeriesILoc(self)

    @property
    def loc(self):
        return _SeriesLoc(self)

    @property
    def at(self):
        return self.loc

    @property
    def iat(self):
        return self.iloc

    def __getitem__(self, key):
        if isinstance(key, slice):
            return self.iloc[key]
        if isinstance(key, Series) and key.dtype.is_bool:
            return self._filter(key)
        if _is_listlike(key) and _bool_array(key):
            return self._filter(Series._from(column_of(key, self.device), self._index))
        return self.loc[key]

    def __setitem__(self, key, value):
        check_setitem_compat(self.dtype, value)
        if _is_listlike(key) and not isinstance(key, Series) and _bool_array(key):
            key = Series._from(column_of(key, self.device), self._index)
        if isinstance(key, Series) and key.dtype.is_bool:
            mask = self._aligned_mask(key)
            if _scalar(value):
                self._column = replace_ops.replace_where(self._column, mask, value)
            elif isinstance(value, Series) and len(value) == len(self):
                _, vcol, _ = _align(self, value)
                self._column = copying.copy_if_else(mask, vcol, self._column)
            else:
                vals = column_of(value, self.device)
                sel = sc.filter_indices(mask)
                if vals.length != sel.shape[0]:
                    raise ValueError("cannot set using a list-like indexer with a different "
                                     "length than the value")
                self._column = copying.scatter(vals, sel, self._column)
            return
        if isinstance(key, slice):
            start, stop, step = key.indices(len(self))
            idx = torch.arange(start, stop, step, device=self.device)
        else:
            pos = self._index.get_indexer_for([key] if np.isscalar(key) else key, self.device)
            idx = pos[pos >= 0]
        self._set_positions(idx, value)

    def _set_positions(self, idx: torch.Tensor, value):
        if _scalar(value):
            self._column = copying.scatter_scalar(value, idx, self._column)
        else:
            self._column = copying.scatter(column_of(value, self.device), idx, self._column)

    def _aligned_mask(self, mask: "Series") -> torch.Tensor:
        return aligned_mask(self._index, self.device, mask)

    def _filter(self, mask: "Series") -> "Series":
        return self.take(sc.filter_indices(self._aligned_mask(mask)))

    def take(self, indices) -> "Series":
        """The rows at these positions, with their index labels."""
        idx = torch.as_tensor(indices, device=self.device).long().reshape(-1)
        return self._new(copying.gather(self._column, idx, bounds_check=False),
                         self._index.take(idx))

    def head(self, n: int = 5) -> "Series":
        return self.iloc[:n]

    def tail(self, n: int = 5) -> "Series":
        if n == 0:
            return self.iloc[0:0]
        return self.iloc[-n:] if n > 0 else self.iloc[-n:]

    def reset_index(self, drop: bool = False, name=None):
        if drop:
            return self._new(self._column, default_index(len(self)))
        nm = name if name is not None else (self.name if self.name is not None else 0)
        return self.to_frame(nm).reset_index()

    def set_axis(self, labels, axis=0) -> "Series":
        idx = as_index(labels, self.device)
        if len(idx) != len(self):
            raise ValueError("length mismatch")
        return self._new(self._column, idx)

    # ------------------------------------------------------------------
    # missing data
    # ------------------------------------------------------------------
    def isna(self) -> "Series":
        missing = ~materialize_validity(self._column)
        if self.dtype.is_float:
            missing = missing | torch.isnan(self._column.data)
        return self._new(Column(dt.BOOL8, len(self), missing))

    isnull = isna

    def notna(self) -> "Series":
        return self._new(Column(dt.BOOL8, len(self), ~self.isna()._column.data))

    notnull = notna

    def _nan_null(self) -> Column:
        return nans_to_nulls(self._column) if self.dtype.is_float else self._column

    def fillna(self, value=None, method=None, limit=None) -> "Series":
        if method is not None:
            return self.ffill(limit) if method in ("ffill", "pad") else self.bfill(limit)
        col = self._nan_null()
        if isinstance(value, Series):
            lhs, rhs, index = _align(self._new(col), value)
            return self._new(replace_ops.replace_nulls_column(lhs, rhs), index)
        return self._new(replace_ops.replace_nulls_scalar(col, value))

    def ffill(self, limit=None) -> "Series":
        return self._new(replace_ops.ffill(self._nan_null(), limit))

    pad = ffill

    def bfill(self, limit=None) -> "Series":
        return self._new(replace_ops.bfill(self._nan_null(), limit))

    backfill = bfill

    def dropna(self) -> "Series":
        col = self._nan_null()
        if col.validity is None:
            return self.copy(deep=False)
        return self.take(sc.filter_indices(col.validity))

    def first_valid_index(self):
        v = self._nan_null().validity
        if v is None:
            return self._index[0] if len(self) else None
        pos = sc.filter_indices(v)
        return self._index[int(pos[0])] if pos.shape[0] else None

    def last_valid_index(self):
        v = self._nan_null().validity
        if v is None:
            return self._index[len(self) - 1] if len(self) else None
        pos = sc.filter_indices(v)
        return self._index[int(pos[-1])] if pos.shape[0] else None

    # ------------------------------------------------------------------
    # reductions: a host scalar through one sync each
    # ------------------------------------------------------------------
    def _has_nulls_or_nans(self) -> bool:
        col = self._column
        missing = ~materialize_validity(col)
        if col.dtype.is_float:
            missing = missing | torch.isnan(col.data)
        return bool(missing.any())

    def _reduce_scalar(self, value, skipna: bool = True):
        """pandas' scalar conventions: NaT for temporal columns, NA for
        nullable ones, NaN otherwise where nothing was left to reduce."""
        if not skipna and self._has_nulls_or_nans():
            value = None
        if value is None or (isinstance(value, float) and np.isnan(value)):
            if self.dtype.is_timestamp:
                return np.datetime64("NaT")
            if self.dtype.is_duration:
                return np.timedelta64("NaT")
            return NA if self.dtype.nullable else float("nan")
        return value

    def _ticks(self) -> Column:
        """A temporal column's ticks as an INT64 column."""
        col = self._column
        return Column(dt.INT64, col.length, col.data, col.validity)

    def _temporal(self, ticks, duration: bool = False, skipna: bool = True):
        """A temporal reduction's ticks (float or int, truncated toward
        zero) as pandas gives it: a timestamp in the column's unit (a
        tz-aware one as a ``datetime`` in its zone, to the microsecond), a
        duration for ``duration``; NaT where nothing was reduced."""
        if ticks is None or (isinstance(ticks, float) and np.isnan(ticks)) or (
                not skipna and self._has_nulls_or_nans()):
            return np.timedelta64("NaT") if duration else self._reduce_scalar(None)
        unit = self.dtype.time_unit
        if duration:
            return np.timedelta64(int(ticks), unit)
        value = np.datetime64(int(ticks), unit)
        if self.dtype.tz is None:
            return value
        import datetime as _datetime
        import zoneinfo

        utc = value.astype("datetime64[us]").item().replace(tzinfo=_datetime.timezone.utc)
        return utc.astimezone(zoneinfo.ZoneInfo(self.dtype.tz))

    def sum(self, skipna: bool = True, min_count: int = 0):
        if self.dtype.is_timestamp:
            raise TypeError(f"a {self.dtype!r} column does not sum")
        if self.dtype.is_duration:
            return self._temporal(reductions.sum(self._ticks(), min_count), True, skipna)
        return self._reduce_scalar(reductions.sum(self._column, min_count), skipna)

    def prod(self, skipna: bool = True, min_count: int = 0):
        return self._reduce_scalar(reductions.product(self._column, min_count), skipna)

    product = prod

    def mean(self, skipna: bool = True):
        if self.dtype.is_temporal:
            return self._temporal(reductions.mean(self._ticks()), self.dtype.is_duration, skipna)
        return self._reduce_scalar(reductions.mean(self._column), skipna)

    def min(self, skipna: bool = True):
        if self.dtype.is_temporal:
            return self._temporal(reductions.min(self._ticks()), self.dtype.is_duration, skipna)
        return self._reduce_scalar(reductions.min(self._column), skipna)

    def max(self, skipna: bool = True):
        if self.dtype.is_temporal:
            return self._temporal(reductions.max(self._ticks()), self.dtype.is_duration, skipna)
        return self._reduce_scalar(reductions.max(self._column), skipna)

    def var(self, ddof: int = 1, skipna: bool = True):
        return self._reduce_scalar(reductions.var(self._column, ddof), skipna)

    def std(self, ddof: int = 1, skipna: bool = True):
        if self.dtype.is_temporal:
            return self._temporal(reductions.std(self._ticks(), ddof), True, skipna)
        return self._reduce_scalar(reductions.std(self._column, ddof), skipna)

    def median(self, skipna: bool = True):
        if self.dtype.is_temporal:
            return self._temporal(reductions.median(self._ticks()), self.dtype.is_duration,
                                  skipna)
        return self._reduce_scalar(reductions.median(self._column), skipna)

    def sem(self, ddof: int = 1):
        n = self.count()
        return float(np.sqrt(reductions.var(self._column, ddof) / n)) if n > ddof \
            else float("nan")

    def skew(self):
        return reductions.skew(self._column)

    def kurtosis(self):
        return reductions.kurtosis(self._column)

    kurt = kurtosis

    def any(self, skipna: bool = True):
        return reductions.any(self._column)

    def all(self, skipna: bool = True):
        return reductions.all(self._column)

    def count(self) -> int:
        return reductions.count(self._column)

    def nunique(self, dropna: bool = True) -> int:
        return reductions.nunique(self._column, dropna)

    def quantile(self, q=0.5, interpolation: str = "linear"):
        col = self._column
        temporal = col.dtype.is_temporal
        if temporal:
            col = Column(dt.INT64, col.length, col.data, col.validity)
        out = reductions.quantile(col, q, interpolation)

        def fix(v):
            if not temporal:
                return self._reduce_scalar(v)
            if np.isnan(v):
                return self._reduce_scalar(None)
            return np.array(int(round(v)), np.int64).view(self.dtype.to_numpy())[()]

        if np.isscalar(q):
            return fix(out)
        vals = [fix(v) for v in np.atleast_1d(out).tolist()]
        return Series(vals, index=[float(x) for x in np.atleast_1d(q)], name=self.name,
                      device=self.device)

    def idxmin(self):
        return self._index[reductions.argmin(self._column)]

    def idxmax(self):
        return self._index[reductions.argmax(self._column)]

    def argmin(self) -> int:
        return reductions.argmin(self._column)

    def argmax(self) -> int:
        return reductions.argmax(self._column)

    def mode(self, dropna: bool = True) -> "Series":
        """The most frequent values, ascending."""
        vc = self.value_counts(dropna=dropna, sort=False)
        top = vc[vc == vc.max()]
        return Series._from(sort_ops.sort(top._index.column(self.device)),
                            default_index(len(top)), self.name)

    def _pair(self, other: "Series"):
        """(x, y, the rows where both are present) as float64, aligned by
        label; NaN is missing."""
        a, b, _ = _align(self, other)
        for c in (a, b):
            if not (c.dtype.is_numeric or c.dtype.is_bool):
                raise TypeError(f"corr/cov of a {c.dtype!r} column")
        x, y = unary.cast(a, dt.FLOAT64).data, unary.cast(b, dt.FLOAT64).data
        ok = materialize_validity(a) & materialize_validity(b) & ~torch.isnan(x) \
            & ~torch.isnan(y)
        return torch.where(ok, x, 0.0), torch.where(ok, y, 0.0), ok

    def _centred_pair(self, other: "Series"):
        """(x less its mean, y less its mean, count): the first of two
        passes over the pairwise-complete rows."""
        x, y, ok = self._pair(other)
        n = ok.sum()
        mx, my = x.sum() / n.clamp(min=1), y.sum() / n.clamp(min=1)
        return torch.where(ok, x - mx, 0.0), torch.where(ok, y - my, 0.0), n

    def corr(self, other: "Series", method: str = "pearson", min_periods=None) -> float:
        """Pearson correlation over the rows where both are present; NaN
        with fewer than two (or ``min_periods``) or a constant side."""
        if method != "pearson":
            raise NotImplementedError(f"Series.corr(method={method!r}): pearson only")
        dx, dy, n = self._centred_pair(other)
        sxy, sxx, syy, cnt = torch.stack([(dx * dy).sum(), (dx * dx).sum(), (dy * dy).sum(),
                                          n.double()]).tolist()
        den = float(np.sqrt(sxx * syy))
        if cnt < max(2, min_periods or 1) or den == 0.0:
            return float("nan")
        return sxy / den

    def cov(self, other: "Series", min_periods=None, ddof: int = 1) -> float:
        """Covariance over the rows where both are present, over count -
        ddof; NaN where that is below 1 (or fewer than ``min_periods``)."""
        dx, dy, n = self._centred_pair(other)
        sxy, cnt = torch.stack([(dx * dy).sum(), n.double()]).tolist()
        if cnt - ddof < 1 or cnt < (min_periods or 0):
            return float("nan")
        return sxy / (cnt - ddof)

    def autocorr(self, lag: int = 1) -> float:
        return self.corr(self.shift(lag))

    def describe(self) -> "Series":
        """pandas' count, mean, std, min, quartiles and max of a numeric
        column, float64; of a string, dictionary or bool column its count,
        unique, top and freq, as text (the reference's values: the port
        has no column of mixed types)."""
        if self.dtype.is_temporal:
            raise NotImplementedError(f"describe of a temporal column: {BEYOND}")
        if not self.dtype.is_numeric:
            vc = self.value_counts()
            top, freq = (vc._index[0], int(vc.iloc[0])) if len(vc) else (None, None)
            vals = [self.count(), self.nunique(), top, freq]
            return Series([None if v is None else str(v) for v in vals],
                          index=["count", "unique", "top", "freq"], name=self.name,
                          dtype="str", device=self.device)
        vals = [float(self.count()), self.mean(), self.std(), self.min(),
                *[self.quantile(q) for q in (0.25, 0.5, 0.75)], self.max()]
        return Series([float(v) for v in vals], index=list(_DESCRIBE), name=self.name,
                      device=self.device)

    def agg(self, func, *args, **kwargs):
        """A name (a scalar, or the method's Series), a list of names (a
        Series over them) or a callable (func(self))."""
        if isinstance(func, str):
            return getattr(self, func)(*args, **kwargs)
        if isinstance(func, (list, tuple)):
            vals = [self.agg(f) for f in func]
            names = [f if isinstance(f, str) else f.__name__ for f in func]
            return Series(vals, index=names, name=self.name, device=self.device)
        return func(self, *args, **kwargs)

    aggregate = agg

    def transform(self, func, *args, **kwargs) -> "Series":
        """func (a name or a callable) of the Series, which must keep its
        length."""
        out = getattr(self, func)(*args, **kwargs) if isinstance(func, str) \
            else func(self, *args, **kwargs)
        if not isinstance(out, Series) or len(out) != len(self):
            raise ValueError("Function did not transform")
        return out

    def pipe(self, func, *args, **kwargs):
        """func(self, ...); a (func, keyword) pair passes self as that
        keyword."""
        if isinstance(func, tuple):
            func, target = func
            kwargs[target] = self
            return func(*args, **kwargs)
        return func(self, *args, **kwargs)

    def groupby(self, by=None, level=None, sort: bool = True, dropna: bool = True,
                as_index: bool = True, observed: bool = True):
        """Group by Series, host arrays of this length, or index levels
        (see ``frame/groupby.py``)."""
        from cudf_tpu_torch.frame.groupby import SeriesGroupBy

        return SeriesGroupBy(self, by, level=level, sort=sort, dropna=dropna,
                             as_index=as_index, observed=observed)

    # ------------------------------------------------------------------
    # scans and shifts
    # ------------------------------------------------------------------
    def cumsum(self) -> "Series":
        return self._new(scan_ops.cumsum(self._column))

    def cumprod(self) -> "Series":
        return self._new(scan_ops.cumprod(self._column))

    def cummin(self) -> "Series":
        return self._new(scan_ops.cummin(self._column))

    def cummax(self) -> "Series":
        return self._new(scan_ops.cummax(self._column))

    def shift(self, periods: int = 1, freq=None, fill_value=None) -> "Series":
        """Values ``periods`` rows on; with ``freq``, the values stay and a
        datetime index moves ``periods`` times the (fixed) frequency."""
        if freq is not None:
            from cudf_tpu_torch.ops import datetime as dto

            idx = dto.days_as_seconds(self._index.column(self.device))
            if not idx.dtype.is_timestamp:
                raise TypeError("shift(freq=...) needs a datetime index")
            step = dto.freq_ticks(freq, idx.dtype.time_unit) * periods
            moved = Column(idx.dtype, idx.length, idx.data + step, idx.validity)
            return Series._from(self._column, Index(moved, name=self._index.name), self.name)
        return self._new(copying.shift(self._column, periods, fill_value))

    # ------------------------------------------------------------------
    # windows and hashes
    # ------------------------------------------------------------------
    def rolling(self, window, min_periods=None, center: bool = False):
        from cudf_tpu_torch.frame.window import Rolling

        return Rolling(self, window, min_periods, center)

    def ewm(self, com=None, span=None, halflife=None, alpha=None, adjust: bool = True,
            ignore_na: bool = False):
        from cudf_tpu_torch.frame.window import EWM, ewm_alpha

        return EWM(self, ewm_alpha(com, span, halflife, alpha), adjust, ignore_na)

    def resample(self, rule):
        from cudf_tpu_torch.frame.resample import Resampler

        return Resampler(self, rule)

    def hash_values(self, method: str = "murmur3", seed: int = 0) -> "Series":
        """Each value's hash (cudf's ``Series.hash_values``): murmur3 and
        xxhash64 on the device, md5 and sha* on the host."""
        from cudf_tpu_torch.ops import hashing

        return Series._from(hashing.hash_values([self._column], method, seed), self._index,
                            self.name)

    def diff(self, periods: int = 1) -> "Series":
        return self - self.shift(periods)

    def pct_change(self, periods: int = 1) -> "Series":
        prev = self.shift(periods)
        return (self - prev) / prev

    # ------------------------------------------------------------------
    # order and sets
    # ------------------------------------------------------------------
    def argsort(self, ascending: bool = True) -> "Series":
        order = sort_ops.sorted_order([self._nan_null()], [ascending], "last")
        return self._new(Column(dt.INT64, len(self), order))

    def rank(self, method: str = "average", ascending: bool = True, na_option: str = "keep",
             pct: bool = False) -> "Series":
        return self._new(sort_ops.rank(self._nan_null(), method, ascending, na_option, pct))

    def sort_values(self, ascending: bool = True, na_position: str = "last",
                    ignore_index: bool = False, kind=None) -> "Series":
        """A stable sort (any ``kind``); NaN sorts as null."""
        out = self.take(sort_ops.sorted_order([self._nan_null()], [ascending], na_position))
        if ignore_index:
            out._index = default_index(len(out))
        return out

    def sort_index(self, ascending: bool = True) -> "Series":
        idx = self._index
        cols = list(idx._columns) if isinstance(idx, MultiIndex) else [idx.column(self.device)]
        return self.take(sort_ops.sorted_order(cols, [ascending] * len(cols), "last"))

    def _nselect(self, n: int, largest: bool) -> "Series":
        if not (self.dtype.is_numeric or self.dtype.is_bool or self.dtype.is_temporal):
            raise TypeError(f"Cannot use method 'nlargest/nsmallest' with dtype {self.dtype}")
        return self.dropna().sort_values(ascending=not largest).head(max(int(n), 0))

    def nlargest(self, n: int = 5, keep: str = "first") -> "Series":
        return self._nselect(n, True)

    def nsmallest(self, n: int = 5, keep: str = "first") -> "Series":
        return self._nselect(n, False)

    def unique(self) -> np.ndarray:
        idx = sc.distinct_indices([self._column], "first")
        return copying.gather(self._column, idx, bounds_check=False).to_numpy()

    def drop_duplicates(self, keep="first", ignore_index: bool = False) -> "Series":
        out = self.take(sc.distinct_indices([self._column],
                                            keep if keep is not False else "none"))
        if ignore_index:
            out._index = default_index(len(out))
        return out

    def duplicated(self, keep="first") -> "Series":
        mask = sc.duplicated_mask([self._column], keep if keep is not False else "none")
        return self._new(Column(dt.BOOL8, len(self), mask))

    def value_counts(self, normalize: bool = False, sort: bool = True,
                     ascending: bool = False, dropna: bool = True) -> "Series":
        """Rows a distinct value, named "count" ("proportion" with
        normalize), the values in order of first appearance, then stably
        by count (descending unless ``ascending``) with ``sort``."""
        from cudf_tpu_torch.ops import groupby as gb

        g = gb.make_grouper([self._nan_null()], dropna=dropna)
        counts = gb.group_size(g)
        first = g.frame_rows(g.key_rows)
        appear = torch.argsort(first)
        keys = copying.gather(self._column, first[appear], bounds_check=False)
        counts = copying.gather(counts, appear, bounds_check=False)
        out = Series._from(counts, Index(keys, self.name), "count")
        if normalize:
            total = float(counts.data.sum())
            out = Series._from(Column(dt.FLOAT64, counts.length, counts.data.double() / total),
                               out._index, "proportion")
        if sort:
            out = out.take(sort_ops.sorted_order([out._column], [ascending], "last"))
        return out

    def isin(self, values) -> "Series":
        """Membership in a list (a dictionary column decided per key) or in
        a Series, Index or Column; a missing row matches a missing value."""
        from cudf_tpu_torch.ops.search import contains, is_in_list

        col = self._nan_null()
        if isinstance(values, (Series, Index, Column, torch.Tensor)):
            vals = values._column if isinstance(values, Series) else (
                values.column(self.device) if isinstance(values, Index)
                else column_of(values, self.device))
            mask = contains(vals, col)
        else:
            mask = is_in_list(col, list(values))
        return self._new(Column(dt.BOOL8, len(self), mask))

    def between(self, left, right, inclusive: str = "both") -> "Series":
        lo = self >= left if inclusive in ("both", "left") else self > left
        hi = self <= right if inclusive in ("both", "right") else self < right
        return lo & hi

    def searchsorted(self, value, side: str = "left"):
        from cudf_tpu_torch.ops.search import lower_bound

        scalar = np.isscalar(value)
        needles = column_of([value] if scalar else value, self.device)
        out = lower_bound(self._column, needles, side)
        return int(out[0]) if scalar else out.cpu().numpy()

    def factorize(self, sort: bool = False):
        """(int64 codes, -1 for a missing row; the distinct values as an
        Index), in order of first appearance unless ``sort``."""
        from cudf_tpu_torch.ops.dictionary import factorize

        col = self._nan_null()
        codes, keys = factorize(col, sort=sort)
        codes = codes.long()
        if col.validity is not None:
            codes = torch.where(col.validity, codes, -1)
        return codes.cpu().numpy(), Index(keys)

    # ------------------------------------------------------------------
    # elementwise
    # ------------------------------------------------------------------
    def astype(self, dtype, copy=None, errors: str = "raise") -> "Series":
        target = dt.dtype(dtype)
        col = self._column
        if errors == "raise" and target.is_integer and not target.nullable \
                and not (col.dtype.is_integer or col.dtype.is_temporal) \
                and self._has_nulls_or_nans():
            raise ValueError("Cannot convert non-finite values (NA or inf) to integer")
        if errors == "raise" and target.is_integer and col.dtype.is_float \
                and bool(torch.isinf(col.data).any()):
            raise ValueError("Cannot convert non-finite values (NA or inf) to integer")
        if col.dtype.is_temporal and target == dt.INT64 and col.validity is not None:
            # pandas' astype gives NaT as iNaT (INT64_MIN); the column cast keeps it null
            return self._new(Column(target, col.length, torch.where(
                col.validity, col.data, torch.iinfo(torch.int64).min)))
        try:
            out = unary.cast(col, target)
        except (TypeError, NotImplementedError):
            if errors == "ignore":
                return self.copy(deep=False)
            raise
        return self._new(out)

    def where(self, cond, other=None) -> "Series":
        if not isinstance(cond, Series):
            cond = Series._from(column_of(cond, self.device), self._index)
        keep = self._aligned_mask(cond)
        if other is None or is_null_scalar(other):
            return self._new(replace_ops.replace_where(self._column, ~keep, None))
        if _scalar(other):
            return self._new(replace_ops.replace_where(self._column, ~keep, other))
        other = self._operand(other)
        _, ocol, _ = _align(self, other)
        return self._new(copying.copy_if_else(keep, self._column, ocol))

    def mask(self, cond, other=None) -> "Series":
        if not isinstance(cond, Series):
            cond = Series._from(column_of(cond, self.device), self._index)
        return self.where(~cond, other)

    def clip(self, lower=None, upper=None) -> "Series":
        return self._new(replace_ops.clamp(self._column, lower, upper))

    def round(self, decimals: int = 0) -> "Series":
        return self._new(unary.round(self._column, decimals))

    def replace(self, to_replace, value=None) -> "Series":
        if isinstance(to_replace, dict):
            olds, news = list(to_replace.keys()), list(to_replace.values())
        elif isinstance(to_replace, (list, tuple, np.ndarray)):
            olds = list(to_replace)
            news = list(value) if isinstance(value, (list, tuple, np.ndarray)) \
                else [value] * len(olds)
        else:
            olds, news = [to_replace], [value]
        col = self._column
        keyed = col.dtype.is_string or col.dtype.is_dictionary
        pairs = [(o, v) for o, v in zip(olds, news)
                 if is_null_scalar(o) or isinstance(o, str) == keyed]
        if not pairs:                       # no value of the column's kind to find
            return self._new(col)
        olds, news = [o for o, _ in pairs], [v for _, v in pairs]
        if col.dtype.is_dictionary:
            from cudf_tpu_torch.ops.dictionary import _remap, encode

            keys = replace_ops.replace_values(col.keys, _host_column(olds, col.keys),
                                              _host_column(news, col.keys))
            enc = encode(keys)
            return self._new(_remap(col, enc.data.long(), enc.keys))
        few = replace_ops.replace_scalars(col, olds, news)
        if few is not None:
            return self._new(few)
        return self._new(replace_ops.replace_values(col, _host_column(olds, col),
                                                    _host_column(news, col)))

    def map(self, arg, na_action=None) -> "Series":
        """Values looked up in a dict or a Series (by its index), null
        where a value has no entry: the mapper's keys sorted once, then a
        left and a right search of every row and one gather, on the
        column's device.  A callable runs on the host, value by value (the
        reference's loop; ``apply`` vmaps one on the device)."""
        if isinstance(arg, Series):
            keys, values = arg._index.column(self.device), arg._column
        elif isinstance(arg, dict):
            if not arg:
                return self._new(Column.full(len(self), None, dt.FLOAT64, device=self.device))
            keys = _host_column(list(arg.keys()), self._column)
            values = Column.from_pylist(list(arg.values()), device=self.device)
        elif callable(arg):
            return self._host_map(arg, na_action)
        else:
            raise TypeError(f"map takes a dict, a Series or a callable, not "
                            f"{type(arg).__name__}")
        from cudf_tpu_torch.ops.join import _aligned_keys, _lex_searchsorted, _sorted_build

        col = self._nan_null()
        l_ops, k_ops = _aligned_keys([col], [keys])
        k_sorted, k_order = _sorted_build(k_ops)
        lo = _lex_searchsorted(k_sorted, l_ops, "left")
        found = _lex_searchsorted(k_sorted, l_ops, "right") > lo
        if col.validity is not None:
            found &= col.validity
        pick = torch.where(found, k_order[lo.clamp(max=max(keys.length - 1, 0))], -1)
        return self._new(copying.gather(values, pick, bounds_check=True))

    def _host_map(self, func, na_action=None) -> "Series":
        UDF_ROUTES["host"] += 1
        missing = self.isna()._column.data.cpu().tolist()
        vals = [None if m and na_action == "ignore" else func(v)
                for v, m in zip(self.tolist(), missing)]
        return Series(vals, index=self._index, name=self.name, device=self.device)

    def apply(self, func, args=(), masked: bool = False, **kwargs) -> "Series":
        """A UDF of each value, vmapped over the column on its device
        (``torch.func.vmap``; a missing float is NaN to the UDF, as in
        pandas, and another column's null row stays null).  ``masked=True``
        hands it a ``Masked`` (value, valid) pair instead, and the result's
        nulls are its own.  A UDF vmap cannot trace (Python control flow on
        a value, ``.item()``, a result that is not a number) runs on the
        host, value by value, as the reference's does.  ``UDF_ROUTES``
        counts the route taken."""
        fn = (lambda x: func(x, *args, **kwargs)) if args or kwargs else func
        col = self._column
        validity = col.validity
        if masked:
            from cudf_tpu_torch.utils.masked import Masked

            arg, validity = Masked(col.data, materialize_validity(col)), None
        elif col.dtype.is_float and validity is not None:
            # pandas hands the UDF NaN for a missing float: its result stands
            arg = torch.where(validity, col.data, float("nan"))
            validity = None
        else:
            arg = col.data
        out = vmap_udf(fn, arg, self.device)
        if out is None:
            return self._host_map(fn)
        UDF_ROUTES["vmap"] += 1
        return self._new(udf_column(out, len(self), validity))

    def interpolate(self, method: str = "linear", **kwargs) -> "Series":
        """Linear interpolation over positions between the valid values
        around each missing one; leading missing values stay missing,
        trailing ones take the last valid value (pandas' default
        ``limit_direction="forward"``).  The previous and next valid
        positions come from blocked running maxima, with no loop over the
        rows."""
        if method != "linear" or kwargs:
            raise NotImplementedError(f"interpolate(method={method!r}, {sorted(kwargs)}): "
                                      f"linear only, as the reference; {BEYOND}")
        col = self._nan_null()
        if col.validity is None:
            return self.copy(deep=False)
        n, dev = len(self), self.device
        valid = col.validity
        pos = torch.arange(n, device=dev)
        prev = scan_ops.running_extreme(torch.where(valid, pos, -1), "cummax")
        after = scan_ops.running_extreme(torch.where(valid.flip(0), pos, -1), "cummax")
        nxt = (n - 1) - after.flip(0)                 # n where no valid value follows
        x = col.data.double()
        pv, nv = x[prev.clamp(0, n - 1)], x[nxt.clamp(0, n - 1)]
        has_prev, has_next = prev >= 0, nxt < n
        step = (pos - prev).double() / (nxt - prev).clamp(min=1).double()
        out = torch.where(valid, x, torch.where(has_next, pv + (nv - pv) * step, pv))
        target = self.dtype if self.dtype.is_float else dt.FLOAT64
        return self._new(Column(target, n, out.to(target.torch_storage),
                                maybe_mask(valid | has_prev)))

    def combine_first(self, other: "Series") -> "Series":
        """Aligned by label (the sorted union when the indexes differ);
        each missing value of self takes other's."""
        lhs, rhs, index = _align(self._new(self._nan_null()), other)
        return Series._from(replace_ops.replace_nulls_column(lhs, rhs), index, self.name)

    def update(self, other) -> None:
        """In place, as pandas: each non-missing value of ``other`` (a
        Series by label, or an array by position) overwrites self's value
        at its label; labels self lacks are ignored, and the dtype stays
        self's."""
        if not isinstance(other, Series):
            other = Series._from(column_of(other, self.device), self._index)
        pos = self._index.get_indexer_for(other._index.column(self.device), self.device)
        src = other._nan_null()
        keep = sc.filter_indices((pos >= 0) & materialize_validity(src))
        self._column = copying.scatter(copying.gather(src, keep, bounds_check=False),
                                       pos[keep], self._column)

    def unstack(self, level=-1, fill_value=None):
        """A MultiIndex level moved into the columns (``frame/reshape.py``
        ``unstack``)."""
        from cudf_tpu_torch.frame.reshape import unstack

        return unstack(self, level=level, fill_value=fill_value)

    def repeat(self, repeats) -> "Series":
        col = copying.repeat(self._column, repeats)
        idx = Index(copying.repeat(self._index.column(self.device), repeats),
                    self._index.name)
        return self._new(col, idx)

    def sample(self, n=None, frac=None, replace: bool = False, random_state=0) -> "Series":
        """Rows drawn as ``ops/copying.py`` ``sample`` draws them (a
        torch.Generator seeded with ``random_state``: not pandas' rows)."""
        n = int(round((frac or 1.0) * len(self))) if n is None else n
        return self.take(copying.sample_rows(len(self), n, int(random_state or 0), replace,
                                             self.device))

    def equals(self, other) -> bool:
        if not isinstance(other, Series) or len(self) != len(other):
            return False
        if len(self) == 0:
            return True
        try:
            eq = binaryop.binary_operation(self._column, other._column, "null_equals")
        except TypeError:
            return False
        return bool(eq.data.all())


for _dunder, _op in _BINOPS.items():
    def _make(op=_op):
        def f(self, other):
            return self._binop(other, op)
        return f
    setattr(Series, _dunder, _make())

for _dunder, _op in _RBINOPS.items():
    def _make_r(op=_op):
        def f(self, other):
            return self._binop(other, op, reflect=True)
        return f
    setattr(Series, _dunder, _make_r())

for _named, _op in (("add", "add"), ("sub", "sub"), ("subtract", "sub"), ("mul", "mul"),
                    ("multiply", "mul"), ("div", "truediv"), ("truediv", "truediv"),
                    ("divide", "truediv"), ("floordiv", "floordiv"), ("mod", "mod"),
                    ("pow", "pow")):
    def _make_named(op=_op):
        def f(self, other, fill_value=None):
            return self._fill_binop(other, op, fill_value)
        return f

    def _make_rnamed(op=_op):
        def f(self, other, fill_value=None):
            return self._fill_binop(other, op, fill_value, reflect=True)
        return f
    setattr(Series, _named, _make_named())
    setattr(Series, "r" + _named, _make_rnamed())

for _named in _COMPARISONS:
    def _make_cmp(op=_named):
        def f(self, other):
            return self._binop(other, op)
        return f
    setattr(Series, _named, _make_cmp())


def _scalar(value) -> bool:
    return value is None or np.isscalar(value) or is_null_scalar(value) or \
        isinstance(value, (np.datetime64, np.timedelta64))


def _bool_array(key) -> bool:
    if isinstance(key, torch.Tensor):
        return key.dtype == torch.bool
    if isinstance(key, np.ndarray):
        return key.dtype == bool
    return len(key) > 0 and all(isinstance(v, (bool, np.bool_)) for v in key)


def relabel(index: Index, mapper, device) -> Index:
    """New index labels: each label (a MultiIndex's, level by level)
    through a dict (a label it lacks kept) or a callable, on the host."""
    fn = (lambda v: mapper.get(v, v)) if isinstance(mapper, dict) else mapper
    if isinstance(index, MultiIndex):
        return MultiIndex([label_column([fn(v) for v in c.to_numpy().tolist()], device)
                           for c in index._columns], index.names)
    return Index(label_column([fn(v) for v in index.to_pylist()], device), index.name)


def _host_column(values, like: Column) -> Column:
    """Host values as a column on ``like``'s device, in its dtype where
    they fit it (strings and dictionaries as strings)."""
    if like.dtype.is_string or like.dtype.is_dictionary:
        return Column.from_pylist(values, dt.STRING if all(
            isinstance(v, str) or is_null_scalar(v) for v in values) else None,
            device=like.device)
    fits = all(is_null_scalar(v) or holds(like.dtype, v) for v in values)
    return Column.from_pylist(values, like.dtype if fits else None, device=like.device)


# ----------------------------------------------------------------------
# indexers
# ----------------------------------------------------------------------

class _SeriesILoc:
    def __init__(self, s: Series):
        self._s = s

    def __getitem__(self, key):
        s = self._s
        if isinstance(key, (int, np.integer)):
            return copying.get_element(s._column, int(key))
        if isinstance(key, slice):
            start, stop, step = key.indices(len(s))
            if step == 1:
                return s._new(copying.slice(s._column, start, stop),
                              s._index.slice(start, stop))
            return s.take(torch.arange(start, stop, step, device=s.device))
        if _bool_array(key):
            return s._filter(Series._from(column_of(key, s.device), s._index))
        return s.take(key)

    def __setitem__(self, key, value):
        s = self._s
        check_setitem_compat(s.dtype, value)
        if isinstance(key, (int, np.integer)):
            key = [int(key)]
        if isinstance(key, slice):
            start, stop, step = key.indices(len(s))
            idx = torch.arange(start, stop, step, device=s.device)
        else:
            idx = torch.as_tensor(key, device=s.device).long()
        s._set_positions(idx, value)


class _SeriesLoc:
    def __init__(self, s: Series):
        self._s = s

    def __getitem__(self, key):
        s = self._s
        if isinstance(key, Series) and key.dtype.is_bool:
            return s._filter(key)
        if isinstance(key, slice):
            if key.start is None and key.stop is None:
                return s.copy(deep=False)
            start = 0 if key.start is None else s._index.get_loc(key.start)
            stop = len(s) - 1 if key.stop is None else s._index.get_loc(key.stop)
            return s.iloc[int(start):int(stop) + 1]
        if np.isscalar(key) or key is None:
            pos = s._index._positions_of(key, s.device)
            if pos.shape[0] == 0:
                raise KeyError(key)
            if pos.shape[0] == 1:
                return copying.get_element(s._column, int(pos[0]))
            return s.take(pos)
        if _is_listlike(key) and _bool_array(key):
            return s._filter(Series._from(column_of(key, s.device), s._index))
        pos = s._index.get_indexer_for(key, s.device)
        missing = pos < 0
        if bool(missing.any()):
            raise KeyError(f"labels not in the index: {np.asarray(key)[missing.cpu().numpy()]}")
        return s.take(pos)

    def __setitem__(self, key, value):
        self._s[key] = value


# ----------------------------------------------------------------------
# alignment
# ----------------------------------------------------------------------

def aligned_mask(index: Index, device, mask: Series) -> torch.Tensor:
    """A boolean Series as bool[len(index)] by label (missing or null:
    False); a mask over this very index is taken as it is."""
    m = mask._column
    if not mask._index.equals(index):
        pos = mask._index.get_indexer_for(index.column(device), device)
        m = copying.gather(m, pos, bounds_check=True)
    return sc._mask_of(m)


def _align(a: Series, b: Series):
    """pandas' alignment: equal indexes as they are (one index object
    costs nothing), else the sorted union of the labels, a label missing
    on one side null there."""
    if a._index.equals(b._index):
        return a._column, b._column, a._index
    union = a._index.union(b._index)
    dev = a.device
    labels = union.column(dev)
    ca = copying.gather(a._column, a._index.get_indexer_for(labels, dev), bounds_check=True)
    cb = copying.gather(b._column, b._index.get_indexer_for(labels, dev), bounds_check=True)
    return ca, cb, union


def check_setitem_compat(dtype: dt.DType, value) -> None:
    """pandas 3's setitem strictness: a value the column's dtype cannot
    hold without loss raises instead of changing the dtype."""
    def one(v):
        if is_null_scalar(v):
            if (dtype.is_integer or dtype.is_bool) and not dtype.nullable:
                raise TypeError(f"Invalid value {v!r} for dtype {dtype}")
            return
        if dtype.is_bool:
            if not isinstance(v, (bool, np.bool_)):
                raise TypeError(f"Invalid value {v!r} for dtype bool")
        elif dtype.is_integer:
            if isinstance(v, (bool, np.bool_)) or not isinstance(v, numbers.Real) or (
                    not isinstance(v, numbers.Integral) and float(v) != int(v)):
                raise TypeError(f"Invalid value {v!r} for dtype {dtype}")
        elif dtype.is_float:
            if isinstance(v, (bool, np.bool_)) or not isinstance(v, numbers.Real):
                raise TypeError(f"Invalid value {v!r} for dtype {dtype}")
        elif dtype.is_string and not isinstance(v, str):
            raise TypeError(f"Invalid value {v!r} for dtype str")

    if _scalar(value):
        one(value)
    elif isinstance(value, (list, tuple)) and len(value) <= 64:
        for v in value:
            one(v)
