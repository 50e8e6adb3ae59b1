"""DataFrame (port of ``cudf_tpu/frame/dataframe.py``): a Table of
columns and an index, with pandas' frame API.

- Construction from tensors, numpy arrays (numeric, temporal, strings),
  lists, Categoricals, Columns and Series; ``from_pandas`` and
  ``to_pandas``.
- Column access: ``df[name]``, ``df.name``, ``df[[names]]``, a boolean
  mask Series or list, a row slice; ``__setitem__`` aligns a Series by
  label as pandas does and broadcasts a scalar on the frame's device;
  ``assign``, ``insert``, ``pop``, ``rename``, ``drop``.
- Rows: ``iloc``, ``loc``, ``head``, ``tail``, ``take``, ``set_index``,
  ``reset_index``, sorts, ``drop_duplicates``, ``nlargest``.
- Per column: missing data, ``astype``, ``clip``, ``where``, scans,
  arithmetic and comparisons; reductions by column or by row (axis=1).
- ``agg``, ``transform``, ``pipe``, ``describe``, ``corr`` and ``cov``
  (pairwise-complete rows, two passes a pair), as pandas'.
- ``groupby``, ``merge`` and ``join`` (``frame/groupby.py``,
  ``frame/join.py``); ``pivot_table``, ``melt``, ``stack``, ``unstack``
  and ``transpose`` (``frame/reshape.py``, on the device); ``apply`` of a
  column UDF, or of a row UDF vmapped on the device (``engine="torch"``)
  or looped on the host.

A frame lives where its tensors live.  Host data (numpy arrays, pandas
frames) needs an explicit ``device=``; nothing picks one by looking for
a GPU.  pandas is imported only inside ``to_pandas``.  ``__setitem__``
never writes into a column's buffers: it rebinds the table's column, so
a frame and a frame filtered from it never share a buffer one of them
changes; ``copy()`` clones the buffers, as pandas does.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Optional

import numpy as np
import torch

from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import Column, is_null_scalar
from cudf_tpu_torch.core.table import Table
from cudf_tpu_torch.frame.index import Index, MultiIndex, RangeIndex, as_index, default_index
from cudf_tpu_torch.frame.series import (BEYOND, UDF_ROUTES, Series, _bool_array, _clone,
                                         _is_listlike, _scalar, aligned_mask, column_of,
                                         not_ported, relabel, udf_column, vmap_udf)
from cudf_tpu_torch.ops import copying
from cudf_tpu_torch.ops import replace as replace_ops
from cudf_tpu_torch.ops import sort as sort_ops
from cudf_tpu_torch.ops import stream_compaction as sc
from cudf_tpu_torch.ops import unary
from cudf_tpu_torch.ops._utils import materialize_validity, maybe_mask
from cudf_tpu_torch.ops.replace import nans_to_nulls
from cudf_tpu_torch.utils import tracing

# pandas methods the port does not have yet, and the ROADMAP.md item
# that brings each
_NOT_PORTED = {
    "map": BEYOND, "applymap": BEYOND, "interpolate": BEYOND, "update": BEYOND,
}
# the row reductions of agg(axis=1), by name
_ROW_REDUCTIONS = ("sum", "prod", "mean", "min", "max", "std", "var", "median", "count",
                   "any", "all", "sem")


def _names_of(key) -> list:
    return [key] if not isinstance(key, (list, tuple)) else list(key)


class DataFrame:
    # the names of the columns axis' levels (pandas' ``columns.names``),
    # which reshapes give; None: unnamed
    _columns_names = None

    def __init__(self, data: Optional[Dict] = None, index=None, *, device=None):
        """data: {name: torch.Tensor | numpy array | list | pandas
        Categorical | Column | Series}.  Tensors and columns stay on their
        device; host data (numeric, bool, datetime64 / timedelta64, str or
        object strings, Categoricals as dictionary columns) goes to
        ``device``, which it requires."""
        self._table = Table({k: column_of(v, device) for k, v in (data or {}).items()})
        if index is None:
            series_index = [v._index for v in (data or {}).values() if isinstance(v, Series)
                            and not isinstance(v._index, RangeIndex)]
            index = series_index[0] if series_index else None
        self._index = as_index(index, device or self.device) if index is not None \
            else default_index(self._table.num_rows)
        if self._table.num_columns and len(self._index) != self._table.num_rows:
            raise ValueError("index length mismatch")

    @classmethod
    def _from(cls, table: Table, index: Index) -> "DataFrame":
        df = cls.__new__(cls)
        df._table = table
        df._index = index
        return df

    def _new(self, table: Table, index: Optional[Index] = None) -> "DataFrame":
        return DataFrame._from(table, self._index if index is None else index)

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
    def device(self) -> Optional[torch.device]:
        if self._table.num_columns:
            return self._table.column(0).device
        return self._index.device

    @property
    def columns(self) -> list:
        return list(self._table.names)

    @columns.setter
    def columns(self, names):
        names = list(names)
        if len(names) != self._table.num_columns:
            raise ValueError("length mismatch")
        self._table = Table.from_pairs(names, self._table.columns)

    @property
    def dtypes(self) -> Dict:
        return {n: c.dtype for n, c in self._table.items()}

    @property
    def shape(self):
        return (len(self), self._table.num_columns)

    @property
    def size(self) -> int:
        return len(self) * self._table.num_columns

    @property
    def ndim(self) -> int:
        return 2

    @property
    def empty(self) -> bool:
        return len(self) == 0 or self._table.num_columns == 0

    @property
    def values(self) -> np.ndarray:
        return np.column_stack([c.to_numpy() for c in self._table.columns])

    def to_numpy(self) -> np.ndarray:
        return self.values

    @tracing.annotate("DataFrame.__len__")
    def __len__(self) -> int:
        return self._table.num_rows if self._table.num_columns else len(self._index)

    def __contains__(self, name) -> bool:
        return name in self._table

    def __iter__(self):
        return iter(self._table.names)

    def keys(self) -> list:
        return self.columns

    def items(self):
        for n in self._table.names:
            yield n, self[n]

    iteritems = items

    def iterrows(self):
        """(label, row Series) pairs, as pandas gives them (through
        ``to_pandas``, as the reference)."""
        return self.to_pandas().iterrows()

    def itertuples(self, index: bool = True, name="Pandas"):
        return self.to_pandas().itertuples(index=index, name=name)

    def to_records(self, index: bool = True):
        """A numpy record array of the rows (through ``to_pandas``)."""
        return self.to_pandas().to_records(index=index)

    def memory_usage(self, deep: bool = False) -> Series:
        """Each column's bytes on its device (``Column.nbytes``), as a Series
        over the column names (the index is not counted, as in the
        reference)."""
        dev = self.device
        return Series([c.nbytes for c in self._table.columns],
                      index=Index(Column.from_pylist(list(self._table.names), device=dev)),
                      device=dev)

    def info(self, verbose=None, buf=None, max_cols=None, memory_usage=None,
             show_counts=None) -> None:
        """pandas' summary: the class, the index's extent, then a line a
        column with its non-null count and dtype, the dtype counts and the
        bytes the columns hold on the device (one host read of the null
        counts)."""
        import sys

        names, cols = list(self._table.names), list(self._table.columns)
        idx = self._index
        kind = type(idx).__name__ if isinstance(idx, (RangeIndex, MultiIndex)) else "Index"
        extent = f"{kind}: {len(self)} entries"
        if len(self):
            labels = idx.to_pylist()
            extent += f", {labels[0]} to {labels[-1]}"
        counts = [Series._from(c, idx, n).count() for n, c in zip(names, cols)]
        dtypes = [str(c.dtype) for c in cols]
        head = (" # ", "Column", "Non-Null Count", "Dtype")
        rows = [(f" {i} ", str(n), f"{k} non-null", d)
                for i, (n, k, d) in enumerate(zip(names, counts, dtypes))]
        widths = [max(len(r[j]) for r in [head] + rows) for j in range(4)]
        fmt = "  ".join(f"{{:<{w}}}" for w in widths)
        tally = Counter(dtypes)
        lines = [str(type(self)), extent, f"Data columns (total {len(names)} columns):",
                 fmt.format(*head), fmt.format(*("-" * len(h.strip()) if j else "---"
                                                for j, h in enumerate(head))),
                 *(fmt.format(*r) for r in rows),
                 "dtypes: " + ", ".join(f"{d}({k})" for d, k in sorted(tally.items())),
                 f"memory usage: {float(self._table.nbytes)} bytes"]
        (buf or sys.stdout).write("\n".join(lines) + "\n")

    def copy(self, deep: bool = True) -> "DataFrame":
        """A frame over clones of the buffers (views of them unless deep)."""
        table = Table.from_pairs(self._table.names, [_clone(c) if deep else c
                                                     for c in self._table.columns])
        return self._new(table, self._index.copy())

    def to_dict(self, orient: str = "dict") -> Dict:
        if orient != "list":
            labels = self._index.to_pylist()
            return {n: dict(zip(labels, c.to_numpy().tolist())) for n, c in self._table.items()}
        return {n: c.to_numpy().tolist() for n, c in self._table.items()}

    def __repr__(self) -> str:
        cols = ", ".join(f"{n}: {c.dtype!r}" for n, c in self._table.items())
        return f"DataFrame[{len(self)} rows on {self.device}]({cols})"

    # ------------------------------------------------------------------
    # pandas round trip
    # ------------------------------------------------------------------
    @classmethod
    def from_pandas(cls, pdf, *, device) -> "DataFrame":
        """numpy-backed numeric, bool and temporal columns, pandas' nullable
        columns, strings and Categoricals onto ``device``; NaN in a float
        column and NaT are nulls.  A non-range index becomes an Index."""
        cols = {name: Column.from_pandas(pdf.iloc[:, i], device=device)
                for i, name in enumerate(pdf.columns)}
        pidx = pdf.index
        if type(pidx).__name__ == "RangeIndex":
            index = RangeIndex(pidx.start, pidx.stop, pidx.step, name=pidx.name)
        elif type(pidx).__name__ == "MultiIndex":
            index = as_index(pidx, device)
        else:
            index = Index(Column.from_numpy(np.asarray(pidx), device=device),
                          name=pidx.name)
        return cls._from(Table(cols), index)

    @classmethod
    def from_dict(cls, data: Dict, orient: str = "columns", dtype=None, columns=None, *,
                  device) -> "DataFrame":
        """``orient="columns"``: {column: values}; ``"index"``: {row label:
        {column: value} or a list of values}, the columns in order of first
        appearance (or ``columns``), a value a row lacks missing; without
        pandas."""
        if orient == "columns":
            out = cls(data, device=device)
        elif orient == "index":
            out = cls(_columns_of_rows(list(data.values()), columns), index=list(data),
                      device=device)
        else:
            raise ValueError(f"orient={orient!r}: 'columns' or 'index'")
        return out.astype(dtype) if dtype is not None else out

    @classmethod
    def from_records(cls, data, columns=None, index=None, *, device) -> "DataFrame":
        """Rows as tuples or lists (columns named by ``columns``, else
        0..k-1), dicts, or a numpy structured array; ``index`` names a
        column to take as the index."""
        if isinstance(data, np.ndarray) and data.dtype.names:
            names = list(columns) if columns is not None else list(data.dtype.names)
            out = cls({n: data[n] for n in names}, device=device)
        else:
            out = cls(_columns_of_rows(list(data), columns), device=device)
        return out.set_index(index) if index is not None else out

    @classmethod
    def from_arrow(cls, tbl, *, device) -> "DataFrame":
        """A pyarrow Table, or any object with ``__arrow_c_stream__``
        (no pyarrow needed), onto ``device``."""
        t = Table.from_arrow(tbl, device=device)
        return cls._from(t, default_index(t.num_rows))

    def to_arrow(self):
        return self._table.to_arrow()

    def __arrow_c_array__(self, requested_schema=None):
        return self._table.__arrow_c_array__(requested_schema)

    def __arrow_c_stream__(self, requested_schema=None):
        return self._table.__arrow_c_stream__(requested_schema)

    def to_parquet(self, path, **kw):
        from cudf_tpu_torch.io.parquet import write_parquet

        return write_parquet(self, path, **kw)

    def to_csv(self, path=None, **kw):
        from cudf_tpu_torch.io.csv import write_csv

        return write_csv(self, path, **kw)

    def to_json(self, path=None, **kw):
        from cudf_tpu_torch.io.json import write_json

        return write_json(self, path, **kw)

    def to_orc(self, path, **kw):
        from cudf_tpu_torch.io.orc import write_orc

        return write_orc(self, path, **kw)

    def to_feather(self, path, **kw):
        from cudf_tpu_torch.io.feather import write_feather

        return write_feather(self, path, **kw)

    def to_tpudf(self, path):
        """The tpudf table file (``io/tpudf_file.py``)."""
        from cudf_tpu_torch.io.tpudf_file import write_tpudf

        return write_tpudf(self, path)

    def to_pandas(self):
        import pandas as pd

        names = self.columns
        columns = names
        if names and all(isinstance(n, tuple) for n in names) \
                and len({len(n) for n in names}) == 1:
            columns = pd.MultiIndex.from_tuples(names)     # (column, agg) names
        out = pd.DataFrame({i: c.to_pandas_array() for i, c in enumerate(self._table.columns)},
                           index=self._index.to_pandas())
        out.columns = columns
        if self._columns_names is not None:
            out.columns.names = list(self._columns_names)
        return out

    # ------------------------------------------------------------------
    # column access
    # ------------------------------------------------------------------
    @tracing.annotate("DataFrame.__getitem__")
    def __getitem__(self, key):
        if isinstance(key, Series) and key.dtype.is_bool:
            return self._filter(key)
        if isinstance(key, slice):
            return self.iloc[key]
        if _is_listlike(key) and len(key) and _bool_array(key):
            return self._filter(Series._from(column_of(key, self.device), self._index))
        if isinstance(key, list):
            return self._new(self._table.select(key))
        return Series._from(self._table[key], self._index, key)

    def __getattr__(self, name):
        try:
            table = object.__getattribute__(self, "_table")
        except AttributeError:
            raise AttributeError(name) from None
        if name in table.names:
            return self[name]
        raise AttributeError(name)

    def _column_for(self, value) -> Column:
        """A value for a new column: a Series aligned to the frame's labels
        (a label it lacks null), a scalar broadcast on the frame's device,
        or an array of the frame's length."""
        n, dev = len(self), self.device
        if isinstance(value, Series):
            if value._index.equals(self._index) or self._table.num_columns == 0 and \
                    isinstance(self._index, RangeIndex) and len(self._index) == 0:
                return value._column
            pos = value._index.get_indexer_for(self._index.column(value.device), value.device)
            return copying.gather(value._column, pos, bounds_check=True)
        if _scalar(value):
            if dev is None:
                raise ValueError("a scalar column of a frame without columns needs a device")
            return Column.full(n, value, dt.FLOAT64 if is_null_scalar(value) else None,
                               device=dev)
        col = column_of(value, dev)
        if self._table.num_columns and col.length != n:
            raise ValueError(f"Length of values ({col.length}) does not match length of "
                             f"index ({n})")
        return col

    def __setitem__(self, key, value):
        if isinstance(key, list):
            if not isinstance(value, DataFrame):
                raise NotImplementedError("several columns take a DataFrame")
            for k, vn in zip(key, value._table.names):
                self[k] = value[vn]
            return
        col = self._column_for(value)
        if self._table.num_columns == 0 and len(self._index) == 0:
            self._index = value._index if isinstance(value, Series) else \
                default_index(col.length)
        self._table = self._table.insert(key, col)

    def __delitem__(self, key):
        if key not in self._table:
            raise KeyError(key)
        self._table = self._table.drop([key])

    def pop(self, key) -> Series:
        s = self[key]
        del self[key]
        return s

    def insert(self, loc: int, column, value, allow_duplicates: bool = False):
        if column in self._table and not allow_duplicates:
            raise ValueError(f"cannot insert {column}, already exists")
        self._table = self._table.insert(column, self._column_for(value), loc=loc)

    def assign(self, **kwargs) -> "DataFrame":
        """A new frame with these columns set (a callable takes the frame)."""
        out = self._new(self._table)
        for k, v in kwargs.items():
            out[k] = v(out) if callable(v) else v
        return out

    def rename(self, mapper=None, columns=None, index=None, axis=0) -> "DataFrame":
        if mapper is not None:
            if axis in (1, "columns"):
                columns = mapper
            else:
                index = mapper
        out = self._new(self._table)
        if index is not None:
            out._index = relabel(self._index, index, self.device)
        if columns is not None:
            m = columns if isinstance(columns, dict) else {c: columns(c)
                                                           for c in self._table.names}
            out._table = out._table.rename(m)
        return out

    def drop(self, labels=None, axis=0, columns=None, index=None,
             errors: str = "raise") -> "DataFrame":
        if columns is not None or axis in (1, "columns"):
            names = _names_of(columns if columns is not None else labels)
            if errors == "raise":
                missing = [n for n in names if n not in self._table]
                if missing:
                    raise KeyError(f"{missing} not found in axis")
            return self._new(self._table.drop(names))
        labels = _names_of(index if index is not None else labels)
        pos = self._index.get_indexer_for(labels, self.device)
        if errors == "raise" and tracing.to_bool((pos < 0).any(), "label_lookup"):
            raise KeyError(f"{labels} not found in axis")
        keep = torch.ones(len(self), dtype=torch.bool, device=self.device)
        keep[pos[pos >= 0]] = False
        return self.take(sc.filter_indices(keep))

    def select_dtypes(self, include=None, exclude=None) -> "DataFrame":
        def matches(d: dt.DType, spec) -> bool:
            for s in (spec if isinstance(spec, (list, tuple)) else [spec]):
                if s in ("number", np.number):
                    hit = d.is_numeric
                elif s in ("object", str, "str", "string"):
                    hit = d.is_string
                elif s in ("bool", bool):
                    hit = d.is_bool
                elif s in ("datetime", "datetime64"):
                    hit = d.is_timestamp
                elif s == "category":
                    hit = d.is_dictionary
                else:
                    try:
                        hit = dt.dtype(s) == d
                    except TypeError:
                        hit = False
                if hit:
                    return True
            return False

        names = list(self._table.names)
        if include is not None:
            names = [n for n in names if matches(self._table[n].dtype, include)]
        if exclude is not None:
            names = [n for n in names if not matches(self._table[n].dtype, exclude)]
        return self._new(self._table.select(names))

    # ------------------------------------------------------------------
    # rows
    # ------------------------------------------------------------------
    @property
    def iloc(self):
        return _DataFrameILoc(self)

    @property
    def loc(self):
        return _DataFrameLoc(self)

    @property
    def at(self):
        return self.loc

    @property
    def iat(self):
        return self.iloc

    def take(self, indices) -> "DataFrame":
        """The rows at these positions (int64), with their index labels."""
        if not (isinstance(indices, torch.Tensor) and indices.device == self.device):
            indices = tracing.synced("host_values", self.device, torch.as_tensor, indices,
                                     device=self.device)
        indices = indices.long().reshape(-1)
        return self._new(copying.gather_table(self._table, indices, bounds_check=False),
                         self._index.take(indices))

    def _slice(self, start: int, stop: int) -> "DataFrame":
        table = Table.from_pairs(self._table.names, [copying.slice(c, start, stop)
                                                     for c in self._table.columns])
        return self._new(table, self._index.slice(start, stop))

    @tracing.annotate("DataFrame.head")
    def head(self, n: int = 5) -> "DataFrame":
        """The first n rows (all but the last -n when n < 0)."""
        n = len(self) + n if n < 0 else n
        return self._slice(0, max(0, min(n, len(self))))

    def tail(self, n: int = 5) -> "DataFrame":
        """The last n rows (all but the first -n when n < 0)."""
        start = -n if n < 0 else len(self) - min(n, len(self))
        return self._slice(start, len(self))

    def sample(self, n=None, frac=None, replace: bool = False, random_state=0) -> "DataFrame":
        """Rows drawn by a torch.Generator on the frame's device seeded with
        ``random_state`` (``ops/copying.py`` ``sample_rows``): n rows (or
        ``frac`` of them), distinct unless ``replace``, the same rows for
        the same seed on the same device; not pandas' or the reference's
        rows, whose generators differ."""
        n = int(round((frac or 1.0) * len(self))) if n is None else n
        return self.take(copying.sample_rows(len(self), n, int(random_state or 0), replace,
                                             self.device))

    def _filter(self, mask: Series) -> "DataFrame":
        """The rows where the mask (aligned by label) is True."""
        return self.take(sc.filter_indices(aligned_mask(self._index, self.device, mask)))

    def set_index(self, keys, drop: bool = True) -> "DataFrame":
        keys = _names_of(keys)
        idx = Index(self._table[keys[0]], keys[0]) if len(keys) == 1 else \
            MultiIndex([self._table[k] for k in keys], keys)
        return self._new(self._table.drop(keys) if drop else self._table, idx)

    def set_axis(self, labels, axis=0) -> "DataFrame":
        if axis in (0, "index"):
            idx = as_index(labels, self.device)
            if len(idx) != len(self):
                raise ValueError("length mismatch")
            return self._new(self._table, idx)
        out = self._new(self._table)
        out.columns = labels
        return out

    def reset_index(self, level=None, drop: bool = False) -> "DataFrame":
        """The index becomes the first columns (a MultiIndex one a level),
        named after it (or "index", "level_<i>"), unless drop; the new
        index is a RangeIndex.  ``level`` (names or positions) resets
        only those levels of a MultiIndex: the others stay the index.
        Beside (column, agg) tuple names a new name is padded like
        pandas' MultiIndex columns: ("k", "")."""
        index = default_index(len(self))
        if isinstance(self._index, MultiIndex):
            levels = [(name if name is not None else f"level_{i}", col)
                      for i, (name, col) in enumerate(zip(self._index.names,
                                                          self._index._columns))]
            if level is not None:
                names = list(self._index.names)
                sel = {names[lv] if isinstance(lv, int) else lv
                       for lv in (level if isinstance(level, (list, tuple)) else [level])}
                keep = [(c, n) for c, n in zip(self._index._columns, names) if n not in sel]
                levels = [lv for lv, n in zip(levels, names) if n in sel]
                if len(keep) == 1:
                    index = Index(keep[0][0], name=keep[0][1])
                elif keep:
                    index = MultiIndex([c for c, _ in keep], [n for _, n in keep])
        else:
            name = self._index.name if self._index.name is not None else "index"
            levels = [(name, self._index.column(self.device))]
        if drop:
            return self._new(self._table, index)
        widths = {len(n) for n in self._table.names if isinstance(n, tuple)}
        table = self._table
        for loc, (name, col) in enumerate(levels):
            if widths:
                name = (name,) + ("",) * (max(widths) - 1)
            table = table.insert(name, col, loc=loc)
        return self._new(table, index)

    # ------------------------------------------------------------------
    # missing data
    # ------------------------------------------------------------------
    def _per_column(self, fn, numeric_only: bool = False) -> "DataFrame":
        cols = []
        for n, c in self._table.items():
            s = Series._from(c, self._index, n)
            keep = numeric_only and not (c.dtype.is_numeric or c.dtype.is_bool)
            cols.append(c if keep else fn(s)._column)
        return self._new(Table.from_pairs(self._table.names, cols))

    @tracing.annotate("DataFrame.isna")
    def isna(self) -> "DataFrame":
        return self._per_column(lambda s: s.isna())

    isnull = isna

    def notna(self) -> "DataFrame":
        return self._per_column(lambda s: s.notna())

    notnull = notna

    def fillna(self, value=None, method=None, limit=None) -> "DataFrame":
        if isinstance(value, dict):
            out = self._new(self._table)
            for k, v in value.items():
                if k in out._table:
                    out[k] = out[k].fillna(v)
            return out
        return self._per_column(lambda s: s.fillna(value, method, limit))

    def ffill(self, limit=None) -> "DataFrame":
        return self._per_column(lambda s: s.ffill(limit))

    def bfill(self, limit=None) -> "DataFrame":
        return self._per_column(lambda s: s.bfill(limit))

    def dropna(self, axis=0, how: str = "any", subset=None, thresh=None) -> "DataFrame":
        """Rows with a missing value (NaN or null) in any (``how="any"``) or
        every (``"all"``) column of ``subset``, or with fewer than
        ``thresh`` present; with ``axis=1`` the columns with a missing
        value among the rows (labels in ``subset``), in one host sync."""
        if axis in (1, "columns"):
            rows = self if subset is None else self.loc[_names_of(subset)]
            cols = [nans_to_nulls(c) for c in rows._table.columns]
            present = tracing.tolist(torch.stack([materialize_validity(c).sum() for c in cols]),
                                     "null_count") if cols else []
            n = len(rows)
            keep = [(p >= thresh) if thresh is not None else (p == n if how == "any" else p > 0)
                    for p in present]
            return self._new(self._table.select([nm for nm, k in zip(self._table.names, keep)
                                                 if k]))
        names = _names_of(subset) if subset is not None else list(self._table.names)
        masks = [materialize_validity(nans_to_nulls(self._table[n])) for n in names]
        if thresh is not None:
            keep = torch.stack([m.long() for m in masks]).sum(0) >= thresh
        else:
            keep = masks[0]
            for m in masks[1:]:
                keep = keep & m if how == "any" else keep | m
        return self.take(sc.filter_indices(keep))

    # ------------------------------------------------------------------
    # per column
    # ------------------------------------------------------------------
    def astype(self, dtype, copy=None, errors: str = "raise") -> "DataFrame":
        if isinstance(dtype, dict):
            out = self._new(self._table)
            for k, v in dtype.items():
                out[k] = out[k].astype(v, errors=errors)
            return out
        return self._per_column(lambda s: s.astype(dtype, errors=errors))

    def abs(self) -> "DataFrame":
        return self._per_column(lambda s: s.abs())

    def round(self, decimals: int = 0) -> "DataFrame":
        return self._per_column(lambda s: s.round(decimals), numeric_only=True)

    def clip(self, lower=None, upper=None) -> "DataFrame":
        return self._per_column(lambda s: s.clip(lower, upper))

    def where(self, cond, other=None) -> "DataFrame":
        if isinstance(cond, DataFrame):
            return self._new(Table.from_pairs(self._table.names, [
                self[n].where(cond[n], other)._column for n in self._table.names]))
        return self._per_column(lambda s: s.where(cond, other))

    def mask(self, cond, other=None) -> "DataFrame":
        if isinstance(cond, DataFrame):
            return self.where(~cond, other)
        return self._per_column(lambda s: s.mask(cond, other))

    @tracing.annotate("DataFrame.__invert__")
    def __invert__(self) -> "DataFrame":
        return self._per_column(lambda s: ~s)

    def __neg__(self) -> "DataFrame":
        return self._per_column(lambda s: -s)

    def replace(self, to_replace, value=None) -> "DataFrame":
        return self._per_column(lambda s: s.replace(to_replace, value))

    def shift(self, periods: int = 1, freq=None, axis=0, fill_value=None) -> "DataFrame":
        """Rows down by ``periods`` (``fill_value`` in the rows left
        empty); with ``freq``, the temporal index moves by periods x freq
        and the values stay; ``axis=1`` moves each column's values to the
        column ``periods`` to its right, as pandas does (the columns left
        empty hold ``fill_value`` or nulls, in their own dtype)."""
        if freq is not None:
            return self._new(self._table, _shift_index(self._index, periods, freq))
        if axis in (1, "columns"):
            names, n, dev = list(self._table.names), len(self), self.device
            cols = []
            for i, name in enumerate(names):
                j = i - periods
                if 0 <= j < len(names):
                    cols.append(self._table[names[j]])
                else:
                    cols.append(Column.full(n, fill_value, self._table[name].dtype
                                            if fill_value is None else None, device=dev))
            return self._new(Table.from_pairs(names, cols))
        return self._per_column(lambda s: s.shift(periods, fill_value=fill_value))

    def rolling(self, window, min_periods=None, center: bool = False):
        from cudf_tpu_torch.frame.window import Rolling

        return Rolling(self, window, min_periods, center)

    def ewm(self, com=None, span=None, halflife=None, alpha=None, adjust: bool = True,
            ignore_na: bool = False):
        from cudf_tpu_torch.frame.window import EWM, ewm_alpha

        return EWM(self, ewm_alpha(com, span, halflife, alpha), adjust, ignore_na)

    def resample(self, rule, on=None):
        from cudf_tpu_torch.frame.resample import Resampler

        return Resampler(self, rule, on=on)

    def query(self, expr: str) -> "DataFrame":
        """The rows where the boolean expression holds (``frame/eval_expr.py``)."""
        return self._filter(self.eval(expr))

    def eval(self, expr: str):
        """A column expression over the frame's columns (``frame/eval_expr.py``)."""
        from cudf_tpu_torch.frame.eval_expr import evaluate

        return evaluate(self, expr)

    def hash_values(self, method: str = "murmur3", seed: int = 0) -> Series:
        """Each row's hash over every column (cudf's ``DataFrame.hash_values``)."""
        from cudf_tpu_torch.ops import hashing

        return Series._from(hashing.hash_values(list(self._table.columns), method, seed),
                            self._index, None)

    def diff(self, periods: int = 1) -> "DataFrame":
        return self._per_column(lambda s: s.diff(periods))

    def cumsum(self) -> "DataFrame":
        return self._per_column(lambda s: s.cumsum(), numeric_only=True)

    def cumprod(self) -> "DataFrame":
        return self._per_column(lambda s: s.cumprod(), numeric_only=True)

    def cummin(self) -> "DataFrame":
        return self._per_column(lambda s: s.cummin(), numeric_only=True)

    def cummax(self) -> "DataFrame":
        return self._per_column(lambda s: s.cummax(), numeric_only=True)

    def _binop(self, other, op: str, reflect: bool = False) -> "DataFrame":
        if isinstance(other, DataFrame):
            names = [n for n in self._table.names if n in other._table]
            return self._new(Table.from_pairs(names, [
                self[n]._binop(other[n], op, reflect)._column for n in names]))
        if isinstance(other, Series):
            return self._series_binop(other, op, reflect)
        return self._per_column(lambda s: s._binop(other, op, reflect))

    def _series_binop(self, other: Series, op: str, reflect: bool) -> "DataFrame":
        """pandas' broadcast of a Series over the columns: its labels align
        with the column names (the sorted union when they differ), each
        column meets its label's value (one host read of them); a column
        or label on one side only gives missing values (False for a
        comparison, True for ``!=``)."""
        names, labels = list(self._table.names), other._index.to_pylist()
        if labels == names:
            out_names = names
        else:
            union = names + [lb for lb in labels if lb not in names]
            try:
                out_names = sorted(union)
            except TypeError:
                out_names = union
        pos = other._index.get_indexer_for(
            Column.from_pylist(out_names, device=other.device), other.device)
        vals = copying.gather(other._column, pos, bounds_check=True).to_numpy().tolist()
        n, dev = len(self), self.device
        cols = []
        for name, v in zip(out_names, vals):
            if name in self._table and not is_null_scalar(v):
                cols.append(self[name]._binop(v, op, reflect)._column)
            elif op in ("eq", "ne", "lt", "gt", "le", "ge"):
                cols.append(Column.full(n, op == "ne", dt.BOOL8, device=dev))
            else:
                cols.append(Column.full(n, None, dt.FLOAT64, device=dev))
        return self._new(Table.from_pairs(out_names, cols))

    # ------------------------------------------------------------------
    # reductions
    # ------------------------------------------------------------------
    def _reduce(self, name: str, numeric_only: bool = False, **kw) -> Series:
        vals, names = [], []
        for n, c in self._table.items():
            if (numeric_only or name not in ("min", "max", "count", "nunique", "idxmin",
                                             "idxmax", "any", "all")) and \
                    not (c.dtype.is_numeric or c.dtype.is_bool):
                continue
            vals.append(getattr(Series._from(c, self._index, n), name)(**kw))
            names.append(n)
        dev = self.device
        return Series(vals, index=Index(Column.from_pylist(names, device=dev)), device=dev)

    def _row_reduce(self, name: str, ddof: int = 1) -> Series:
        """pandas' reduction of each row over the numeric and bool columns,
        missing values skipped: the columns stacked as float64 rows with
        NaN for a missing value, reduced along them on the device.  Integer
        and bool frames without nulls keep an integer sum, prod, min and
        max (bool for any and all); the rest are float64 (count int64)."""
        if name not in _ROW_REDUCTIONS:
            raise NotImplementedError(f"DataFrame.{name}(axis=1): {BEYOND}")
        cols = [c for c in self._table.columns if c.dtype.is_numeric or c.dtype.is_bool]
        n, dev = len(self), self.device
        exact = bool(cols) and all((c.dtype.is_integer or c.dtype.is_bool)
                                   and c.validity is None for c in cols)
        if exact and name in ("sum", "prod", "min", "max"):
            m = torch.stack([c.data.long() for c in cols], 1)
            out = {"sum": lambda: m.sum(1), "prod": lambda: m.prod(1),
                   "min": lambda: m.min(1).values, "max": lambda: m.max(1).values}[name]()
            target = dt.INT64
            if name in ("min", "max"):              # the columns' common dtype
                target = cols[0].dtype
                for c in cols[1:]:
                    target = dt.common_dtype(target, c.dtype)
            return Series._from(Column(target, n, out.to(target.torch_storage)), self._index)
        if not cols:
            m = torch.zeros((n, 0), dtype=torch.float64, device=dev)
        else:
            m = torch.stack([torch.where(materialize_validity(c), c.data.double(), float("nan"))
                             for c in cols], 1)
        ok = ~torch.isnan(m)
        cnt = ok.sum(1)
        if name in ("any", "all"):
            hit = (m != 0) & ok
            out = hit.any(1) if name == "any" else (hit | ~ok).all(1)
            return Series._from(Column(dt.BOOL8, n, out), self._index)
        if name == "count":
            return Series._from(Column(dt.INT64, n, cnt), self._index)
        total = torch.where(ok, m, 0.0).sum(1)
        if name == "sum":
            return Series._from(Column(dt.FLOAT64, n, total), self._index)
        if name == "prod":
            return Series._from(Column(dt.FLOAT64, n, torch.where(ok, m, 1.0).prod(1)),
                                self._index)
        if name in ("min", "max"):
            fill = float("inf") if name == "min" else float("-inf")
            filled = torch.where(ok, m, fill)
            out = filled.min(1).values if name == "min" else filled.max(1).values
            return Series._from(Column(dt.FLOAT64, n, out, maybe_mask(cnt > 0)), self._index)
        if name == "median":
            srt = torch.sort(torch.where(ok, m, float("inf")), 1).values
            lo = ((cnt - 1).clamp(min=0) // 2)[:, None]
            hi = (cnt // 2).clamp(max=max(m.shape[1] - 1, 0))[:, None]
            out = (srt.gather(1, lo) + srt.gather(1, hi)).squeeze(1) / 2 if m.shape[1] \
                else total
            return Series._from(Column(dt.FLOAT64, n, out, maybe_mask(cnt > 0)), self._index)
        mean = total / cnt.clamp(min=1)
        if name == "mean":
            return Series._from(Column(dt.FLOAT64, n, mean, maybe_mask(cnt > 0)), self._index)
        d = torch.where(ok, m - mean[:, None], 0.0)
        var = (d * d).sum(1) / (cnt - ddof).clamp(min=1)
        out = {"var": var, "std": torch.sqrt(var),
               "sem": torch.sqrt(var / cnt.clamp(min=1))}[name]
        return Series._from(Column(dt.FLOAT64, n, out, maybe_mask(cnt - ddof > 0)),
                            self._index)

    def quantile(self, q=0.5, numeric_only: bool = True):
        """Each numeric column's quantile: a Series named q, or for several
        q a frame indexed by them."""
        num = [n for n, c in self._table.items() if c.dtype.is_numeric]
        dev = self.device
        if not np.isscalar(q):
            qs = [float(x) for x in np.atleast_1d(q)]
            return DataFrame._from(Table({n: self[n].quantile(qs)._column for n in num}),
                                   Index(Column.from_pylist(qs, dt.FLOAT64, device=dev)))
        return Series([self[n].quantile(q) for n in num],
                      index=Index(Column.from_pylist(num, device=dev)), name=q, device=dev)

    def mode(self, axis=0, numeric_only: bool = False, dropna: bool = True) -> "DataFrame":
        """Each column's most frequent values, ascending, padded with nulls
        to the longest column's count."""
        if axis not in (0, "index"):
            raise NotImplementedError(f"mode(axis={axis!r}): {BEYOND}")
        modes = {n: Series._from(c, self._index, n).mode(dropna)._column
                 for n, c in self._table.items()
                 if not numeric_only or c.dtype.is_numeric or c.dtype.is_bool}
        width = max((m.length for m in modes.values()), default=0)
        dev = self.device
        cols = {n: m if m.length == width else
                copying.concatenate([m, Column.full(width - m.length, None, m.dtype, device=dev)])
                for n, m in modes.items()}
        return DataFrame._from(Table(cols), default_index(width))

    def rank(self, method: str = "average", ascending: bool = True, pct: bool = False,
             numeric_only: bool = False, na_option: str = "keep") -> "DataFrame":
        """Each numeric, bool and temporal column's ranks (``Series.rank``);
        the other columns are left out, as in the reference."""
        cols = {n: Series._from(c, self._index, n).rank(method=method, ascending=ascending,
                                                         na_option=na_option, pct=pct)._column
                for n, c in self._table.items()
                if c.dtype.is_numeric or c.dtype.is_bool or c.dtype.is_temporal}
        return self._new(Table(cols))

    def _numeric_names(self) -> list:
        return [n for n, c in self._table.items() if c.dtype.is_numeric]

    def agg(self, func, axis=0):
        """A name: each column's reduction (a Series over the columns); a
        list: a frame of the names by the numeric and bool columns; a
        dict {column: name or [names]}: a Series over the columns when
        every value is a name, else a frame of the names (in order of first
        appearance) by the columns, NaN where a name was not asked.  With
        ``axis=1`` a name reduces each row (a list: a frame of one column
        a name)."""
        dev = self.device
        if axis in (1, "columns"):
            if isinstance(func, str):
                return getattr(self, func)(axis=1)
            if isinstance(func, (list, tuple)):
                return DataFrame._from(Table({f: getattr(self, f)(axis=1)._column
                                              for f in func}), self._index)
            raise NotImplementedError(f"DataFrame.agg({type(func).__name__}, axis=1): "
                                      f"{BEYOND}")
        if isinstance(func, str):
            return getattr(self, func)()
        if isinstance(func, (list, tuple)):
            names = [n for n, c in self._table.items() if c.dtype.is_numeric or c.dtype.is_bool]
            return DataFrame({n: Series([self[n].agg(f) for f in func], device=dev)._column
                              for n in names}, index=list(func), device=dev)
        if isinstance(func, dict):
            if all(isinstance(f, str) for f in func.values()):
                return Series([self[n].agg(f) for n, f in func.items()], index=list(func),
                              device=dev)
            rows = []
            for f in func.values():
                for a in ([f] if isinstance(f, str) else f):
                    if a not in rows:
                        rows.append(a)
            data = {}
            for n, f in func.items():
                asked = [f] if isinstance(f, str) else list(f)
                data[n] = Series([float(self[n].agg(a)) if a in asked else None
                                  for a in rows], dtype="float64", device=dev)._column
            return DataFrame(data, index=rows, device=dev)
        return func(self)

    aggregate = agg

    def transform(self, func, *args, **kwargs) -> "DataFrame":
        """Each column's transform (``Series.transform``), the frame's rows
        and index kept."""
        return self._new(Table.from_pairs(self._table.names, [
            self[n].transform(func, *args, **kwargs)._column for n in self._table.names]))

    def pipe(self, func, *args, **kwargs):
        """func(self, ...); a (func, keyword) pair passes self as that
        keyword."""
        if isinstance(func, tuple):
            func, target = func
            kwargs[target] = self
            return func(*args, **kwargs)
        return func(self, *args, **kwargs)

    def describe(self) -> "DataFrame":
        """pandas' count, mean, std, min, quartiles and max of each numeric
        column, float64."""
        dev = self.device
        return DataFrame({n: self[n].describe()._column for n in self._numeric_names()},
                         index=["count", "mean", "std", "min", "25%", "50%", "75%", "max"],
                         device=dev)

    def _pairwise(self, fn) -> "DataFrame":
        names = self._numeric_names()
        k = len(names)
        out = np.full((k, k), np.nan)
        for i in range(k):
            for j in range(i, k):
                out[i, j] = out[j, i] = fn(self[names[i]], self[names[j]])
        dev = self.device
        return DataFrame({n: tracing.synced("host_values", dev, torch.tensor, out[:, i],
                                            dtype=torch.float64, device=dev)
                          for i, n in enumerate(names)}, index=list(names), device=dev)

    @tracing.annotate("DataFrame.corr")
    def corr(self, method: str = "pearson", min_periods: int = 1) -> "DataFrame":
        """Pearson correlations of the numeric columns, each pair over the
        rows where both are present."""
        return self._pairwise(lambda a, b: a.corr(b, method, min_periods))

    def cov(self, min_periods=None, ddof: int = 1) -> "DataFrame":
        """Covariances of the numeric columns, each pair over the rows where
        both are present."""
        return self._pairwise(lambda a, b: a.cov(b, min_periods, ddof))

    def nlargest(self, n: int, columns, keep: str = "first") -> "DataFrame":
        return self._nselect(n, columns, largest=True)

    def nsmallest(self, n: int, columns, keep: str = "first") -> "DataFrame":
        return self._nselect(n, columns, largest=False)

    def _nselect(self, n: int, columns, largest: bool) -> "DataFrame":
        cols = _names_of(columns)
        for c in cols:
            d = self._table[c].dtype
            if d.is_string or d.is_dictionary:
                raise TypeError(f"Column {c!r} has dtype {d!r}, cannot use method "
                                f"{'nlargest' if largest else 'nsmallest'!r} with this dtype")
        return self.sort_values(cols, ascending=not largest).head(max(int(n), 0))

    def duplicated(self, subset=None, keep="first") -> Series:
        names = _names_of(subset) if subset is not None else list(self._table.names)
        mask = sc.duplicated_mask([self._table[n] for n in names],
                                  keep if keep is not False else "none")
        return Series._from(Column(dt.BOOL8, len(self), mask), self._index, None)

    def value_counts(self, subset=None, normalize: bool = False, sort: bool = True,
                     ascending: bool = False, dropna: bool = True) -> Series:
        names = _names_of(subset) if subset is not None else list(self._table.names)
        out = self.groupby(names if len(names) > 1 else names[0], dropna=dropna,
                           sort=False).size()
        if normalize:
            out = out / len(self)
        if sort:
            out = out.sort_values(ascending=ascending)
        out.name = "proportion" if normalize else "count"
        return out

    def equals(self, other) -> bool:
        if not isinstance(other, DataFrame) or self._table.names != other._table.names \
                or len(self) != len(other):
            return False
        return all(self[n].equals(other[n]) for n in self._table.names)

    # ------------------------------------------------------------------
    # sorting, dedup, joins, groups
    # ------------------------------------------------------------------
    @tracing.annotate("DataFrame.sort_values")
    def sort_values(self, by, ascending=True, na_position: str = "last",
                    ignore_index: bool = False, kind=None) -> "DataFrame":
        """A stable lexicographic sort by the named columns (any ``kind``
        gives the stable order); NaN sorts as null, at ``na_position``
        whatever the direction."""
        by = _names_of(by)
        asc = [ascending] * len(by) if isinstance(ascending, bool) else list(ascending)
        keys = [nans_to_nulls(self._table[name]) for name in by]
        out = self.take(sort_ops.sorted_order(keys, asc, na_position))
        if ignore_index:
            out._index = default_index(len(out))
        return out

    def sort_index(self, ascending: bool = True) -> "DataFrame":
        idx = self._index
        cols = list(idx._columns) if isinstance(idx, MultiIndex) else [idx.column(self.device)]
        return self.take(sort_ops.sorted_order(cols, [ascending] * len(cols), "last"))

    def drop_duplicates(self, subset=None, keep="first",
                        ignore_index: bool = False) -> "DataFrame":
        """The first (last; none when keep=False) row of each distinct
        combination of the subset's values, in row order."""
        names = _names_of(subset) if subset is not None else list(self._table.names)
        out = self.take(sc.distinct_indices([self._table[n] for n in names],
                                            keep if keep is not False else "none"))
        if ignore_index:
            out._index = default_index(len(out))
        return out

    @tracing.annotate("DataFrame.merge")
    def merge(self, right, on=None, how="inner", left_on=None, right_on=None,
              left_index=False, right_index=False, suffixes=("_x", "_y"), sort=False):
        """Join with ``right`` (see ``frame/join.py``): inner, left,
        right, outer, cross, semi and anti, on columns or both indexes."""
        from cudf_tpu_torch.frame.join import merge as _merge

        return _merge(self, right, on=on, how=how, left_on=left_on, right_on=right_on,
                      left_index=left_index, right_index=right_index,
                      suffixes=suffixes, sort=sort)

    def join(self, other, on=None, how: str = "left", lsuffix: str = "", rsuffix: str = "",
             sort: bool = False) -> "DataFrame":
        """pandas' join: the ``on`` column (or the index) against ``other``'s
        index (see ``frame/join.py`` ``join``)."""
        from cudf_tpu_torch.frame.join import join as _join

        return _join(self, other, on=on, how=how, lsuffix=lsuffix, rsuffix=rsuffix, sort=sort)

    def combine_first(self, other: "DataFrame") -> "DataFrame":
        """Each missing value from ``other`` at the same label and column
        (``Series.combine_first``), over the union of the two indexes (sorted
        when they differ) and of the columns (self's, then other's new
        ones), as pandas gives it."""
        index = self._index if self._index.equals(other._index) else \
            self._index.union(other._index)
        names = list(self._table.names) + [n for n in other._table.names
                                           if n not in self._table]
        dev = self.device
        labels = index.column(dev)

        def at(df: "DataFrame", n) -> Column:
            col = df._table[n]
            if df._index.equals(index):
                return col
            return copying.gather(col, df._index.get_indexer_for(labels, dev),
                                  bounds_check=True)

        cols = {}
        for n in names:
            if n in self._table and n in other._table:
                a, b = nans_to_nulls(at(self, n)), at(other, n)
                if a.dtype != b.dtype and a.dtype.is_numeric and b.dtype.is_numeric:
                    target = dt.common_dtype(a.dtype, b.dtype)     # as pandas promotes
                    a, b = unary.cast(a, target), unary.cast(b, target)
                cols[n] = replace_ops.replace_nulls_column(a, b)
            else:
                cols[n] = at(self if n in self._table else other, n)
        return DataFrame._from(Table(cols), index)

    def apply(self, func, axis=0, args=(), engine=None, masked: bool = False, **kwargs):
        """``axis=0``: func of each column (a Series over the column names
        when every result is a scalar, else a frame of the results).
        ``axis=1``: func of each row; ``engine="torch"`` vmaps it over a
        dict of the numeric and bool columns' tensors on their device
        (``masked=True``: ``Masked`` fields), else it loops over the rows on
        the host, each row a dict {column: value} built from each column's
        values.  ``frame/series.py`` ``UDF_ROUTES`` counts the route."""
        fn = (lambda x: func(x, *args, **kwargs)) if args or kwargs else func
        if axis in (0, "index"):
            out = {n: fn(self[n]) for n in self._table.names}
            if all(_scalar(v) for v in out.values()):
                return Series(list(out.values()), index=list(out), device=self.device)
            return DataFrame({n: v for n, v in out.items()})
        if engine == "torch":
            from cudf_tpu_torch.utils.masked import Masked

            cols = {n: c for n, c in self._table.items() if c.dtype.is_numeric
                    or c.dtype.is_bool}
            arg = {n: (Masked(c.data, materialize_validity(c)) if masked else c.data)
                   for n, c in cols.items()}
            res = vmap_udf(fn, arg, self.device)
            if res is not None:
                UDF_ROUTES["vmap"] += 1
                return Series._from(udf_column(res, len(self)), self._index)
        elif engine is not None:
            raise ValueError(f"engine={engine!r}: 'torch' or None")
        UDF_ROUTES["host"] += 1
        names = list(self._table.names)
        columns = [c.to_numpy().tolist() for c in self._table.columns]
        vals = [fn(dict(zip(names, row))) for row in zip(*columns)]
        return Series(vals, index=self._index, device=self.device)

    def pivot_table(self, values=None, index=None, columns=None, aggfunc="mean",
                    fill_value=None) -> "DataFrame":
        from cudf_tpu_torch.frame.reshape import pivot_table

        return pivot_table(self, values=values, index=index, columns=columns, aggfunc=aggfunc,
                           fill_value=fill_value)

    def pivot(self, index=None, columns=None, values=None) -> "DataFrame":
        from cudf_tpu_torch.frame.reshape import pivot

        return pivot(self, index=index, columns=columns, values=values)

    def explode(self, column, ignore_index: bool = False) -> "DataFrame":
        """One row an element of the LIST column ``column`` (an empty or
        null list one null row), the other columns and the labels
        repeated by row (``ops/lists.py`` ``explode(outer=True)``)."""
        col = self._table[column]
        if not col.dtype.is_list:
            return self.copy()
        from cudf_tpu_torch.ops import lists

        child, rows = lists.explode(col, outer=True)
        cols = {n: child if n == column else copying.gather(c, rows, bounds_check=False)
                for n, c in self._table.items()}
        index = default_index(child.length) if ignore_index else self._index.take(rows)
        return DataFrame._from(Table(cols), index)

    def melt(self, id_vars=None, value_vars=None, var_name=None,
             value_name="value") -> "DataFrame":
        from cudf_tpu_torch.frame.reshape import melt

        return melt(self, id_vars=id_vars, value_vars=value_vars, var_name=var_name,
                    value_name=value_name)

    def stack(self, level=-1, dropna: bool = False) -> Series:
        """The columns moved into a last index level: a Series under a
        MultiIndex of (the index, the column names), row by row, for a
        numeric or bool frame (an interleave on the device); other frames
        take pandas on the host in the reference and raise here.  The
        columns have one level, so ``level`` is -1 or 0.  Missing values
        stay, as in pandas 3 (the reference ignores ``dropna``);
        ``dropna=True`` drops them, as pandas' legacy stack did."""
        from cudf_tpu_torch.frame.reshape import stack

        if level not in (-1, 0):
            raise IndexError(f"stack(level={level!r}): the columns have one level")
        out = stack(self)
        return out.dropna() if dropna else out

    def unstack(self, level=-1, fill_value=None) -> "DataFrame":
        from cudf_tpu_torch.frame.reshape import unstack

        return unstack(self, level=level, fill_value=fill_value)

    def transpose(self) -> "DataFrame":
        from cudf_tpu_torch.frame.reshape import transpose

        return transpose(self)

    @property
    def T(self) -> "DataFrame":
        return self.transpose()

    @tracing.annotate("DataFrame.groupby")
    def groupby(self, by=None, level=None, sort: bool = True, dropna: bool = True,
                as_index: bool = True, group_keys: bool = True, observed: bool = True):
        """Group by key columns, Series, or index levels (see
        ``frame/groupby.py``).  ``group_keys`` is accepted as the reference
        accepts it: no method of the port's groupby reads it."""
        from cudf_tpu_torch.frame.groupby import DataFrameGroupBy

        return DataFrameGroupBy(self, by, level=level, sort=sort, dropna=dropna,
                                as_index=as_index, observed=observed)


def _columns_of_rows(rows: list, columns=None) -> Dict:
    """{column: values} of rows given as dicts (the columns in order of
    first appearance, a value a row lacks missing) or as sequences
    (columns 0..k-1, a short row's last values missing); ``columns``
    names or picks them."""
    if rows and all(isinstance(r, dict) for r in rows):
        names = list(columns) if columns is not None else \
            list(dict.fromkeys(k for r in rows for k in r))
        return {n: [r.get(n) for r in rows] for n in names}
    width = max((len(r) for r in rows), default=0)
    names = list(columns) if columns is not None else list(range(width))
    return {n: [r[j] if j < len(r) else None for r in rows] for j, n in enumerate(names)}


def _shift_index(index: Index, periods: int, freq) -> Index:
    """A temporal index moved by ``periods`` steps of the fixed frequency
    ``freq`` (an alias such as "2h", or a timedelta), on its device."""
    import re

    from cudf_tpu_torch.frame.tools import _FIXED, _NS_PER

    col = index.column(index.device)
    if isinstance(index, MultiIndex) or not col.dtype.is_temporal:
        raise NotImplementedError("shift(freq=...) of an index that is not temporal")
    unit = col.dtype.time_unit
    if isinstance(freq, str):
        m = re.fullmatch(r"(\d*)([A-Za-z]+)", freq)
        if m is None or m.group(2) not in _FIXED:
            raise NotImplementedError(f"shift(freq={freq!r}): fixed frequencies; "
                                      f"calendar ones are {BEYOND}")
        funit, per = _FIXED[m.group(2)]
        ns = int(m.group(1) or 1) * per * _NS_PER[funit]
    else:
        ns = int(np.timedelta64(freq, "ns").astype(np.int64))
    per_tick = _NS_PER.get(unit, 86400 * 10 ** 9)          # "D": day ticks
    if (ns * periods) % per_tick:
        raise NotImplementedError(f"shift(freq={freq!r}) finer than the index's unit {unit}")
    data = col.data + ns * periods // per_tick
    return Index(Column(col.dtype, col.length, data, col.validity), index.name)


def _reduction(name: str):
    def method(self, axis=0, numeric_only: bool = False, **kw):
        if axis in (1, "columns"):
            return self._row_reduce(name, **kw)
        return self._reduce(name, numeric_only, **kw)
    method.__name__ = name
    method.__doc__ = f"pandas' {name} of each column (axis=0) or row (axis=1), as a Series"
    return method


def _spread(name: str):
    def method(self, axis=0, ddof: int = 1, numeric_only: bool = False, **kw):
        if axis in (1, "columns"):
            return self._row_reduce(name, ddof=ddof, **kw)
        return self._reduce(name, numeric_only, ddof=ddof, **kw)
    method.__name__ = name
    method.__doc__ = (f"pandas' {name} (``ddof`` degrees of freedom) of each column "
                      "(axis=0) or row (axis=1), as a Series")
    return method


for _name in ("sum", "prod", "mean", "min", "max", "median", "count", "nunique", "any",
              "all", "idxmin", "idxmax", "skew", "kurtosis", "sem"):
    setattr(DataFrame, _name, _reduction(_name))
for _name in ("std", "var"):
    setattr(DataFrame, _name, _spread(_name))

for _name, _item in _NOT_PORTED.items():
    setattr(DataFrame, _name, not_ported(_name, _item))

for _dunder, _op in (("__add__", "add"), ("__sub__", "sub"), ("__mul__", "mul"),
                     ("__truediv__", "truediv"), ("__floordiv__", "floordiv"),
                     ("__mod__", "mod"), ("__pow__", "pow"), ("__eq__", "eq"),
                     ("__ne__", "ne"), ("__lt__", "lt"), ("__gt__", "gt"), ("__le__", "le"),
                     ("__ge__", "ge"), ("__and__", "bitand"), ("__or__", "bitor"),
                     ("__xor__", "bitxor")):
    def _mk(op=_op):
        def f(self, other):
            return self._binop(other, op)
        return f

    def _mk_r(op=_op):
        def f(self, other):
            return self._binop(other, op, reflect=True)
        return f
    setattr(DataFrame, _dunder, _mk())
    if _op not in ("eq", "ne", "lt", "gt", "le", "ge"):
        setattr(DataFrame, "__r" + _dunder[2:], _mk_r())


class _DataFrameILoc:
    def __init__(self, df: DataFrame):
        self._df = df

    @tracing.annotate("DataFrame.iloc")
    def __getitem__(self, key):
        df = self._df
        if isinstance(key, tuple):
            rows, cols = key
            names = list(df._table.names)
            if isinstance(cols, (int, np.integer)):
                if isinstance(rows, (int, np.integer)):
                    return copying.get_element(df._table.column(int(cols)), int(rows))
                return df[names[cols]].iloc[rows]
            sel = names[cols] if isinstance(cols, slice) else [names[c] for c in cols]
            return df[sel].iloc[rows]
        if isinstance(key, (int, np.integer)):
            i = int(key) + (len(df) if key < 0 else 0)
            return _row(df, i, df._index[i])
        if isinstance(key, slice):
            start, stop, step = key.indices(len(df))
            if step == 1:
                return df._slice(start, stop)
            return df.take(torch.arange(start, stop, step, device=df.device))
        if _bool_array(key):
            return df._filter(Series._from(column_of(key, df.device), df._index))
        return df.take(key)

    def __setitem__(self, key, value):
        df = self._df
        if not isinstance(key, tuple):
            raise NotImplementedError(f"iloc setitem of whole rows: {BEYOND}")
        rows, col = key
        name = list(df._table.names)[col] if isinstance(col, (int, np.integer)) else col
        s = df[name]
        s.iloc[rows] = value
        df[name] = s


class _DataFrameLoc:
    def __init__(self, df: DataFrame):
        self._df = df

    @tracing.annotate("DataFrame.loc")
    def __getitem__(self, key):
        df = self._df
        if isinstance(key, tuple):
            rows, cols = key
            if np.isscalar(rows) and not isinstance(cols, (list, tuple, slice)):
                return df[cols].loc[rows]
            sub = df.loc[rows]
            if not isinstance(sub, DataFrame):
                return sub[cols] if not isinstance(cols, slice) else sub
            if isinstance(cols, slice):
                names = list(df._table.names)
                s = names.index(cols.start) if cols.start is not None else 0
                e = names.index(cols.stop) + 1 if cols.stop is not None else len(names)
                return sub[names[s:e]]
            return sub[cols] if not isinstance(cols, (list, tuple)) else sub[list(cols)]
        if isinstance(key, Series) and key.dtype.is_bool:
            return df._filter(key)
        if isinstance(key, slice):
            if key.start is None and key.stop is None:
                return df._new(df._table)
            start = 0 if key.start is None else df._index.get_loc(key.start)
            stop = len(df) - 1 if key.stop is None else df._index.get_loc(key.stop)
            return df._slice(int(start), int(stop) + 1)
        if np.isscalar(key):
            pos = df._index._positions_of(key, df.device)
            if pos.shape[0] == 0:
                raise KeyError(key)
            if pos.shape[0] == 1:
                return _row(df, tracing.to_int(pos[0], "label_lookup"), key)
            return df.take(pos)
        if _is_listlike(key) and _bool_array(key):
            return df._filter(Series._from(column_of(key, df.device), df._index))
        pos = df._index.get_indexer_for(key, df.device)
        if tracing.to_bool((pos < 0).any(), "label_lookup"):
            raise KeyError(f"labels not in the index: "
                           f"{np.asarray(key)[(pos < 0).cpu().numpy()]}")
        return df.take(pos)

    def __setitem__(self, key, value):
        df = self._df
        if not isinstance(key, tuple):
            raise NotImplementedError(f"loc setitem of whole rows: {BEYOND}")
        rows, col = key
        if col in df._table:
            s = df[col]
        else:
            s = Series._from(Column.full(len(df), None, dt.FLOAT64, device=df.device),
                             df._index, col)
        s.loc[rows] = value
        df[col] = s


def _row(df: DataFrame, i: int, label) -> Series:
    """Row i as a Series over the column names (values of mixed columns
    in their common dtype, strings as strings)."""
    vals = [copying.get_element(c, i) for c in df._table.columns]
    return Series(vals, index=Index(Column.from_pylist(list(df._table.names),
                                                       device=df.device)),
                  name=label, device=df.device)
