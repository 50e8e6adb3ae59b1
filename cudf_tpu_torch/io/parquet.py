"""Parquet reader and writer entry points (port of ``cudf_tpu/io/parquet.py``).

``read_parquet`` takes the native tier (``parquet_native.py``: host
footer and decompression, device decode) for every file shape it
supports, and the pyarrow tier only for the shapes it declares
unsupported (``UnsupportedParquet``: an encoding, codec or page type it
lacks, FIXED_LEN_BYTE_ARRAY wider than 8 bytes, pandas extension
metadata, a pyarrow Expression filter); any other error propagates.
``write_parquet`` takes the native writer for numeric, bool, string,
dictionary, temporal, list and struct columns, pyarrow for the rest
(decimals) and for a non-default index.  ``IO_ROUTES``
(``io/__init__.py``) counts the reads and writes of each tier; a GPU
machine without pyarrow needs ``IO_ROUTES["pyarrow"]`` at 0.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

from cudf_tpu_torch.core.table import Table
from cudf_tpu_torch.io import IO_ROUTES, thrift
from cudf_tpu_torch.io.parquet_native import UnsupportedParquet


def _frame(table: Table):
    from cudf_tpu_torch.frame.dataframe import DataFrame
    from cudf_tpu_torch.frame.index import default_index

    return DataFrame._from(table, default_index(table.num_rows))


def _and_list(filters):
    """An AND-list of (column, op, value), or None (a DNF of several
    conjunctions, or none): the part of ``filters`` that prunes."""
    if filters and isinstance(filters[0], list):
        filters = filters[0] if len(filters) == 1 else None
    return filters if filters and isinstance(filters[0], tuple) else None


def read_parquet(path, columns: Optional[Sequence[str]] = None, filters=None,
                 row_groups: Optional[Sequence[int]] = None, *, device="cuda", **kw):
    """A DataFrame on ``device``.  filters: (column, op, value) tuples, an
    AND-list, or a DNF (a list of AND-lists, any of which keeps a row).
    An AND-list prunes row groups and pages by the file's metadata; then
    the exact predicate applies."""
    df, pruned = _read_parquet_pruned(path, columns, filters, row_groups, device, **kw)
    return _apply_residual_filters(df, filters) if pruned else df


def _read_parquet_pruned(path, columns, filters, row_groups=None, device="cuda", **kw):
    """(frame, pruned): the native tier's read, whose rows ``filters`` has
    only pruned by the file's metadata (``pruned`` is then True), or the
    pyarrow tier's exactly filtered read.  The engine's Scan, which
    applies its whole predicate after the read, takes it as it is."""
    if isinstance(path, (str, os.PathLike)) and not kw:
        path = os.fspath(path)
        try:
            if hasattr(filters, "equals"):
                raise UnsupportedParquet("a pyarrow Expression filter")
            if _has_pandas_ext_metadata(path):
                raise UnsupportedParquet("pandas extension metadata")
            from cudf_tpu_torch.io.parquet_native import read_parquet_native

            t = read_parquet_native(path, list(columns) if columns else None,
                                    _and_list(filters),
                                    list(row_groups) if row_groups is not None else None,
                                    device=device)
            IO_ROUTES["native"] += 1
            return _frame(t), _residual(filters)
        except UnsupportedParquet:
            pass
    IO_ROUTES["pyarrow"] += 1
    import pyarrow.parquet as pq

    f = pq.ParquetFile(path)
    cols = list(columns) if columns else None
    if row_groups is not None:
        tbl = f.read_row_groups(list(row_groups), columns=cols)
        return _frame(Table.from_arrow(tbl, device=device)), _residual(filters)
    if filters is not None:
        import pyarrow.dataset as ds

        tbl = ds.dataset(path, format="parquet").to_table(
            columns=cols, filter=_filters_to_expression(filters))
    else:
        tbl = f.read(columns=cols)
    return _frame(Table.from_arrow(tbl, device=device)), False


def _residual(filters) -> bool:
    """Whether ``filters`` (tuples, not a pyarrow Expression) leaves an
    exact predicate to apply after a read that only pruned."""
    return filters is not None and not hasattr(filters, "equals") and len(filters) > 0


def _has_pandas_ext_metadata(path: str) -> bool:
    """A file whose pandas metadata names categoricals, tz-aware
    timestamps, object or pandas-nullable columns needs pyarrow's
    metadata-aware rebuild."""
    md = thrift.read_file_metadata(path)
    for k, v in md.key_value or []:
        if k == b"pandas" and (b'"pandas_type": "categorical"' in v or b"datetimetz" in v
                               or b'"numpy_type": "object"' in v or b"Int64" in v
                               or b"Float64" in v or b"boolean" in v):
            return True
    return False


def _apply_residual_filters(df, filters):
    """The exact row filter after row-group and page pruning: an AND-list,
    or the OR of a DNF's AND-lists.  A null compares as pyarrow's filter
    compares it: no comparison keeps it, ``not in`` does."""
    import operator

    ops = {"=": operator.eq, "==": operator.eq, "!=": operator.ne, "<": operator.lt,
           ">": operator.gt, "<=": operator.le, ">=": operator.ge}
    conjunctions = [filters] if isinstance(filters[0], tuple) else filters
    keep = None
    for conj in conjunctions:
        mask = None
        for col, op, val in conj:
            if op == "in":
                m = df[col].isin(val)
            elif op == "not in":
                m = ~df[col].isin(val)
            else:
                m = ops[op](df[col], val) & _valid(df[col])
            mask = m if mask is None else (mask & m)
        if mask is not None:
            keep = mask if keep is None else (keep | mask)
    return df[keep].reset_index(drop=True) if keep is not None else df


def _valid(s):
    """The rows of Series ``s`` that hold a value (a NaN is a value, as in
    pyarrow)."""
    import torch

    from cudf_tpu_torch.core import dtypes as dt
    from cudf_tpu_torch.core.column import Column

    c = s._column
    v = c.validity if c.validity is not None else torch.ones(c.length, dtype=torch.bool,
                                                             device=c.device)
    return s._new(Column(dt.BOOL8, c.length, v))


def _filters_to_expression(filters):
    import operator

    import pyarrow.dataset as ds

    if hasattr(filters, "equals"):
        return filters
    if filters and isinstance(filters[0], tuple):
        filters = [filters]
    ops = {"=": operator.eq, "==": operator.eq, "!=": operator.ne, "<": operator.lt,
           ">": operator.gt, "<=": operator.le, ">=": operator.ge}
    disjunction = None
    for conj in filters:
        expr = None
        for col, op, val in conj:
            field = ds.field(col)
            if op == "in":
                e = field.isin(val)
            elif op == "not in":
                e = ~field.isin(val)
            else:
                e = ops[op](field, val)
            expr = e if expr is None else (expr & e)
        disjunction = expr if disjunction is None else (disjunction | expr)
    return disjunction


_NATIVE_WRITER_OPTIONS = ("row_group_size", "use_dictionary", "data_page_version",
                          "data_page_rows", "write_page_index", "bloom_filter_columns",
                          "use_delta_binary")


def _native_writable(table: Table) -> bool:
    def ok(c):
        d = c.dtype
        if d.is_list:
            return not c.children[0].dtype.is_nested and ok(c.children[0])
        if d.is_struct:
            return all(not ch.dtype.is_nested and ok(ch) for ch in c.children)
        return d.is_numeric or d.is_bool or d.is_string or d.is_dictionary or d.is_temporal
    return all(ok(c) for c in table.columns)


def write_parquet(df, path, compression="snappy", index=None, **kw):
    from cudf_tpu_torch.io.parquet_writer import _CODECS, write_parquet_native

    comp = (compression or "uncompressed").lower()
    if (index is False or (index is None and _is_default_index(df))) and comp in _CODECS \
            and _native_writable(df._table):
        write_parquet_native(df._table, os.fspath(path), compression=comp,
                             **{k: v for k, v in kw.items() if k in _NATIVE_WRITER_OPTIONS})
        IO_ROUTES["native"] += 1
        return
    IO_ROUTES["pyarrow"] += 1
    import pyarrow.parquet as pq

    tbl = df._table.to_arrow()
    if index or (index is None and not _is_default_index(df)):
        idx_name = df.index.name or "__index_level_0__"
        tbl = tbl.append_column(idx_name, df.index._column.to_arrow())
    pq.write_table(tbl, path, compression=compression)


def _is_default_index(df) -> bool:
    from cudf_tpu_torch.frame.index import RangeIndex

    idx = df.index
    return isinstance(idx, RangeIndex) and idx.start == 0 and idx.step == 1


class ParquetReader:
    """Chunked reads (libcudf's chunked reader, reader_impl_chunking.cu):
    row groups batched under a byte budget, through the native tier."""

    def __init__(self, path, columns=None, chunk_read_limit: int = 0, *, device="cuda"):
        self._path = os.fspath(path)
        self._md = thrift.read_file_metadata(self._path)
        self._columns = list(columns) if columns else None
        self._limit = chunk_read_limit
        self._device = device
        self._rg = 0

    @property
    def num_row_groups(self) -> int:
        return len(self._md.row_groups)

    def has_next(self) -> bool:
        return self._rg < self.num_row_groups

    def read_chunk(self):
        groups = [self._rg]
        size = self._md.row_groups[self._rg].total_byte_size
        self._rg += 1
        while self._limit and self._rg < self.num_row_groups:
            nxt = self._md.row_groups[self._rg].total_byte_size
            if size + nxt > self._limit:
                break
            groups.append(self._rg)
            size += nxt
            self._rg += 1
        return read_parquet(self._path, self._columns, row_groups=groups, device=self._device)

    def __iter__(self):
        while self.has_next():
            yield self.read_chunk()


class ParquetWriter:
    """Chunked writes (ChunkedParquetWriter): the frames written are kept
    and go to the file as one table at ``close``."""

    def __init__(self, path, compression="snappy"):
        self._path = path
        self._compression = compression
        self._frames: List = []

    def write_table(self, df):
        self._frames.append(df)

    def close(self):
        if self._frames:
            from cudf_tpu_torch.frame.reshape import concat

            df = concat(self._frames, ignore_index=True) if len(self._frames) > 1 \
                else self._frames[0]
            write_parquet(df, self._path, compression=self._compression, index=False)
            self._frames = []

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def read_parquet_metadata(path) -> thrift.FileMetaData:
    """The file's footer: schema, row groups and their column chunks."""
    return thrift.read_file_metadata(os.fspath(path))
