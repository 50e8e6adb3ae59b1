"""CSV reader and writer (port of ``cudf_tpu/io/csv.py``).

``read_csv`` takes the device tokenizer (``csv_device.py``) for the
plain shape: a one-byte delimiter, the header inferred, no ``names``,
``skiprows``, ``nrows``, ``na_values`` or ``parse_dates``, and rows of
one width (else ``RaggedCsv``).  The rest goes to pyarrow's host parser,
counted in ``IO_ROUTES``; any other error of the device tier propagates.
``write_csv`` writes through pandas' ``to_csv``, as the reference does: a
host route, counted in ``ops/_utils.HOST_ROUTES``.  The option
``io.csv.device_tokenizer`` off sends every read to pyarrow.
"""

from __future__ import annotations

import io as _io
from typing import Optional, Sequence

from cudf_tpu_torch.core.table import Table
from cudf_tpu_torch.io import IO_ROUTES
from cudf_tpu_torch.utils.config import get_option


def _frame(t: Table):
    from cudf_tpu_torch.frame.dataframe import DataFrame
    from cudf_tpu_torch.frame.index import default_index

    return DataFrame._from(t, default_index(t.num_rows))


def read_csv(filepath_or_buffer, sep: str = ",", delimiter: Optional[str] = None,
             header="infer", names: Optional[Sequence[str]] = None,
             usecols: Optional[Sequence[str]] = None, dtype=None, skiprows: int = 0,
             nrows: Optional[int] = None, na_values=None, parse_dates=None, *,
             device="cuda", **kw):
    """A DataFrame on ``device``.  dtype: one dtype for every column, or a
    {column: dtype} dict ("category" makes a DICTIONARY column)."""
    sep = delimiter or sep
    if get_option("io.csv.device_tokenizer") and len(sep) == 1 and names is None \
            and header == "infer" and skiprows == 0 and nrows is None and na_values is None \
            and not parse_dates and not kw:
        from cudf_tpu_torch.io.csv_device import RaggedCsv, read_csv_device

        src = filepath_or_buffer.read() if hasattr(filepath_or_buffer, "read") \
            else filepath_or_buffer
        if isinstance(src, str) and "\n" in src:
            src = src.encode()
        try:
            t = read_csv_device(src, delimiter=sep, header=True,
                                usecols=list(usecols) if usecols else None,
                                dtypes=dtype if isinstance(dtype, dict) else None,
                                device=device)
        except RaggedCsv:
            filepath_or_buffer = src
        else:
            IO_ROUTES["native"] += 1
            df = _frame(t)
            return df.astype(dtype) if dtype is not None and not isinstance(dtype, dict) \
                else df
    return _read_csv_pyarrow(filepath_or_buffer, sep, header, names, usecols, dtype,
                             skiprows, nrows, na_values, parse_dates, device)


def _read_csv_pyarrow(src, sep, header, names, usecols, dtype, skiprows, nrows, na_values,
                      parse_dates, device):
    IO_ROUTES["pyarrow"] += 1
    import numpy as np
    import pyarrow as pa
    import pyarrow.csv as pacsv

    read_opts = pacsv.ReadOptions(skip_rows=skiprows)
    if names is not None:
        read_opts.column_names = list(names)
        read_opts.autogenerate_column_names = False
    elif header is None:
        read_opts.autogenerate_column_names = True
    conv = {}
    if isinstance(dtype, dict):
        conv = {k: pa.from_numpy_dtype(np.dtype(v)) for k, v in dtype.items()
                if str(v) not in ("str", "object", "category")}
    convert_opts = pacsv.ConvertOptions(
        column_types=conv or None, null_values=list(na_values) if na_values else None,
        include_columns=list(usecols) if usecols else None, strings_can_be_null=True)
    if isinstance(src, str) and "\n" in src:
        src = _io.BytesIO(src.encode())
    elif isinstance(src, (bytes, bytearray)):
        src = _io.BytesIO(src)
    elif hasattr(src, "read"):
        data = src.read()
        src = _io.BytesIO(data.encode() if isinstance(data, str) else data)
    tbl = pacsv.read_csv(src, read_options=read_opts,
                         parse_options=pacsv.ParseOptions(delimiter=sep),
                         convert_options=convert_opts)
    if nrows is not None:
        tbl = tbl.slice(0, nrows)
    df = _frame(Table.from_arrow(tbl, device=device))
    if dtype is not None and not isinstance(dtype, dict):
        df = df.astype(dtype)
    elif isinstance(dtype, dict):
        cats = [k for k, v in dtype.items() if str(v) == "category" and k in df.columns]
        for k in cats:
            df[k] = df[k].astype("category")
    if parse_dates:
        from cudf_tpu_torch.frame.tools import to_datetime

        for c in parse_dates:
            df[c] = to_datetime(df[c])
    return df


def write_csv(df, path=None, sep=",", header=True, index=True, **kw):
    """pandas' ``to_csv`` of a DataFrame or Series (a counted host route)."""
    from cudf_tpu_torch.ops._utils import count_host_route

    count_host_route("write_csv")
    return df.to_pandas().to_csv(path, sep=sep, header=header, index=index, **kw)
