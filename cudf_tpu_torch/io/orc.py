"""ORC reader and writer entry points (port of ``cudf_tpu/io/orc.py``).

``read_orc`` takes the native reader (``orc_native.py``) for every flat
file, and pyarrow only for ``stripes=`` and the shapes the native reader
declares unsupported (``UnsupportedOrc``: nested or decimal columns,
LZO, LZ4, TIMESTAMP_INSTANT, another writer time zone); any other error
propagates.  ``write_orc`` takes the native writer (``orc_writer.py``)
for numeric, bool, string, dictionary and temporal columns under no,
zlib or snappy compression, pyarrow for the rest.  Both count the tier
in ``IO_ROUTES``.
"""

from __future__ import annotations

import os

from cudf_tpu_torch.core.table import Table
from cudf_tpu_torch.io import IO_ROUTES


def _frame(t: Table):
    from cudf_tpu_torch.frame.dataframe import DataFrame
    from cudf_tpu_torch.frame.index import default_index

    return DataFrame._from(t, default_index(t.num_rows))


def read_orc(path, columns=None, stripes=None, *, device="cuda", **kw):
    """A DataFrame on ``device``."""
    cols = list(columns) if columns else None
    if stripes is None and not kw:
        from cudf_tpu_torch.io.orc_native import UnsupportedOrc, read_orc_native

        try:
            t = read_orc_native(os.fspath(path), cols, device=device)
        except UnsupportedOrc:
            pass
        else:
            IO_ROUTES["native"] += 1
            return _frame(t)
    IO_ROUTES["pyarrow"] += 1
    import pyarrow as pa
    import pyarrow.orc as po

    f = po.ORCFile(path)
    if stripes is not None:
        tbl = pa.Table.from_batches([f.read_stripe(i, columns=cols) for i in stripes])
    else:
        tbl = f.read(columns=cols)
    return _frame(Table.from_arrow(tbl, device=device))


def write_orc(df, path, compression=None, stripe_size=None, **kw):
    """``df`` as an ORC file; compression None, "zlib" or "snappy" on the
    native writer (``stripe_size`` rows a stripe)."""
    from cudf_tpu_torch.io.orc_writer import COMP_IDS, writable, write_orc_native

    comp = compression.lower() if isinstance(compression, str) else compression
    if comp in COMP_IDS and not kw and all(writable(c) for c in df._table.columns):
        write_orc_native(df._table, os.fspath(path), compression=comp,
                         **({"stripe_size": stripe_size} if stripe_size else {}))
        IO_ROUTES["native"] += 1
        return
    IO_ROUTES["pyarrow"] += 1
    import pyarrow.orc as po

    po.write_table(df._table.to_arrow(), path,
                   **({"compression": compression} if compression else {}), **kw)
