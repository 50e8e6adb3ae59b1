"""Feather (Arrow IPC) reader and writer (port of ``cudf_tpu/io/feather.py``).
The reference's only tier is pyarrow's, and so is this one's: the file
through ``pyarrow.feather`` and the columns through the port's own
``Table.from_arrow`` / ``to_arrow``, counted as "pyarrow" in
``IO_ROUTES``.  A machine without pyarrow cannot read or write Feather.
"""

from __future__ import annotations

import warnings

from cudf_tpu_torch.core.table import Table
from cudf_tpu_torch.io import IO_ROUTES


def read_feather(path, columns=None, *, device="cuda"):
    from cudf_tpu_torch.frame.dataframe import DataFrame
    from cudf_tpu_torch.frame.index import default_index

    IO_ROUTES["pyarrow"] += 1
    import pyarrow.feather as pf

    with warnings.catch_warnings():      # pyarrow 24+ names Feather V2 its IPC file
        warnings.simplefilter("ignore", FutureWarning)
        tbl = pf.read_table(path, columns=list(columns) if columns else None)
    t = Table.from_arrow(tbl, device=device)
    return DataFrame._from(t, default_index(t.num_rows))


def write_feather(df, path, **kw) -> None:
    IO_ROUTES["pyarrow"] += 1
    import pyarrow.feather as pf

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        pf.write_feather(df._table.to_arrow(), path, **kw)
