"""Query engine: logical IR, expression tree, optimizer and LazyFrame
(port of ``cudf_tpu/engine``), with the in-memory executor.

The partitioned executor (``collect(mesh=...)``, ``streaming=True``,
``engine/streaming.py``, ``engine/spmd.py`` and its fallback statistics)
is ROADMAP.md queue 1, item 10.
"""

from cudf_tpu_torch.engine.expr import Expr, col, lit, when
from cudf_tpu_torch.engine.lazy import LazyFrame, from_dataframe, scan_csv, scan_parquet

__all__ = ["Expr", "col", "lit", "when", "LazyFrame", "scan_parquet", "scan_csv",
           "from_dataframe"]
