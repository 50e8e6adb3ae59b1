"""Query engine: logical IR, expression tree, optimizer and LazyFrame
(port of ``cudf_tpu/engine``), with the in-memory executor and the
partitioned executor on one device (``engine/streaming.py``:
``collect(mesh=n)``, ``collect(streaming=True)``), the same executor
over the ranks of a ``parallel.Mesh`` (``engine/spmd.py``:
``collect(mesh=make_mesh())``) and their fallback statistics.
"""

from cudf_tpu_torch.engine.expr import Expr, col, lit, when
from cudf_tpu_torch.engine.lazy import LazyFrame, from_dataframe, scan_csv, scan_parquet


def get_fallback_stats():
    from cudf_tpu_torch.engine.streaming import get_fallback_stats as _g

    return _g()


def reset_fallback_stats():
    from cudf_tpu_torch.engine.streaming import reset_fallback_stats as _r

    return _r()


__all__ = ["Expr", "col", "lit", "when", "LazyFrame", "scan_parquet", "scan_csv",
           "from_dataframe", "get_fallback_stats", "reset_fallback_stats"]
