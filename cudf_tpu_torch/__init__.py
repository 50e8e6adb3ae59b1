"""cudf_tpu_torch — the PyTorch/CUDA port of cudf_tpu.

The port mirrors the reference package's module paths.  It carries
the db-benchmark G1 groupby and J1 join end to end:
``DataFrame.groupby(k).agg({...})`` on the one-hot tier (kernel A) and
the radix-partition tier (kernels B, F, G and D), and
``DataFrame.merge`` on the radix tier (B, F, G, D and H), hand-written
CUDA for Hopper (``csrc/``), each beside a plain PyTorch version that
CPU tensors use.  Every other groupby takes the sort tier
(``ops/row_ops.py``, ``ops/sort.py``, ``ops/groupby.py`` ``make_grouper``),
which runs on PyTorch's own sorts, gathers and scatters.  The LazyFrame
engine (``cudf_tpu_torch.engine``) runs query plans over these, with
temporal, string and dictionary columns; ``models/tpch.py`` holds TPC-H
q1, q6, q12 and q14.

Importing the package touches no CUDA, builds nothing and imports
neither pandas nor pyarrow.
"""

from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.core.table import Table
from cudf_tpu_torch.frame.dataframe import DataFrame
from cudf_tpu_torch.frame.groupby import DataFrameGroupBy
from cudf_tpu_torch.frame.index import Index, RangeIndex
from cudf_tpu_torch.frame.series import Series
from cudf_tpu_torch.interop import from_buffers, from_pandas, to_pandas

__all__ = ["Column", "Table", "DataFrame", "DataFrameGroupBy", "Index",
           "RangeIndex", "Series", "from_buffers", "from_pandas", "to_pandas"]
