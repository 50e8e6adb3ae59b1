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
temporal, string and dictionary columns; ``models/tpch.py`` holds the
TPC-H queries.  The pandas API (``frame/``) adds the reference's
top-level reshapes (``concat``, ``pivot_table``, ``melt`` ...) and tools
(``cut``, ``to_datetime`` ...), and row UDFs (``Series.apply``,
``utils/masked.py`` ``Masked``).  ``io/`` reads and writes Parquet,
CSV, JSON, ORC, Feather and the tpudf file (``read_parquet``,
``read_csv``, ``read_json``, ``read_orc``, ``read_feather``,
``read_tpudf``, ``DataFrame.to_parquet`` ...; the engine's
``scan_parquet`` / ``sink_parquet``), reads Avro and text
(``read_avro``, ``read_text``) and consumes a growing log
(``io.streaming.StreamConsumer``); ``arrow_cdata.py`` speaks the Arrow
C data interface.

The top level exports what the reference's does: the frame API, the
readers, the dtypes (``DType``, ``dtype``), the options
(``get_option``, ``set_option``, ``describe_option``,
``option_context``), ``NA`` and ``NaT``, and the ``engine`` package.

Importing the package touches no CUDA, builds nothing and imports
neither pandas nor pyarrow.
"""

from cudf_tpu_torch import engine
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.core.dtypes import DType, dtype
from cudf_tpu_torch.core.table import Table
from cudf_tpu_torch.frame.asof import merge_asof
from cudf_tpu_torch.frame.dataframe import DataFrame
from cudf_tpu_torch.frame.groupby import DataFrameGroupBy
from cudf_tpu_torch.frame.index import Index, RangeIndex
from cudf_tpu_torch.frame.reshape import (concat, crosstab, get_dummies, melt, merge,
                                          pivot_table)
from cudf_tpu_torch.frame.series import Series
from cudf_tpu_torch.frame.tools import (cut, date_range, factorize, isna, isnull, notna,
                                        notnull, qcut, to_datetime, to_numeric, unique)
from cudf_tpu_torch.interop import (from_arrow, from_buffers, from_dlpack, from_pandas,
                                    to_dlpack, to_pandas)
from cudf_tpu_torch.io import (read_avro, read_feather, read_json, read_orc, read_text,
                               read_tpudf)
from cudf_tpu_torch.io.csv import read_csv
from cudf_tpu_torch.io.parquet import read_parquet
from cudf_tpu_torch.utils.config import describe_option, get_option, option_context, set_option
from cudf_tpu_torch.utils.masked import Masked
from cudf_tpu_torch.utils.missing import NA, NaT

__all__ = ["Column", "DType", "DataFrame", "DataFrameGroupBy", "Index", "Masked", "NA", "NaT",
           "RangeIndex", "Series", "Table", "concat", "crosstab", "cut", "date_range",
           "describe_option", "dtype", "engine", "factorize", "from_arrow", "from_buffers",
           "from_dlpack", "from_pandas", "get_dummies", "get_option", "isna", "isnull", "melt",
           "merge", "merge_asof", "notna", "notnull", "option_context", "pivot_table", "qcut",
           "read_avro", "read_csv", "read_feather", "read_json", "read_orc", "read_parquet",
           "read_text", "read_tpudf", "set_option", "to_datetime", "to_dlpack", "to_numeric",
           "to_pandas", "unique"]
