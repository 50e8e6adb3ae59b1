"""Columnar core: dtypes, validity, Column and Table over torch tensors."""

from cudf_tpu_torch.core.column import Column, as_column
from cudf_tpu_torch.core.dtypes import DType, TypeId, dtype
from cudf_tpu_torch.core.table import Table

__all__ = ["DType", "TypeId", "dtype", "Column", "as_column", "Table"]
