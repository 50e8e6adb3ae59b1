"""Interop (port of ``cudf_tpu/interop.py``): pandas round trip, Arrow
(a pyarrow Table or Array, or any object with the Arrow PyCapsule
protocol: ``arrow_cdata.py``, no pyarrow needed), DLPack, and column
buffers in from host arrays.

pandas is imported lazily by the frame's ``to_pandas``; this module
imports neither pandas nor pyarrow.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from cudf_tpu_torch.core import bitmask as bm
from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import Column


def from_pandas(obj, *, device):
    """pandas DataFrame or Series -> the port's DataFrame or Series on
    ``device``."""
    from cudf_tpu_torch.frame.dataframe import DataFrame
    from cudf_tpu_torch.frame.series import Series

    if hasattr(obj, "columns"):
        return DataFrame.from_pandas(obj, device=device)
    frame = DataFrame.from_pandas(obj.to_frame(name=0), device=device)
    return Series._from(frame._table[0], frame.index, obj.name)


def to_pandas(obj):
    return obj.to_pandas()


def from_buffers(dtype, length: int, data: np.ndarray,
                 validity: Optional[np.ndarray] = None, *, device) -> Column:
    """A fixed-width Column from host buffers, onto ``device``.

    dtype: anything ``dtypes.dtype`` takes ("int32", np.float64, ...).
    data: [length] values in the dtype's storage type.  validity: None
    (all valid), bool[length] (True = valid, the reference's layout), or
    an Arrow little-endian bitmask uint8[ceil(length / 8)].
    """
    logical = dt.dtype(dtype)
    data = np.ascontiguousarray(np.asarray(data), dtype=logical.storage)
    if data.shape != (length,):
        raise ValueError(f"data has shape {data.shape}, expected ({length},)")
    values = torch.from_numpy(data.copy()).to(device)
    mask = None
    if validity is not None:
        validity = np.asarray(validity)
        if validity.dtype == np.bool_:
            if validity.shape != (length,):
                raise ValueError("bool validity must have the data's length")
            mask = torch.from_numpy(validity.copy())
        elif validity.dtype == np.uint8 and validity.shape == (-(-length // 8),):
            mask = bm.unpack_bools(torch.from_numpy(validity.copy()), length)
        else:
            raise ValueError("validity must be bool[length] or an Arrow bitmask "
                             "uint8[ceil(length / 8)]")
        mask = mask.to(device)
    return Column(logical, length, values, mask)


def from_arrow(obj, *, device):
    """A pyarrow Table / RecordBatch or an object with ``__arrow_c_stream__``
    -> DataFrame; a pyarrow Array / ChunkedArray or an object with only
    ``__arrow_c_array__`` -> Series (a STRUCT array -> DataFrame)."""
    from cudf_tpu_torch import arrow_cdata
    from cudf_tpu_torch.frame.dataframe import DataFrame
    from cudf_tpu_torch.frame.index import default_index
    from cudf_tpu_torch.frame.series import Series

    if hasattr(obj, "column_names") or hasattr(obj, "__arrow_c_stream__") and \
            not hasattr(obj, "type"):
        return DataFrame.from_arrow(obj, device=device)
    if hasattr(obj, "type") and hasattr(obj, "to_pylist"):      # a pyarrow array
        col = Column.from_arrow(obj, device=device)
    else:
        col = arrow_cdata.from_c_array(obj, device=device)
        if col.dtype.is_struct:
            t = arrow_cdata._struct_table(col)
            return DataFrame._from(t, default_index(t.num_rows))
    return Series._from(col, default_index(col.length))


def from_dlpack(capsule):
    """A Series (1-D) or DataFrame (2-D, a column each) over a DLPack
    tensor, on its device, without a copy."""
    from cudf_tpu_torch.frame.dataframe import DataFrame
    from cudf_tpu_torch.frame.index import default_index
    from cudf_tpu_torch.frame.series import Series

    t = torch.from_dlpack(capsule)
    if t.ndim == 1:
        return Series._from(Column.from_tensor(t), default_index(t.shape[0]))
    return DataFrame({i: Column.from_tensor(t[:, i].contiguous()) for i in range(t.shape[1])})


def to_dlpack(obj):
    """A DLPack capsule of a Series' data buffer."""
    return torch.utils.dlpack.to_dlpack(obj._column.data)
