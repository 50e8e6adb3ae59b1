"""The tpudf table file (port of ``cudf_tpu/io/tpudf_file.py``; libcudf's
experimental cudftable format): b"TPDF", the metadata's length, the
``pack`` metadata (JSON), the blob's length, then the blob, byte for byte
the reference's file.  The blob is packed on the device
(``ops/pack.py``) and written with one copy to the host; a read is one
file read and one host-to-device copy, its columns views into the blob.
"""

from __future__ import annotations

import numpy as np
import torch

from cudf_tpu_torch.io import IO_ROUTES

MAGIC = b"TPDF"


def write_tpudf(df, path) -> None:
    from cudf_tpu_torch.ops.pack import pack

    packed = pack(df._table)
    blob = packed.gpu_data.cpu().numpy()
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(len(packed.metadata).to_bytes(8, "little"))
        f.write(packed.metadata)
        f.write(int(blob.nbytes).to_bytes(8, "little"))
        f.write(blob.tobytes())
    IO_ROUTES["native"] += 1


def read_tpudf(path, *, device="cuda"):
    from cudf_tpu_torch.frame.dataframe import DataFrame
    from cudf_tpu_torch.frame.index import default_index
    from cudf_tpu_torch.ops.pack import PackedColumns, unpack

    with open(path, "rb") as f:
        if f.read(4) != MAGIC:
            raise ValueError("not a tpudf file")
        meta = f.read(int.from_bytes(f.read(8), "little"))
        dlen = int.from_bytes(f.read(8), "little")
        blob = np.fromfile(f, np.uint8, count=dlen)
    if blob.size != dlen:
        raise ValueError("tpudf file: truncated blob")
    t = unpack(PackedColumns(meta, torch.from_numpy(blob).to(device)))
    IO_ROUTES["native"] += 1
    return DataFrame._from(t, default_index(t.num_rows))
