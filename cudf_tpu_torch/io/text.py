"""Text reader (port of ``cudf_tpu/io/text.py``; libcudf's
``cudf::io::text::multibyte_split``): a file split into records at a
delimiter.  One read, the delimiter scan in ``io_host.cpp``
(``multibyte_split``: the records' start offsets), one host-to-device
copy of the bytes and one of the offsets; the delimiters come off on the
device (``ops.strings.strip``).
"""

from __future__ import annotations

import numpy as np
import torch

from cudf_tpu_torch.io import IO_ROUTES, _native


def read_text(path_or_bytes, delimiter: str = "\n", strip_delimiters: bool = True, *,
              device="cuda"):
    """A Series of the records split at ``delimiter`` (cudf.read_text),
    each without its delimiter when ``strip_delimiters``."""
    from cudf_tpu_torch.core import dtypes as dt
    from cudf_tpu_torch.core.column import Column
    from cudf_tpu_torch.frame.index import default_index
    from cudf_tpu_torch.frame.series import Series

    if isinstance(path_or_bytes, (bytes, bytearray)):
        chars = np.frombuffer(bytes(path_or_bytes), np.uint8)
    else:
        chars = np.fromfile(path_or_bytes, np.uint8)
    offsets = _native.multibyte_split(chars, delimiter.encode())
    col = Column(dt.STRING, offsets.shape[0] - 1,
                 torch.from_numpy(chars if chars.flags.writeable else chars.copy()).to(device),
                 None, torch.from_numpy(offsets).to(device))
    if strip_delimiters:
        from cudf_tpu_torch.ops.strings import strip

        col = strip(col, delimiter, side="right")
    IO_ROUTES["native"] += 1
    return Series._from(col, default_index(col.length))
