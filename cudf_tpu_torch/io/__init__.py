"""File readers and writers (port of ``cudf_tpu/io/``): Parquet
(``parquet.py`` and the modules under it), CSV (``csv.py``,
``csv_device.py``), JSON (``json.py``, ``json_device.py``), ORC
(``orc.py``, ``orc_native.py``, ``orc_writer.py``), Avro (``avro.py``),
Feather (``feather.py``), the tpudf file (``tpudf_file.py``), text
(``text.py``) and the stream consumer (``streaming.py``).  Nothing here
builds or imports pyarrow or pandas at import time.

``IO_ROUTES`` counts the reads and writes each tier served: "native"
(the port's own readers and writers), "pyarrow" and "pandas" (the shapes
the native tiers declare unsupported, and Feather, whose only tier is
pyarrow's).
"""

IO_ROUTES = {"native": 0, "pyarrow": 0, "pandas": 0}


from cudf_tpu_torch.io.avro import read_avro  # noqa: E402  (they count in IO_ROUTES)
from cudf_tpu_torch.io.feather import read_feather  # noqa: E402
from cudf_tpu_torch.io.json import read_json  # noqa: E402
from cudf_tpu_torch.io.orc import read_orc  # noqa: E402
from cudf_tpu_torch.io.text import read_text  # noqa: E402
from cudf_tpu_torch.io.tpudf_file import read_tpudf  # noqa: E402
