"""File readers and writers (port of ``cudf_tpu/io/``): Parquet
(``parquet.py`` and the modules under it) and CSV (``csv.py``,
``csv_device.py``).  Nothing here builds or imports pyarrow or pandas at
import time.  JSON, ORC, Avro, Feather, the tpudf file, text and the
streaming readers are not ported yet: their readers raise naming
ROADMAP.md queue 1, item 7.

``IO_ROUTES`` counts the reads and writes each tier served: "native"
(the port's own readers and writers) and "pyarrow" (the shapes the
native tiers declare unsupported).
"""

IO_ROUTES = {"native": 0, "pyarrow": 0}


def _not_ported(name: str):
    def reader(*args, **kwargs):
        raise NotImplementedError(f"{name}: cudf_tpu_torch/io is ROADMAP.md queue 1, item 7 "
                                  "(JSON, ORC, Avro, Feather, tpudf, text and streaming "
                                  "readers)")
    reader.__name__ = name
    return reader


read_json = _not_ported("read_json")
read_orc = _not_ported("read_orc")
read_avro = _not_ported("read_avro")
read_feather = _not_ported("read_feather")
read_tpudf = _not_ported("read_tpudf")
read_text = _not_ported("read_text")
