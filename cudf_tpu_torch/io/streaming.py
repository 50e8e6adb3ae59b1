"""Streaming ingestion (port of ``cudf_tpu/io/streaming.py``; custreamz's
``Consumer.read_gdf``, libcudf_kafka as a datasource): an offset-tracked
consumer that turns what a growing log appended into a DataFrame, over
file-backed sources, with ``LogSource`` the seam where a broker client
would plug in.  Each poll parses the complete records appended since the
last through the port's own ``read_json`` (lines) or ``read_csv``.
"""

from __future__ import annotations

import io
import os
from typing import Optional

__all__ = ["LogSource", "FileLogSource", "StreamConsumer"]


class LogSource:
    """An append-only byte log addressed by offsets."""

    def end_offset(self) -> int:
        raise NotImplementedError

    def read_range(self, start: int, end: int) -> bytes:
        raise NotImplementedError


class FileLogSource(LogSource):
    """A file being appended to (``tail -f``)."""

    def __init__(self, path: str):
        self.path = path

    def end_offset(self) -> int:
        try:
            return os.path.getsize(self.path)
        except OSError:
            return 0

    def read_range(self, start: int, end: int) -> bytes:
        with open(self.path, "rb") as f:
            f.seek(start)
            return f.read(max(0, end - start))


class StreamConsumer:
    """Each poll parses the complete records appended since the last one;
    a partial last record waits for its delimiter, so every record is
    parsed once.  ``reader_kwargs`` go to the reader (``device`` among
    them: the card by default)."""

    def __init__(self, source: LogSource, fmt: str = "jsonl", delimiter: bytes = b"\n",
                 **reader_kwargs):
        if fmt not in ("jsonl", "json", "csv"):
            raise ValueError(f"unknown stream format {fmt!r}")
        self.source = source
        self.fmt = fmt
        self.delimiter = delimiter
        self.reader_kwargs = reader_kwargs
        self.committed = 0

    def poll(self, max_bytes: Optional[int] = None):
        """A DataFrame of the complete records appended since the last
        poll, or None when there is none."""
        end = self.source.end_offset()
        if max_bytes is not None:
            end = min(end, self.committed + max_bytes)
        if end <= self.committed:
            return None
        raw = self.source.read_range(self.committed, end)
        cut = raw.rfind(self.delimiter)
        if cut < 0:
            return None
        chunk = raw[:cut + len(self.delimiter)]
        self.committed += cut + len(self.delimiter)
        return self._parse(chunk)

    def _parse(self, chunk: bytes):
        if self.fmt in ("jsonl", "json"):
            from cudf_tpu_torch.io.json import read_json

            return read_json(chunk, lines=True, **self.reader_kwargs)
        from cudf_tpu_torch.io.csv import read_csv

        return read_csv(io.BytesIO(chunk), header=None, **self.reader_kwargs)

    def seek(self, offset: int) -> None:
        self.committed = int(offset)
