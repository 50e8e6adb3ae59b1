"""Table — an ordered collection of equal-length Columns (port of
``cudf_tpu/core/table.py``)."""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence, Tuple

from cudf_tpu_torch.core.column import Column


class Table:
    __slots__ = ("_names", "_columns")

    def __init__(self, columns: Optional[Dict[str, Column]] = None):
        columns = columns or {}
        self._names: Tuple = tuple(columns.keys())
        self._columns: Tuple[Column, ...] = tuple(columns.values())
        for name, c in zip(self._names, self._columns):
            if c.length != self._columns[0].length:
                raise ValueError(f"column {name!r} has length {c.length}, "
                                 f"expected {self._columns[0].length}")
            if c.device != self._columns[0].device:
                raise ValueError(f"column {name!r} is on {c.device}, "
                                 f"expected {self._columns[0].device}")

    @classmethod
    def from_pairs(cls, names: Sequence, columns: Sequence[Column]) -> "Table":
        return cls(dict(zip(names, columns)))

    @property
    def num_rows(self) -> int:
        return self._columns[0].length if self._columns else 0

    @property
    def device(self):
        """The device of the table's columns (None when it has none)."""
        return self._columns[0].device if self._columns else None

    @property
    def nbytes(self) -> int:
        """Bytes of the columns' buffers, each byte of a storage counted
        once (``core/column.py`` ``distinct_bytes``)."""
        from cudf_tpu_torch.core.column import distinct_bytes

        return distinct_bytes(b for c in self._columns for b in c.buffers())

    @property
    def num_columns(self) -> int:
        return len(self._columns)

    @property
    def names(self) -> Tuple:
        return self._names

    @property
    def columns(self) -> Tuple[Column, ...]:
        return self._columns

    def __getitem__(self, name) -> Column:
        try:
            return self._columns[self._names.index(name)]
        except ValueError:
            raise KeyError(name) from None

    def column(self, i: int) -> Column:
        return self._columns[i]

    def items(self) -> Iterable[Tuple[object, Column]]:
        return zip(self._names, self._columns)

    def select(self, names: Sequence) -> "Table":
        return Table.from_pairs(names, [self[n] for n in names])

    def insert(self, name, column: Column, loc: Optional[int] = None) -> "Table":
        names, cols = list(self._names), list(self._columns)
        if name in names:
            cols[names.index(name)] = column
        else:
            loc = len(names) if loc is None else loc
            names.insert(loc, name)
            cols.insert(loc, column)
        return Table.from_pairs(names, cols)

    def drop(self, names: Sequence) -> "Table":
        gone = set(names)
        return Table.from_pairs([n for n in self._names if n not in gone],
                                [c for n, c in self.items() if n not in gone])

    def rename(self, mapping: Dict) -> "Table":
        return Table.from_pairs([mapping.get(n, n) for n in self._names], self._columns)

    @classmethod
    def from_arrow(cls, tbl, *, device) -> "Table":
        """A pyarrow Table (or anything with ``__arrow_c_stream__``, no
        pyarrow needed) onto ``device``."""
        if not hasattr(tbl, "column_names"):
            from cudf_tpu_torch.arrow_cdata import from_c_stream_table

            return from_c_stream_table(tbl, device=device)
        return cls({n: Column.from_arrow(tbl.column(i).combine_chunks(), device=device)
                    for i, n in enumerate(tbl.column_names)})

    def to_arrow(self):
        """A pyarrow Table of the columns."""
        import pyarrow as pa

        return pa.table({str(n): c.to_arrow() for n, c in self.items()})

    def __arrow_c_array__(self, requested_schema=None):
        from cudf_tpu_torch.arrow_cdata import table_capsules

        return table_capsules(self, requested_schema)

    def __arrow_c_stream__(self, requested_schema=None):
        from cudf_tpu_torch.arrow_cdata import table_stream_capsule

        return table_stream_capsule(self, requested_schema)

    def __contains__(self, name) -> bool:
        return name in self._names

    def __repr__(self) -> str:
        cols = ", ".join(f"{n}: {c.dtype!r}" for n, c in self.items())
        return f"Table[{self.num_rows} rows]({cols})"
