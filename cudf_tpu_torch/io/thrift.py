"""Thrift compact-protocol reader for Parquet metadata (port of
``cudf_tpu/io/thrift.py``, host code, unchanged): FileMetaData, RowGroup,
ColumnChunk, PageHeader, the page index and bloom filter headers, parsed
from bytes with no thrift library (libcudf's compact_protocol_reader.cpp).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


class CompactReader:
    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def read_byte(self) -> int:
        b = self.buf[self.pos]
        self.pos += 1
        return b

    def read_varint(self) -> int:
        out = 0
        shift = 0
        while True:
            b = self.read_byte()
            out |= (b & 0x7F) << shift
            if not (b & 0x80):
                return out
            shift += 7

    def read_zigzag(self) -> int:
        v = self.read_varint()
        return (v >> 1) ^ -(v & 1)

    def read_bytes(self) -> bytes:
        n = self.read_varint()
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def read_struct(self) -> Dict[int, Any]:
        """Generic struct -> {field_id: value}."""
        out: Dict[int, Any] = {}
        last_fid = 0
        while True:
            b = self.read_byte()
            if b == 0:
                return out
            delta = (b & 0xF0) >> 4
            ftype = b & 0x0F
            if delta:
                fid = last_fid + delta
            else:
                fid = self.read_zigzag()
            last_fid = fid
            out[fid] = self._read_value(ftype)

    def _read_value(self, ftype: int):
        if ftype in (1, 2):  # BOOLEAN_TRUE / BOOLEAN_FALSE
            return ftype == 1
        if ftype == 3:  # BYTE
            return self.read_byte()
        if ftype in (4, 5, 6):  # I16, I32, I64
            return self.read_zigzag()
        if ftype == 7:  # DOUBLE (little-endian per parquet)
            import struct

            v = struct.unpack("<d", self.buf[self.pos:self.pos + 8])[0]
            self.pos += 8
            return v
        if ftype == 8:  # BINARY/STRING
            return self.read_bytes()
        if ftype == 9:  # LIST
            return self._read_list()
        if ftype == 12:  # STRUCT
            return self.read_struct()
        raise ValueError(f"unsupported thrift type {ftype}")

    def _read_list(self):
        b = self.read_byte()
        size = (b & 0xF0) >> 4
        etype = b & 0x0F
        if size == 15:
            size = self.read_varint()
        if etype in (1, 2):
            # bool list elements take one byte each (0x01 true / 0x02
            # false) — unlike struct fields where the type IS the value
            return [self.read_byte() == 1 for _ in range(size)]
        return [self._read_value(etype) for _ in range(size)]


# ----------------------------------------------------------------------
# typed views over the raw field-id dicts (parquet.thrift field numbering)
# ----------------------------------------------------------------------

@dataclass
class SchemaElement:
    type: Optional[int]
    type_length: Optional[int]
    repetition_type: Optional[int]
    name: str
    num_children: int
    converted_type: Optional[int]
    scale: int = 0
    precision: int = 0
    logical: Optional[tuple] = None     # parsed LogicalType (field 10)

    @classmethod
    def from_raw(cls, d):
        return cls(
            type=d.get(1), type_length=d.get(2), repetition_type=d.get(3),
            name=d.get(4, b"").decode(), num_children=d.get(5, 0) or 0,
            converted_type=d.get(6),
            scale=d.get(7, 0) or 0, precision=d.get(8, 0) or 0,
            logical=cls._parse_logical(d.get(10)),
        )

    @staticmethod
    def _parse_logical(lt):
        """LogicalType union → simple tuple (parquet.thrift LogicalType;
        the modern replacement for ConvertedType — pyarrow writes ns
        timestamps with ONLY this)."""
        if not isinstance(lt, dict):
            return None
        if 1 in lt:
            return ("string",)
        if 5 in lt:
            dec = lt[5]
            return ("decimal", dec.get(1, 0), dec.get(2, 0))
        if 6 in lt:
            return ("date",)
        if 7 in lt or 8 in lt:
            sub = lt.get(8, lt.get(7))
            unit = sub.get(2, {})
            u = "ms" if 1 in unit else ("us" if 2 in unit else "ns")
            return ("timestamp" if 8 in lt else "time", u, sub.get(1, False))
        if 10 in lt:
            iu = lt[10]
            return ("int", iu.get(1, 32), bool(iu.get(2, True)))
        return None


@dataclass
class Statistics:
    """Column-chunk statistics (parquet.thrift Statistics) — the inputs
    to row-group predicate pushdown (predicate_pushdown.cpp)."""

    min_value: Optional[bytes]
    max_value: Optional[bytes]
    null_count: Optional[int]

    @classmethod
    def from_raw(cls, d):
        # parquet.thrift Statistics: 5=max_value, 6=min_value (modern);
        # 1=max, 2=min (deprecated signed-comparison era)
        return cls(
            min_value=d.get(6, d.get(2)),
            max_value=d.get(5, d.get(1)),
            null_count=d.get(3),
        )

    def decode(self, phys: int):
        """(min, max) as python values for physical type, or None."""
        import struct as _s

        fmt = {1: "<i", 2: "<q", 4: "<f", 5: "<d"}.get(phys)

        def dec(b):
            if b is None:
                return None
            if fmt is not None:
                return _s.unpack(fmt, b)[0] if len(b) == _s.calcsize(fmt) else None
            if phys == 6:
                return b  # BYTE_ARRAY: raw bytes, lexicographic
            if phys == 0:
                return bool(b[0]) if b else None
            return None

        return dec(self.min_value), dec(self.max_value)


@dataclass
class ColumnChunkMeta:
    type: int
    encodings: List[int]
    path: List[str]
    codec: int
    num_values: int
    total_uncompressed_size: int
    total_compressed_size: int
    data_page_offset: int
    dictionary_page_offset: Optional[int]
    statistics: Optional["Statistics"] = None
    # ColumnChunk-level (outer struct) page-index / bloom locators
    # (reference: page_index_filter.cu, bloom_filter_reader.cu inputs)
    offset_index_offset: Optional[int] = None
    offset_index_length: Optional[int] = None
    column_index_offset: Optional[int] = None
    column_index_length: Optional[int] = None
    bloom_filter_offset: Optional[int] = None
    bloom_filter_length: Optional[int] = None

    @classmethod
    def from_raw(cls, d):
        return cls(
            type=d[1], encodings=d.get(2, []),
            path=[p.decode() for p in d.get(3, [])],
            codec=d[4], num_values=d[5],
            total_uncompressed_size=d[6], total_compressed_size=d[7],
            data_page_offset=d[9], dictionary_page_offset=d.get(11),
            statistics=Statistics.from_raw(d[12]) if 12 in d else None,
            bloom_filter_offset=d.get(14), bloom_filter_length=d.get(15),
        )


@dataclass
class RowGroup:
    columns: List[ColumnChunkMeta]
    total_byte_size: int
    num_rows: int

    @classmethod
    def from_raw(cls, d):
        cols = []
        for c in d.get(1, []):
            meta = c.get(3)  # ColumnMetaData struct
            cc = ColumnChunkMeta.from_raw(meta)
            # outer ColumnChunk fields: 4/5 offset index, 6/7 column index
            cc.offset_index_offset = c.get(4)
            cc.offset_index_length = c.get(5)
            cc.column_index_offset = c.get(6)
            cc.column_index_length = c.get(7)
            cols.append(cc)
        return cls(columns=cols, total_byte_size=d.get(2, 0), num_rows=d.get(3, 0))


# ----------------------------------------------------------------------
# page index (parquet.thrift ColumnIndex / OffsetIndex) — per-page stats
# enabling page-granular predicate pushdown (the reference's
# experimental/page_index_filter.cu consumes the same structures)
# ----------------------------------------------------------------------

@dataclass
class PageLocation:
    offset: int
    compressed_page_size: int
    first_row_index: int


@dataclass
class OffsetIndex:
    page_locations: List[PageLocation]

    @classmethod
    def parse(cls, buf: bytes) -> "OffsetIndex":
        d = CompactReader(buf).read_struct()
        return cls([PageLocation(p[1], p[2], p[3]) for p in d.get(1, [])])


@dataclass
class ColumnIndex:
    null_pages: List[bool]
    min_values: List[bytes]
    max_values: List[bytes]
    boundary_order: int
    null_counts: Optional[List[int]]

    @classmethod
    def parse(cls, buf: bytes) -> "ColumnIndex":
        d = CompactReader(buf).read_struct()
        return cls(
            null_pages=d.get(1, []), min_values=d.get(2, []),
            max_values=d.get(3, []), boundary_order=d.get(4, 0),
            null_counts=d.get(5),
        )


@dataclass
class BloomFilterHeader:
    num_bytes: int
    # algorithm/hash/compression are unions — presence of field 1 in each
    # means BLOCK / XXHASH / UNCOMPRESSED (the only defined values)
    header_len: int = 0

    @classmethod
    def parse(cls, buf: bytes, pos: int = 0) -> "BloomFilterHeader":
        r = CompactReader(buf, pos)
        d = r.read_struct()
        return cls(num_bytes=d[1], header_len=r.pos - pos)


@dataclass
class FileMetaData:
    version: int
    schema: List[SchemaElement]
    num_rows: int
    row_groups: List[RowGroup]
    key_value: List[Tuple[bytes, bytes]] = field(default_factory=list)

    @classmethod
    def from_raw(cls, d):
        return cls(
            version=d.get(1, 0),
            schema=[SchemaElement.from_raw(s) for s in d.get(2, [])],
            num_rows=d.get(3, 0),
            row_groups=[RowGroup.from_raw(r) for r in d.get(4, [])],
            key_value=[(kv.get(1, b""), kv.get(2, b""))
                       for kv in d.get(5, []) if isinstance(kv, dict)],
        )


@dataclass
class PageHeader:
    type: int                 # 0=DATA_PAGE, 2=DICTIONARY_PAGE, 3=DATA_PAGE_V2
    uncompressed_page_size: int
    compressed_page_size: int
    # data page v1
    num_values: Optional[int] = None
    encoding: Optional[int] = None
    def_level_encoding: Optional[int] = None
    rep_level_encoding: Optional[int] = None
    # dictionary page
    dict_num_values: Optional[int] = None
    header_len: int = 0
    # data page v2
    num_nulls: Optional[int] = None
    def_levels_byte_length: int = 0
    rep_levels_byte_length: int = 0
    v2_is_compressed: bool = True

    @classmethod
    def parse(cls, buf: bytes, pos: int) -> "PageHeader":
        r = CompactReader(buf, pos)
        d = r.read_struct()
        ph = cls(type=d[1], uncompressed_page_size=d[2], compressed_page_size=d[3])
        if 5 in d:  # DataPageHeader
            dp = d[5]
            ph.num_values = dp.get(1)
            ph.encoding = dp.get(2)
            ph.def_level_encoding = dp.get(3)
            ph.rep_level_encoding = dp.get(4)
        if 7 in d:  # DictionaryPageHeader
            ph.dict_num_values = d[7].get(1)
        if 8 in d:  # DataPageHeaderV2
            dp = d[8]
            ph.num_values = dp.get(1)
            ph.num_nulls = dp.get(2)
            ph.encoding = dp.get(4)
            ph.def_levels_byte_length = dp.get(5, 0)
            ph.rep_levels_byte_length = dp.get(6, 0)
            ph.v2_is_compressed = dp.get(7, True)
        ph.header_len = r.pos - pos
        return ph


def read_file_metadata(path: str) -> FileMetaData:
    with open(path, "rb") as f:
        f.seek(-8, 2)
        tail = f.read(8)
        if tail[4:] != b"PAR1":
            raise ValueError("not a parquet file")
        meta_len = int.from_bytes(tail[:4], "little")
        f.seek(-8 - meta_len, 2)
        raw = f.read(meta_len)
    d = CompactReader(raw).read_struct()
    return FileMetaData.from_raw(d)
