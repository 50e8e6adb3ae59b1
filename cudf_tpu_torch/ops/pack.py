"""Table serialization: a Table as one contiguous uint8 device buffer plus
host JSON metadata (port of ``cudf_tpu/ops/pack.py``; libcudf's
``pack`` / ``contiguous_split``).

The metadata (schema, buffer dtypes and lengths, each buffer's span) and
the 8-byte alignment of every span are the reference's, so the packed
bytes equal the reference's blob byte for byte.  Unlike the reference,
which pulls every buffer to the host and back, the blob is built on the
tables' device: each buffer's ``view(torch.uint8)`` copied into one
zeroed uint8 tensor.  ``unpack`` gives columns whose buffers are views
into that tensor (each span starts 8-byte aligned).  Nested children,
dictionary keys and a DECIMAL128's high limb are buffers like any other.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List

import torch

from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.core.table import Table

__all__ = ["PackedColumns", "pack", "unpack", "contiguous_split"]


@dataclass
class PackedColumns:
    metadata: bytes          # host JSON (schema + buffer spans)
    gpu_data: torch.Tensor   # ONE contiguous uint8 buffer on the table's device


def _align8(x: int) -> int:
    return (x + 7) & ~7


def _collect(col: Column, bufs: List[torch.Tensor]) -> Dict:
    node: Dict = {"dtype": col.dtype.id.name, "length": col.length, "scale": col.dtype.scale}
    if col.dtype.fields:
        node["fields"] = [n for n, _ in col.dtype.fields]
    if col.dtype.value_type is not None:
        node["value_type"] = col.dtype.value_type.id.name

    def add(buf, name):
        if buf is None:
            node[name] = None
            return
        node[name] = {"buf": len(bufs), "dtype": str(buf.dtype).replace("torch.", ""),
                      "n": int(buf.shape[0])}
        bufs.append(buf)

    add(col.data, "data")
    add(col.validity, "validity")
    add(col.offsets, "offsets")
    node["children"] = [_collect(c, bufs) for c in col.children]
    return node


def pack(table: Table) -> PackedColumns:
    bufs: List[torch.Tensor] = []
    meta = {"names": list(table.names),
            "columns": [_collect(c, bufs) for c in table.columns]}
    spans, pos = [], 0
    for b in bufs:
        pos = _align8(pos)
        nbytes = b.numel() * b.element_size()
        spans.append([pos, nbytes])
        pos += nbytes
    device = table.column(0).device if table.num_columns else torch.device("cpu")
    blob = torch.zeros(_align8(pos), dtype=torch.uint8, device=device)
    for b, (off, nbytes) in zip(bufs, spans):
        blob[off:off + nbytes] = b.contiguous().view(torch.uint8)
    meta["spans"] = spans
    return PackedColumns(json.dumps(meta).encode(), blob)


def _rebuild(node: Dict, blob: torch.Tensor, spans) -> Column:
    def get(name):
        info = node.get(name)
        if info is None:
            return None
        off, nbytes = spans[info["buf"]]
        return blob[off:off + nbytes].view(getattr(torch, info["dtype"]))

    tid = dt.TypeId[node["dtype"]]
    children = [_rebuild(c, blob, spans) for c in node["children"]]
    if tid == dt.TypeId.LIST:
        dtype = dt.list_dtype(children[0].dtype)
    elif tid == dt.TypeId.STRUCT:
        names = node.get("fields", [str(i) for i in range(len(children))])
        dtype = dt.struct_dtype([(n, c.dtype) for n, c in zip(names, children)])
    elif tid == dt.TypeId.DICTIONARY32:
        vt = dt.DType(dt.TypeId[node["value_type"]]) if "value_type" in node else dt.STRING
        dtype = dt.DType(tid, value_type=vt)
    else:
        dtype = dt.DType(tid, scale=node.get("scale", 0))
    return Column(dtype, node["length"], get("data"), get("validity"), get("offsets"),
                  children)


def unpack(packed: PackedColumns) -> Table:
    meta = json.loads(packed.metadata.decode())
    cols = [_rebuild(c, packed.gpu_data, meta["spans"]) for c in meta["columns"]]
    return Table.from_pairs(meta["names"], cols)


def contiguous_split(table: Table, splits: List[int]) -> List[PackedColumns]:
    """Split the rows at ``splits`` and pack each piece
    (cudf::contiguous_split)."""
    from cudf_tpu_torch.ops import copying

    bounds = [0, *splits, table.num_rows]
    return [pack(Table.from_pairs(table.names, [copying.slice(c, bounds[i], bounds[i + 1])
                                                for c in table.columns]))
            for i in range(len(bounds) - 1)]
