"""Nested Parquet: list and struct columns (port of
``cudf_tpu/io/parquet_nested.py``).

The repetition / definition levels decode on the host (small RLE
streams, ``io_host.cpp``); offsets and validity are rebuilt from them
with vectorized numpy, as libcudf's dremel.cu / decode_preprocess.cu
do; the values decode on the device (``parquet_native._decode_chunk``)
and become the device children of the port's LIST (offsets from 0, one
child) and STRUCT (one child a field) columns.

Schemas: the standard 3-level list (``optional group (LIST) { repeated
group list { element } }``), the legacy 2-level list, bare repeated
fields, maps (a list of key/value structs), structs, and any nesting of
them (``schema_tree`` / ``assemble_node``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.core.table import Table
from cudf_tpu_torch.io import thrift


@dataclass
class LeafInfo:
    path: Tuple[str, ...]        # the leaf's dotted path
    elem: "thrift.SchemaElement"
    max_def: int
    max_rep: int
    def_present: int             # the def level of a present value
    def_slot: int                # the def level of an existing slot (lists)

    @property
    def phys(self) -> int:
        return self.elem.type

    @property
    def type_length(self) -> int:
        return self.elem.type_length or 0


@dataclass
class Node:
    """A schema-tree node: rep = its repetition depth, d_present = the
    least def level at which it is not null, d_elem (lists) = the least def
    level at which an element slot exists."""
    name: str
    kind: str                    # "leaf" | "list" | "struct"
    optional: bool
    rep: int
    d_present: int
    d_elem: int = 0
    children: List["Node"] = None
    leaf: Optional[LeafInfo] = None

    def leaves(self) -> List[LeafInfo]:
        if self.kind == "leaf":
            return [self.leaf]
        out = []
        for c in self.children:
            out.extend(c.leaves())
        return out


def schema_tree(schema: List["thrift.SchemaElement"]) -> List[Node]:
    """The flattened pre-order schema as top-level Node trees of any depth
    (list<list<T>>, struct<list>, list<struct>, maps)."""
    i = [1]                                   # schema[0] is the root

    def take():
        el = schema[i[0]]
        i[0] += 1
        return el, [take() for _ in range(el.num_children)]

    def build(el, kids, path, rep, d) -> Node:
        opt = el.repetition_type == 1
        d_pres = d + (1 if opt else 0)
        if el.num_children == 0:
            leaf = LeafInfo(tuple(path + [el.name]), el, d_pres, rep, d_pres, d_pres)
            return Node(el.name, "leaf", opt, rep, d_pres, leaf=leaf)
        if len(kids) == 1 and kids[0][0].repetition_type == 2:
            rep_el, rep_kids = kids[0]
            d_elem, r2 = d_pres + 1, rep + 1
            p2 = path + [el.name, rep_el.name]
            if rep_el.num_children == 0:             # legacy 2-level list
                leaf = LeafInfo(tuple(p2), rep_el, d_elem, r2, d_elem, d_elem)
                elem = Node(rep_el.name, "leaf", False, r2, d_elem, leaf=leaf)
            elif len(rep_kids) == 1 and el.converted_type == 3:
                elem = build_at(*rep_kids[0], p2, r2, d_elem)
            else:                                    # maps: a struct of the fields
                elem = Node(rep_el.name, "struct", False, r2, d_elem,
                            children=[build_at(se, sk, p2, r2, d_elem) for se, sk in rep_kids])
            return Node(el.name, "list", opt, r2, d_pres, d_elem, [elem])
        return Node(el.name, "struct", opt, rep, d_pres,
                    children=[build_at(se, sk, path + [el.name], rep, d_pres)
                              for se, sk in kids])

    def build_at(el, kids, path, rep, d):
        if el.repetition_type == 2:                  # a bare repeated field
            d_elem, r2 = d + 1, rep + 1
            if el.num_children == 0:
                leaf = LeafInfo(tuple(path + [el.name]), el, d_elem, r2, d_elem, d_elem)
                elem = Node(el.name, "leaf", False, r2, d_elem, leaf=leaf)
            else:
                elem = Node(el.name, "struct", False, r2, d_elem,
                            children=[build_at(se, sk, path + [el.name], r2, d_elem)
                                      for se, sk in kids])
            return Node(el.name, "list", False, r2, d, d_elem, [elem])
        return build(el, kids, path, rep, d)

    out = []
    while i[0] < len(schema):
        out.append(build_at(*take(), [], 0, 0))
    return out


def read_chunk_levels(f, cc: "thrift.ColumnChunkMeta", leaf: LeafInfo, clock):
    """One chunk -> (values, defs, reps): the present values only (def ==
    max_def) in level order on the device (a tensor, or (offsets, chars)),
    the levels as host int32 arrays."""
    from cudf_tpu_torch.io.parquet_native import _decode_chunk, _join_values, _read_raw

    raw = _read_raw(f, cc)
    clock.mark("read")
    parts, pages = _decode_chunk(raw, cc, leaf, clock)
    nv = [p.ph.num_values for p in pages]
    defs = np.concatenate([p.defs if p.defs is not None else np.zeros(k, np.int32)
                           for p, k in zip(pages, nv)]) if pages else np.zeros(0, np.int32)
    reps = np.concatenate([p.reps if p.reps is not None else np.zeros(k, np.int32)
                           for p, k in zip(pages, nv)]) if pages else np.zeros(0, np.int32)
    if not parts:
        from cudf_tpu_torch.io.parquet_native import _empty

        c = _empty(leaf.elem, clock.device)
        parts = [(c.offsets, c.data) if c.dtype.is_string else c.data]
    values, _ = _join_values(parts, None, clock.device)
    return values, defs, reps


def _leaf_column(values, present: np.ndarray, elem, device) -> Column:
    """A leaf over its slots: present values spread in, nulls elsewhere."""
    from cudf_tpu_torch.io.parquet_native import _finish, _join_values

    vals, mask = _join_values([values], present, device)
    return _finish(vals, mask, elem, device)


def assemble_node(node: Node, streams: Dict[Tuple[str, ...], tuple], device) -> Column:
    """Per-leaf (values, defs, reps) streams -> a Column of any depth.
    Sibling leaves share their def / rep prefixes at every common level,
    so any descendant leaf's stream drives a shared node's offsets and
    validity; per-leaf selection masks keep each leaf's own cadence."""
    sel = {leaf.path: np.ones(len(streams[leaf.path][1]), bool) for leaf in node.leaves()}
    return _assemble(node, streams, sel, device)


def _mask(pv: np.ndarray, device) -> Optional[torch.Tensor]:
    return None if pv.all() else torch.from_numpy(pv).to(device)


def _assemble(node: Node, streams, sel, device) -> Column:
    if node.kind == "leaf":
        leaf = node.leaf
        values, defs, _ = streams[leaf.path]
        return _leaf_column(values, defs[sel[leaf.path]] >= leaf.def_present, leaf.elem,
                            device)
    leaf0 = node.leaves()[0]
    _, defs0, reps0 = streams[leaf0.path]
    d, r = defs0[sel[leaf0.path]], reps0[sel[leaf0.path]]
    if node.kind == "struct":
        children = [_assemble(c, streams, sel, device) for c in node.children]
        slot = r <= node.rep              # deeper lists repeat within a slot
        mask = _mask(d[slot] >= node.d_present, device) if node.optional else None
        n = children[0].length if children else int(slot.sum())
        fields = tuple((c_node.name, c.dtype) for c_node, c in zip(node.children, children))
        return Column(dt.struct_dtype(fields), n, None, mask, children=children)
    starts = r < node.rep                 # an entry that begins a parent slot
    n_slots = int(starts.sum())
    slot_id = np.cumsum(starts) - 1
    elem_start = (r <= node.rep) & (d >= node.d_elem)
    counts = np.bincount(slot_id[elem_start], minlength=n_slots)[:n_slots]
    offsets = np.zeros(n_slots + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    mask = _mask(d[starts] >= node.d_present, device) if node.optional else None
    child_sel = {leaf.path: sel[leaf.path] & (streams[leaf.path][1] >= node.d_elem)
                 for leaf in node.leaves()}
    child = _assemble(node.children[0], streams, child_sel, device)
    return Column(dt.list_dtype(child.dtype), n_slots, None, mask,
                  torch.from_numpy(offsets).to(device), [child])


def read_parquet_nested(path: str, md, columns, row_groups, clock, filters=None) -> Table:
    """Every top-level field of a schema with nested fields (flat fields
    too) as a Table on ``clock.device``."""
    from cudf_tpu_torch.io.parquet_native import _rg_passes_filters
    from cudf_tpu_torch.ops import copying

    fields = schema_tree(md.schema)
    wanted = list(columns) if columns else [f.name for f in fields]
    groups = md.row_groups
    if row_groups is not None:
        groups = [groups[i] for i in row_groups]
    if filters:
        groups = [rg for rg in groups if _rg_passes_filters(rg, filters)]
    cols: Dict[str, List[Column]] = {n: [] for n in wanted}
    with open(path, "rb") as f:
        for rg in groups:
            by_path = {tuple(cc.path): cc for cc in rg.columns}
            for node in fields:
                if node.name not in cols:
                    continue
                streams = {leaf.path: read_chunk_levels(f, by_path[leaf.path], leaf, clock)
                           for leaf in node.leaves()}
                cols[node.name].append(assemble_node(node, streams, clock.device))
    out = {}
    for n in wanted:
        if not cols[n]:
            from cudf_tpu_torch.io.parquet_native import UnsupportedParquet

            raise UnsupportedParquet("no row group of a nested file selected")
        out[n] = copying.concatenate(cols[n])
    clock.mark("device")
    return Table(out)
