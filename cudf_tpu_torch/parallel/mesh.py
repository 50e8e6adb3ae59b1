"""Meshes of ranks, their collectives and row-partitioned frames (port of
``cudf_tpu/parallel/mesh.py``).

The reference's mesh is a jax ``Mesh`` of the devices of one program; here
a ``Mesh`` is a ``torch.distributed`` process group, one process a card
(NCCL) or a CPU process (gloo): this rank, the group's size and the device
this rank's tensors live on.  A 2-D mesh (``make_multislice_mesh``) holds
one subgroup an axis: the ranks of this rank's slice (``"x"``) and the
ranks of its index in every slice (``"dcn"``).

Every collective goes through a ``Mesh`` method, which counts its calls,
bytes and milliseconds by kind (``COLLECTIVES``; CUDA events on the card,
the host clock on the CPU).

A table crosses ranks as one byte buffer: each column's buffers (data,
validity, offsets, then its children's) one after another, each padded to
8 bytes, beside a header of int64s (a code of the column's dtype, its
length, each buffer's bytes or -1, its child count, then its children's).
The receiver rebuilds the columns as views of the received buffer, with
the dtypes of its own table of the same schema (``unpack_table``).
"""

from __future__ import annotations

import time
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.core.table import Table

# kind -> {"calls", "bytes", "ms"}: every collective since the last reset
COLLECTIVES: Dict[str, Dict[str, float]] = {}
_NODE = 6           # header ints a column node: code, length, 3 buffer sizes, children


def reset_collective_stats() -> None:
    COLLECTIVES.clear()


def collective_stats() -> Dict[str, Dict[str, float]]:
    """{kind: {"calls", "bytes", "ms"}} since the last reset."""
    return {k: dict(v) for k, v in COLLECTIVES.items()}


def _dist():
    import torch.distributed as dist

    return dist


class Mesh:
    """Ranks of a process group: ``rank`` and ``size`` within it, the
    ``device`` of this rank's tensors, and one group an axis name
    (``shape``: {axis: ranks along it}; a 1-D mesh has the one axis "x")."""

    def __init__(self, group=None, device=None, axis: str = "x",
                 groups: Optional[Dict[str, object]] = None,
                 shape: Optional[Dict[str, int]] = None):
        dist = _dist()
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        if device is None:
            device = (torch.device("cuda", torch.cuda.current_device())
                      if dist.get_backend(group) == "nccl" else torch.device("cpu"))
        self.device = torch.device(device)
        self.groups = dict(groups) if groups else {axis: group}
        self.shape = dict(shape) if shape else {axis: self.size}
        self.axis_names = tuple(self.shape)

    def __repr__(self):
        return f"Mesh(rank {self.rank} of {self.size}, {self.shape}, {self.device})"

    def axis(self, axis: Optional[str]) -> Tuple[object, int, int]:
        """(group, this rank's index, size) along ``axis`` (None: the
        whole mesh)."""
        if axis is None:
            return self.group, self.rank, self.size
        g = self.groups[axis]
        dist = _dist()
        return g, dist.get_rank(g), dist.get_world_size(g)

    # -- the collectives, counted ------------------------------------------
    def _timed(self, kind: str, nbytes: int, run):
        cuda = self.device.type == "cuda"
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        else:
            t0 = time.perf_counter()
        out = run()
        if cuda:
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            ms = (time.perf_counter() - t0) * 1e3
        s = COLLECTIVES.setdefault(kind, {"calls": 0, "bytes": 0, "ms": 0.0})
        s["calls"] += 1
        s["bytes"] += int(nbytes)
        s["ms"] += ms
        return out

    def all_to_all_single(self, out: torch.Tensor, inp: torch.Tensor,
                          out_splits: Optional[List[int]] = None,
                          in_splits: Optional[List[int]] = None, axis=None) -> torch.Tensor:
        group = self.axis(axis)[0]
        dist = _dist()
        self._timed("all_to_all_single", inp.numel() * inp.element_size(),
                    lambda: dist.all_to_all_single(out, inp, out_splits, in_splits, group=group))
        return out

    def all_gather(self, t: torch.Tensor, axis=None) -> List[torch.Tensor]:
        group, _, size = self.axis(axis)
        outs = [torch.empty_like(t) for _ in range(size)]
        dist = _dist()
        self._timed("all_gather", t.numel() * t.element_size(),
                    lambda: dist.all_gather(outs, t.contiguous(), group=group))
        return outs

    def all_reduce(self, t: torch.Tensor, op: str = "sum", axis=None) -> torch.Tensor:
        group = self.axis(axis)[0]
        dist = _dist()
        rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
               "min": dist.ReduceOp.MIN}[op]
        self._timed("all_reduce", t.numel() * t.element_size(),
                    lambda: dist.all_reduce(t, op=rop, group=group))
        return t

    def all_gather_object(self, obj, axis=None) -> list:
        """Every rank's picklable ``obj``, in rank order (host partials)."""
        import pickle

        group, _, size = self.axis(axis)
        out = [None] * size
        dist = _dist()
        self._timed("all_gather", len(pickle.dumps(obj)),
                    lambda: dist.all_gather_object(out, obj, group=group))
        return out

    # -- host scalars over every rank ------------------------------------
    def sum_ints(self, values: Sequence[int], axis=None) -> List[int]:
        t = torch.tensor([int(v) for v in values], dtype=torch.int64, device=self.device)
        return self.all_reduce(t, "sum", axis).tolist()

    def any_flags(self, flags: Sequence[bool], axis=None) -> List[bool]:
        t = torch.tensor([int(bool(f)) for f in flags], dtype=torch.int64, device=self.device)
        return [bool(v) for v in self.all_reduce(t, "max", axis).tolist()]


def make_mesh(n_devices: Optional[int] = None, axis: str = "x", device=None) -> Mesh:
    """A 1-D mesh over every rank of the default group (initialized by
    ``bootstrap.initialize`` for one process when no group is)."""
    from cudf_tpu_torch.parallel import bootstrap

    if not _dist().is_initialized():
        bootstrap.initialize(device=device)
    mesh = Mesh(None, device=device, axis=axis)
    if n_devices is not None and n_devices != mesh.size:
        raise ValueError(f"a mesh spans every rank of the group ({mesh.size}), not "
                         f"{n_devices}: start {n_devices} ranks")
    return mesh


def make_multislice_mesh(n_slices: int, per_slice: Optional[int] = None,
                         dcn_axis: str = "dcn", ici_axis: str = "x", device=None) -> Mesh:
    """A 2-D mesh of the ranks as [n_slices, per_slice], rank-major: axis
    ``ici_axis`` spans this rank's slice, ``dcn_axis`` the ranks of its
    index in every slice.  Every rank makes every subgroup
    (``new_group``'s rule), in one order."""
    from cudf_tpu_torch.parallel import bootstrap

    dist = _dist()
    if not dist.is_initialized():
        bootstrap.initialize(device=device)
    world = dist.get_world_size()
    per = per_slice if per_slice is not None else world // n_slices
    if n_slices * per != world:
        raise ValueError(f"{n_slices} slices of {per} ranks are not the {world} ranks")
    rank = dist.get_rank()
    mine = {}
    for s in range(n_slices):
        g = dist.new_group([s * per + i for i in range(per)])
        if rank // per == s:
            mine[ici_axis] = g
    for i in range(per):
        g = dist.new_group([s * per + i for s in range(n_slices)])
        if rank % per == i:
            mine[dcn_axis] = g
    return Mesh(None, device=device, groups=mine, shape={dcn_axis: n_slices, ici_axis: per})


# ----------------------------------------------------------------------
# tables as bytes
# ----------------------------------------------------------------------

def _code(dtype) -> int:
    return zlib.crc32(repr(dtype).encode())


def _nodes(col: Column) -> int:
    """Header nodes of a column of this schema (a DECIMAL128 counts its
    high limb, which a column holds only when its values need it)."""
    if col.dtype.is_decimal and col.dtype.id == dt.TypeId.DECIMAL128:
        return 2
    return 1 + sum(_nodes(c) for c in col.children)


def header_ints(template: Table) -> int:
    """The header row's length for tables of ``template``'s schema: the
    payload's bytes, the header's length, then the header."""
    return 2 + _NODE * sum(_nodes(c) for c in template.columns)


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def _pack_column(col: Column, header: List[int], chunks: List[torch.Tensor]) -> None:
    header += [_code(col.dtype), col.length]
    for b in (col.data, col.validity, col.offsets):
        if b is None:
            header.append(-1)
            continue
        raw = _as_bytes(b)
        header.append(raw.numel())
        chunks.append(raw)
        pad = -raw.numel() % 8
        if pad:
            chunks.append(torch.zeros(pad, dtype=torch.uint8, device=raw.device))
    header.append(len(col.children))
    for c in col.children:
        _pack_column(c, header, chunks)


def pack_table(t: Table, width: int) -> Tuple[List[int], torch.Tensor]:
    """(header row of ``width`` ints, payload uint8 on ``t``'s device) of
    ``t``: the payload's bytes and the header's length first
    (``header_ints``)."""
    header: List[int] = []
    chunks: List[torch.Tensor] = []
    for c in t.columns:
        _pack_column(c, header, chunks)
    dev = t.device
    payload = torch.cat(chunks) if chunks else torch.zeros(0, dtype=torch.uint8, device=dev)
    row = [payload.numel(), len(header)] + header
    if len(row) > width:
        raise ValueError(f"a header of {len(row)} ints outgrows the row of {width}")
    return row + [0] * (width - len(row)), payload


_LIMB = Column(dt.INT64, 0, torch.zeros(0, dtype=torch.int64))


def _unpack_column(template: Column, it, blob: torch.Tensor, pos: int):
    code, length, *sizes = [next(it) for _ in range(5)]
    if code != _code(template.dtype):
        raise ValueError(f"a rank sent another layout than {template.dtype!r}: the ranks' "
                         "tables differ in schema")
    kinds = (template.data.dtype if template.data is not None else torch.uint8,
             torch.bool, torch.int64)
    bufs = []
    for size, kind in zip(sizes, kinds):
        if size < 0:
            bufs.append(None)
            continue
        bufs.append(blob[pos:pos + size].view(kind))
        pos += size + (-size % 8)
    children = []
    for j in range(next(it)):
        tc = template.children[j] if j < len(template.children) else _LIMB
        child, pos = _unpack_column(tc, it, blob, pos)
        children.append(child)
    return Column(template.dtype, length, bufs[0], bufs[1], bufs[2], children), pos


def unpack_table(template: Table, row: List[int], blob: torch.Tensor) -> Table:
    """The table a rank packed (``pack_table``), as views of ``blob``, in
    ``template``'s names and dtypes."""
    it = iter(row[2:2 + row[1]])
    cols, pos = [], 0
    for c in template.columns:
        col, pos = _unpack_column(c, it, blob, pos)
        cols.append(col)
    return Table.from_pairs(template.names, cols)


def _concat(tables: Sequence[Table], like: Table) -> Table:
    from cudf_tpu_torch.ops.copying import concatenate_tables

    nonempty = [t for t in tables if t.num_rows > 0]
    if not nonempty:
        from cudf_tpu_torch.engine.streaming import empty_like

        return empty_like(like)
    return nonempty[0] if len(nonempty) == 1 else concatenate_tables(nonempty)


def gather_table(mesh: Mesh, t: Table, axis=None) -> Table:
    """Every rank's ``t`` (one schema) concatenated in rank order, on every
    rank: an all_gather of the header rows (payload sizes), then of the
    payloads padded to the largest, each trimmed and unpacked."""
    width = header_ints(t)
    row, payload = pack_table(t, width)
    row = torch.tensor(row, dtype=torch.int64).to(mesh.device)
    rows = torch.stack(mesh.all_gather(row, axis)).cpu().tolist()
    most = max(r[0] for r in rows)
    padded = torch.zeros(most, dtype=torch.uint8, device=payload.device)
    padded[:payload.numel()] = payload
    blobs = mesh.all_gather(padded, axis)
    return _concat([unpack_table(t, r, b[:r[0]]) for r, b in zip(rows, blobs)], t)


# ----------------------------------------------------------------------
# frames over a mesh
# ----------------------------------------------------------------------

def row_range(n_rows: int, rank: int, size: int) -> Tuple[int, int]:
    """Rank ``rank``'s rows of ``n_rows`` cut evenly (the last ranks may
    hold fewer, or none)."""
    per = -(-n_rows // size) if n_rows else 0
    return min(rank * per, n_rows), min((rank + 1) * per, n_rows)


def one_dictionary(mesh: Mesh, col: Column) -> Column:
    """A STRING or dictionary column over the sorted dictionary of every
    rank's values: an all_gather of each rank's distinct values."""
    from cudf_tpu_torch.ops.dictionary import encode, unify_dictionaries

    keys = encode(col).keys
    every = gather_table(mesh, Table({"k": keys}))["k"]
    return unify_dictionaries([every, col])[1]


def partition_frame(df, mesh: Mesh):
    """This rank's rows of ``df`` (every rank holds the whole frame: the
    same plan on the same data), as a DataFrame.  A STRING column is put
    over one dictionary across the ranks, so every rank's codes mean the
    same values (the reference's ``dict_encode``)."""
    from cudf_tpu_torch.frame.dataframe import DataFrame
    from cudf_tpu_torch.frame.index import default_index
    from cudf_tpu_torch.ops import copying

    t = df._table
    lo, hi = row_range(t.num_rows, mesh.rank, mesh.size)
    cols = []
    for c in t.columns:
        part = copying.slice(c, lo, hi)
        if part.dtype.is_string:
            part = one_dictionary(mesh, part)
        cols.append(part)
    out = Table.from_pairs(t.names, cols)
    return DataFrame._from(out, default_index(out.num_rows))


def collect_frame(part, mesh: Mesh):
    """Every rank's part (a DataFrame or a Table) in rank order, on every
    rank, as a DataFrame (the reference's caller's whole table)."""
    from cudf_tpu_torch.frame.dataframe import DataFrame
    from cudf_tpu_torch.frame.index import default_index

    t = part._table if hasattr(part, "_table") else part
    out = gather_table(mesh, t)
    return DataFrame._from(out, default_index(out.num_rows))
