"""Hash shuffles between ranks (port of ``cudf_tpu/parallel/shuffle.py``).

The reference's shuffle runs inside one XLA program with static shapes: a
[P, C] padded send buffer a value array, ``lax.all_to_all``, a capacity C
and a count of the rows it had to drop.  Here the exchange is two
``all_to_all_single`` calls between processes: first each rank's header
rows (a row a destination: the bytes and layout of the rows bound there,
``mesh.pack_table``), then the rows themselves with those split sizes.
Nothing is padded and nothing is dropped, so ``dropped`` is always 0 and
no capacity is chosen.  Validity, offsets and children travel as buffers
of their own in the same bytes.

A row's destination is the port's ``row_hash`` mod P
(``ops/partitioning.partition_ids``): a row lands on the rank whose index
is the partition ``engine/streaming.py``'s ``_shuffle`` sends it to.

Every function here is called by every rank of the mesh with its own rows.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.core.table import Table
from cudf_tpu_torch.parallel.mesh import Mesh, _concat, header_ints, pack_table, unpack_table


def as_column(x) -> Column:
    """A Column, or a 1-D tensor wrapped as one."""
    return x if isinstance(x, Column) else Column.from_tensor(x)


def key_hash(key) -> torch.Tensor:
    """int64 hash of one key column (``ops/row_ops.row_hash``)."""
    return row_hash([key])


def row_hash(keys: Sequence) -> torch.Tensor:
    """int64 hash of each row of the key columns, null rows alike."""
    from cudf_tpu_torch.ops.row_ops import row_hash as _row_hash

    return _row_hash([as_column(k) for k in keys])


def bucketize(table: Table, pids: torch.Tensor, num_parts: int) -> Tuple[Table, List[int]]:
    """The rows stably ordered by destination (``partition_by_ids``) and
    each destination's offsets [num_parts + 1], on the host."""
    from cudf_tpu_torch.ops.partitioning import partition_by_ids

    if table.num_rows == 0:
        return table, [0] * (num_parts + 1)
    reordered, offsets = partition_by_ids(table, pids, num_parts)
    return reordered, offsets.tolist()


def _share_keys(tables: List[Table]) -> List[Table]:
    """Pieces whose dictionary columns hold equal keys share one keys
    column, so their concatenation needs no re-encoding."""
    if len(tables) < 2:
        return tables
    out = [tables[0]]
    for t in tables[1:]:
        cols = []
        for n, c in t.items():
            first = out[0][n]
            if c.dtype.is_dictionary and first.dtype.is_dictionary and \
                    c.keys is not first.keys and _same_keys(c.keys, first.keys):
                c = Column(c.dtype, c.length, c.data, c.validity, c.offsets, first.children)
            cols.append(c)
        out.append(Table.from_pairs(t.names, cols))
    return out


def _same_keys(a: Column, b: Column) -> bool:
    if a.dtype != b.dtype or a.length != b.length:
        return False
    if a.dtype.is_string:
        return torch.equal(a.offsets, b.offsets) and torch.equal(a.data, b.data)
    return torch.equal(a.data, b.data)


def exchange(mesh: Mesh, table: Table, offsets: Sequence[int], axis=None) -> Table:
    """Rows ``offsets[i]:offsets[i + 1]`` of ``table`` to rank i of the
    mesh (of ``axis``); the rows every rank sent here, source rank by
    source rank, each source's in its order.  The header rows are swapped
    first (``all_to_all_single``, one row a rank), then the bytes with
    split sizes."""
    from cudf_tpu_torch.ops import copying

    _, _, size = mesh.axis(axis)
    width = header_ints(table)
    rows, payloads = [], []
    for i in range(size):
        piece = Table.from_pairs(table.names, [copying.slice(c, offsets[i], offsets[i + 1])
                                               for c in table.columns])
        row, payload = pack_table(piece, width)
        rows.append(row)
        payloads.append(payload)
    send_rows = torch.tensor(rows, dtype=torch.int64).to(mesh.device)
    recv_rows = torch.empty_like(send_rows)
    mesh.all_to_all_single(recv_rows, send_rows, axis=axis)
    got = recv_rows.cpu().tolist()
    in_splits = [p.numel() for p in payloads]
    out_splits = [r[0] for r in got]
    send = torch.cat(payloads) if payloads else torch.zeros(0, dtype=torch.uint8)
    recv = torch.empty(sum(out_splits), dtype=torch.uint8, device=mesh.device)
    mesh.all_to_all_single(recv, send.to(mesh.device), out_splits, in_splits, axis=axis)
    pieces, pos = [], 0
    for r in got:
        pieces.append(unpack_table(table, r, recv[pos:pos + r[0]]))
        pos += r[0]
    return _concat(_share_keys(pieces), table)


def exchange_by_ids(mesh: Mesh, table: Table, pids: Optional[torch.Tensor], axis=None) -> Table:
    """Each row of ``table`` to rank ``pids[row]`` (int32) of the mesh."""
    _, _, size = mesh.axis(axis)
    reordered, offsets = bucketize(table, pids, size)
    return exchange(mesh, reordered, offsets, axis)


def received_mask(table: Table) -> torch.Tensor:
    """bool[rows]: every received row is a row (no padding to mask out)."""
    dev = table.device if table.device is not None else "cpu"
    return torch.ones(table.num_rows, dtype=torch.bool, device=dev)


def _frame(keys: Sequence, payloads: Sequence, valid) -> Table:
    """Keys k0.. and payloads p0.. as a table of the valid rows."""
    from cudf_tpu_torch.ops import copying
    from cudf_tpu_torch.ops.stream_compaction import filter_indices

    cols = [as_column(k) for k in keys] + [as_column(p) for p in payloads]
    names = [f"k{i}" for i in range(len(keys))] + [f"p{i}" for i in range(len(payloads))]
    t = Table.from_pairs(names, cols)
    if valid is not None and not bool(torch.as_tensor(valid).all()):
        t = copying.gather_table(t, filter_indices(torch.as_tensor(valid, device=t.device)),
                                 bounds_check=False)
    return t


def _unframe(t: Table, nk: int, np_: int):
    return ([t[f"k{i}"].data for i in range(nk)], [t[f"p{i}"].data for i in range(np_)])


def shuffle_by_keys(mesh: Mesh, keys: Sequence, payloads: Sequence = (), valid=None, axis=None):
    """Rows (of the valid ones) to rank ``row_hash(keys) % P``.  Returns
    (keys received, payloads received, valid received, dropped = 0)."""
    from cudf_tpu_torch.ops.partitioning import partition_ids

    t = _frame(keys, payloads, valid)
    _, _, size = mesh.axis(axis)
    pids = partition_ids([t[f"k{i}"] for i in range(len(keys))], size)
    out = exchange_by_ids(mesh, t, pids, axis)
    k, p = _unframe(out, len(keys), len(payloads))
    return k, p, received_mask(out), torch.zeros(1, dtype=torch.int64)


def shuffle_by_key(mesh: Mesh, key, payloads: Sequence = (), valid=None, axis=None):
    """One key's shuffle: (key received, payloads, valid, dropped = 0)."""
    k, p, m, d = shuffle_by_keys(mesh, [key], payloads, valid, axis)
    return k[0], p, m, d


def shuffle_by_keys_2d(mesh: Mesh, keys: Sequence, payloads: Sequence = (), valid=None,
                       dcn_axis: str = "dcn", ici_axis: str = "x"):
    """The hierarchical shuffle over a 2-D mesh: rows first move within
    this rank's slice to the rank of their destination's index there
    (``ici_axis``), then across slices (``dcn_axis``) to their
    destination, so each row crosses between slices at most once.  The
    destination of a row is ``row_hash(keys) % P`` over all P ranks, slice
    ``pid // per_slice``, index ``pid % per_slice``."""
    from cudf_tpu_torch.ops.partitioning import partition_ids

    n_dcn, n_ici = mesh.shape[dcn_axis], mesh.shape[ici_axis]
    t = _frame(keys, payloads, valid)
    pid = partition_ids([t[f"k{i}"] for i in range(len(keys))], n_dcn * n_ici)
    t = t.insert("__slice", Column.from_tensor((pid // n_ici).to(torch.int32)))
    a = exchange_by_ids(mesh, t, (pid % n_ici).to(torch.int32), ici_axis)
    b = exchange_by_ids(mesh, a, a["__slice"].data, dcn_axis)
    k, p = _unframe(b, len(keys), len(payloads))
    return k, p, received_mask(b), torch.zeros(1, dtype=torch.int64)
