"""Distributed relational ops over a mesh of ranks (port of
``cudf_tpu/parallel/dist.py``).

Every function is called by every rank of the mesh with its own rows
(tensors or Columns, and an optional ``valid`` mask of the rows that
count) and returns its own share of the answer; ``collect_frame`` or
``mesh.gather_table`` gives every rank the whole.  Each runs the port's
partitioned executor (``engine/streaming.py``) over the rank's rows with
``engine/spmd.py``'s collectives, so every local step is the port's own
tier: a groupby's partials and merge take the kernel tiers (one-hot A, or
the radix tier B, F, G, D) or the sort tier, a join the radix tier (D',
H) or sort-merge, a sort the port's multi-key sort.

The reference's results are padded to static shapes, with a valid mask
and a ``dropped`` count of rows a capacity lost.  Here results hold only
their rows: each ``valid`` returned is all True and each ``dropped`` is 0
(the exchange is lossless), kept so that callers of the reference's
tuples read these alike.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.core.table import Table
from cudf_tpu_torch.parallel.mesh import Mesh, gather_table, partition_frame
from cudf_tpu_torch.parallel.shuffle import _frame, as_column, received_mask


def _no_drops() -> torch.Tensor:
    """The reference's ``dropped`` count: nothing is dropped here."""
    return torch.zeros(1, dtype=torch.int64)


def _run(node, mesh: Mesh) -> Table:
    """This rank's share of ``node`` over the mesh's ranks."""
    from cudf_tpu_torch.engine.spmd import Ranks
    from cudf_tpu_torch.engine.streaming import _eval, _gather, _unspill

    return _gather([_unspill(p) for p in _eval(node, Ranks(mesh))])


def _source(t: Table):
    from cudf_tpu_torch.engine.streaming import Partitions

    return Partitions([t])


# ----------------------------------------------------------------------
# groupby: partials, shuffle, merge
# ----------------------------------------------------------------------

def dist_groupby_agg(mesh: Mesh, keys: Sequence, vals_ops: Sequence, valid=None):
    """Groupby of this rank's rows with every rank's: partial aggregations
    here, a hash shuffle of the partials by key, a merge on the rank that
    owns each key (the reference's ``dist_groupby_agg_shard``).  ``vals_ops``
    are (values, op) with op in sum, count, min, max, mean, var, std (var and
    std merged by Chan's formula).  Returns ([keys], [aggregates], counts of
    rows a group, valid, dropped), this rank's groups in ascending key
    order."""
    out = _groupby_table(mesh, keys, vals_ops, valid)
    names = [f"k{i}" for i in range(len(keys))]
    return ([out[k].data for k in names], [out[f"a{j}"] for j in range(len(vals_ops))],
            out["__count"].data, received_mask(out), _no_drops())


def _groupby_table(mesh: Mesh, keys: Sequence, vals_ops: Sequence, valid=None) -> Table:
    """This rank's groups as a table: keys k0.., aggregates a0.., and
    ``__count``, in ascending key order."""
    from cudf_tpu_torch.engine.expr import Agg, col
    from cudf_tpu_torch.engine import ir as IRs

    t = _frame(keys, [v for v, _ in vals_ops], valid)
    names = [f"k{i}" for i in range(len(keys))]
    aggs = [Agg(col(f"p{j}"), op).alias(f"a{j}") for j, (_, op) in enumerate(vals_ops)]
    aggs.append(Agg(col(names[0]), "size").alias("__count"))
    return _sorted(_run(IRs.GroupBy(_source(t), names, aggs), mesh), names)


def _sorted(t: Table, by: Sequence[str]) -> Table:
    from cudf_tpu_torch.ops import copying, row_ops

    if t.num_rows < 2:
        return t
    order = row_ops.lex_sort_indices([t[b] for b in by], [True] * len(by), "last")
    return copying.gather_table(t, order, bounds_check=False)


def dist_groupby_sum_multi(mesh: Mesh, keys: Sequence, vals: Sequence, valid=None):
    """Multi-key groupby sum (and count) of every rank's rows.  Returns
    ([keys], [sums], counts, valid, dropped): this rank's groups."""
    k, a, cnt, v, d = dist_groupby_agg(mesh, keys, [(x, "sum") for x in vals], valid)
    return k, [c.data for c in a], cnt, v, d


def dist_groupby_sum(mesh: Mesh, key, vals: Sequence, valid=None):
    """One key's groupby sum: (keys, [sums], counts, valid)."""
    ks, sums, cnt, v, _ = dist_groupby_sum_multi(mesh, [key], vals, valid)
    return ks[0], sums, cnt, v


def distributed_groupby_agg(df, key_name: str, value_names: Sequence[str], mesh: Mesh,
                            aggs: Sequence[str] = ("sum",)):
    """A groupby of a DataFrame every rank holds whole: each rank takes its
    rows (``partition_frame``: a STRING key over one dictionary across the
    ranks), the groups are aggregated over the mesh, and every rank gets the
    whole result, sorted by key.  Columns: the key, ``{v}_sum`` and
    ``{v}_mean`` a value (as ``aggs`` asks), then ``count``."""
    from cudf_tpu_torch.frame.dataframe import DataFrame
    from cudf_tpu_torch.frame.index import default_index

    part = partition_frame(df[[key_name, *value_names]], mesh)._table
    g = _groupby_table(mesh, [part[key_name]], [(part[v], "sum") for v in value_names])
    cnt = g["__count"].data
    cols = {key_name: g["k0"]}
    for j, name in enumerate(value_names):
        s = g[f"a{j}"]
        if "sum" in aggs:
            cols[f"{name}_sum"] = s
        if "mean" in aggs:
            cols[f"{name}_mean"] = Column.from_tensor(s.data.double() / cnt.double())
    if "count" in aggs:
        cols["count"] = g["__count"]
    whole = gather_table(mesh, Table(cols))
    whole = Table.from_pairs(whole.names, [c.decode_dictionary() for c in whole.columns])
    out = _sorted(whole, [key_name])
    return DataFrame._from(out, default_index(out.num_rows))


def dist_groupby_sum_multislice(mesh: Mesh, keys: Sequence, vals: Sequence, valid=None,
                                dcn_axis: str = "dcn", ici_axis: str = "x"):
    """The groupby sum over a 2-D mesh: partials here, the hierarchical
    shuffle (within this rank's slice, then across slices, each row once;
    ``shuffle_by_keys_2d``), a merge.  Returns as ``dist_groupby_sum_multi``."""
    from cudf_tpu_torch.ops import groupby as gb
    from cudf_tpu_torch.parallel.shuffle import shuffle_by_keys_2d

    t = _frame(keys, vals, valid)
    nk, nv = len(keys), len(vals)
    kt = t.select([f"k{i}" for i in range(nk)])
    gk, ga = gb.groupby_agg(kt, [(f"s{j}", t[f"p{j}"], "sum") for j in range(nv)]
                            + [("c", t["k0"], "size")])
    rk, rp, _, _ = shuffle_by_keys_2d(mesh, [gk[f"k{i}"] for i in range(nk)],
                                      [ga[f"s{j}"] for j in range(nv)] + [ga["c"]],
                                      dcn_axis=dcn_axis, ici_axis=ici_axis)
    mk = Table.from_pairs([f"k{i}" for i in range(nk)], [as_column(x) for x in rk])
    mk_out, m = gb.groupby_agg(mk, [(f"s{j}", as_column(rp[j]), "sum") for j in range(nv)]
                               + [("c", as_column(rp[-1]), "sum")])
    return ([mk_out[f"k{i}"].data for i in range(nk)], [m[f"s{j}"].data for j in range(nv)],
            m["c"].data, received_mask(mk_out), _no_drops())


# ----------------------------------------------------------------------
# joins
# ----------------------------------------------------------------------

def _join(mesh: Mesh, left_keys, left_payload, left_valid, right_keys, right_payload,
          right_valid, how: str, broadcast: bool) -> Table:
    """Both sides as tables (keys k0.. alike on both; payloads l0.., r0..;
    markers __l, __r) joined over the mesh by the engine's Join: shuffled
    by key hash, or the right side gathered to every rank."""
    from cudf_tpu_torch.engine import ir as IRs
    from cudf_tpu_torch.utils.config import option_context

    nk = len(left_keys)
    lt = _frame(left_keys, left_payload, left_valid)
    rt = _frame(right_keys, right_payload, right_valid)
    lt = Table.from_pairs([*(f"k{i}" for i in range(nk)), *(f"l{j}" for j in range(
        len(left_payload)))], list(lt.columns))
    rt = Table.from_pairs([*(f"k{i}" for i in range(nk)), *(f"r{j}" for j in range(
        len(right_payload)))], list(rt.columns))
    dev = lt.device or rt.device
    lt = lt.insert("__l", Column.from_tensor(torch.ones(lt.num_rows, dtype=torch.bool,
                                                        device=dev)))
    rt = rt.insert("__r", Column.from_tensor(torch.ones(rt.num_rows, dtype=torch.bool,
                                                        device=dev)))
    on = [f"k{i}" for i in range(nk)]
    limit = (1 << 62) if broadcast else 0
    with option_context("executor.broadcast_limit", limit):
        return _run(IRs.Join(_source(lt), _source(rt), on, on, how), mesh)


def _filled(c: Column) -> torch.Tensor:
    """A payload's values, 0 where it is null (the reference's padding)."""
    if c.validity is None:
        return c.data
    return torch.where(c.validity, c.data, torch.zeros_like(c.data))


def _present(t: Table, name: str) -> torch.Tensor:
    c = t[name]
    if c.validity is None:
        return torch.ones(t.num_rows, dtype=torch.bool, device=c.device)
    return c.validity.clone()


def dist_join(mesh: Mesh, left_keys: Sequence, left_payload: Sequence, left_valid,
              right_keys: Sequence, right_payload: Sequence, right_valid,
              how: str = "inner"):
    """The hash-shuffle join of every rank's rows, multi-key, ``how`` in
    inner, left, full, semi, anti.  Returns this rank's ([keys], left
    payloads, right payloads, valid, right matched, dropped); for "full"
    ([keys], left, right, valid, left present, right present, dropped),
    the keys from whichever side is present; for semi and anti the
    selected left rows ([keys], left payloads, [], valid, valid, dropped).
    Payloads are 0 where their side is absent, as the reference pads."""
    nk, nl, nr = len(left_keys), len(left_payload), len(right_payload)
    engine_how = {"full": "full", "outer": "full"}.get(how, how)
    out = _join(mesh, left_keys, left_payload, left_valid, right_keys, right_payload,
                right_valid, engine_how, broadcast=False)
    keys = [_filled(out[f"k{i}"]) for i in range(nk)]
    lp = [_filled(out[f"l{j}"]) for j in range(nl)]
    ok = received_mask(out)
    if how in ("semi", "anti"):
        return keys, lp, [], ok, ok.clone(), _no_drops()
    rp = [_filled(out[f"r{j}"]) for j in range(nr)]
    if engine_how == "full":
        return keys, lp, rp, ok, _present(out, "__l"), _present(out, "__r"), _no_drops()
    return keys, lp, rp, ok, _present(out, "__r"), _no_drops()


def dist_inner_join(mesh: Mesh, left_key, left_payload: Sequence, left_valid, right_key,
                    right_payload: Sequence, right_valid):
    """One key's inner join: (keys, left payloads, right payloads, valid)."""
    keys, out_l, out_r, ok, _, _ = dist_join(mesh, [left_key], left_payload, left_valid,
                                             [right_key], right_payload, right_valid)
    return keys[0], out_l, out_r, ok


def broadcast_inner_join(mesh: Mesh, left_key, left_payload: Sequence, left_valid, right_key,
                         right_payload: Sequence, right_valid):
    """The inner join with the right side gathered to every rank
    (``all_gather``) and joined here against this rank's left rows, which
    stay where they are: (keys, left payloads, right payloads, valid)."""
    out = _join(mesh, [left_key], left_payload, left_valid, [right_key], right_payload,
                right_valid, "inner", broadcast=True)
    return (out["k0"].data, [out[f"l{j}"].data for j in range(len(left_payload))],
            [out[f"r{j}"].data for j in range(len(right_payload))], received_mask(out))


# ----------------------------------------------------------------------
# sample sort and distinct
# ----------------------------------------------------------------------

def dist_sort(mesh: Mesh, key, payloads: Sequence = (), valid=None, descending=False):
    """The sample sort of every rank's rows: splitters from an
    ``all_gather`` of every rank's samples, each row to the rank of its
    key range (``all_to_all_single``), then a local sort.  Rank r holds the
    r-th key range, sorted: the ranks' rows in rank order are the stable
    total order.  ``key`` may be a list of keys (lexicographic), and
    ``descending`` a list alike.  Returns (key or [keys], payloads, valid,
    dropped)."""
    from cudf_tpu_torch.engine import ir as IRs

    many = isinstance(key, (list, tuple))
    keys = list(key) if many else [key]
    desc = list(descending) if isinstance(descending, (list, tuple)) else \
        [bool(descending)] * len(keys)
    t = _frame(keys, payloads, valid)
    by = [f"k{i}" for i in range(len(keys))]
    out = _run(IRs.Sort(_source(t), by, desc), mesh)
    ks = [out[b].data for b in by]
    return (ks if many else ks[0], [out[f"p{j}"].data for j in range(len(payloads))],
            received_mask(out), _no_drops())


def dist_distinct(mesh: Mesh, keys: Sequence, valid=None):
    """The distinct key tuples of every rank's rows: a local distinct, a
    shuffle by the keys, a distinct again.  Returns this rank's ([keys],
    valid, dropped)."""
    from cudf_tpu_torch.engine import ir as IRs

    t = _frame(keys, (), valid)
    out = _run(IRs.Distinct(_source(t)), mesh)
    return [out[f"k{i}"].data for i in range(len(keys))], received_mask(out), _no_drops()


# ----------------------------------------------------------------------
# approximate quantiles: t-digests merged across the ranks
# ----------------------------------------------------------------------

def dist_tdigest(mesh: Mesh, x, valid=None, delta: int = 100):
    """The t-digest of every rank's values: this rank's digest
    (``ops/tdigest.build_tdigest``), every rank's centroids, minimum and
    maximum gathered (``all_gather``), merged (``merge_tdigests``).  Returns
    (means[delta], weights[delta], min[1], max[1]), the same on every
    rank."""
    from cudf_tpu_torch.ops.tdigest import TDigest, build_tdigest, merge_tdigests

    col = as_column(x)
    if valid is not None:
        v = torch.as_tensor(valid, device=col.device)
        col = col.with_validity(v if col.validity is None else col.validity & v)
    d = build_tdigest(col, delta)
    ends = torch.tensor([d.min, d.max], dtype=torch.float64, device=mesh.device)
    means = mesh.all_gather(d.means.to(mesh.device))
    weights = mesh.all_gather(d.weights.to(mesh.device))
    mm = mesh.all_gather(ends)
    merged = merge_tdigests([TDigest(m, w, float(e[0]), float(e[1]))
                             for m, w, e in zip(means, weights, mm)], delta)
    dev = merged.means.device
    return (merged.means, merged.weights,
            torch.tensor([merged.min], dtype=torch.float64, device=dev),
            torch.tensor([merged.max], dtype=torch.float64, device=dev))


def dist_quantile(mesh: Mesh, x, valid, percentiles, delta: int = 100) -> np.ndarray:
    """Approximate quantiles of every rank's values (percentile_approx of
    the merged t-digest), as a numpy array, the same on every rank."""
    from cudf_tpu_torch.ops.tdigest import TDigest, percentile_approx

    means, weights, mn, mx = dist_tdigest(mesh, x, valid, delta)
    col = percentile_approx(TDigest(means, weights, float(mn[0]), float(mx[0])), percentiles)
    return col.data.cpu().numpy()


__all__: List[str] = [
    "dist_groupby_agg", "dist_groupby_sum", "dist_groupby_sum_multi",
    "distributed_groupby_agg", "dist_groupby_sum_multislice", "dist_join",
    "dist_inner_join", "broadcast_inner_join", "dist_sort", "dist_distinct",
    "dist_tdigest", "dist_quantile",
]
