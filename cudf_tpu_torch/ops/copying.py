"""Copying (port of ``cudf_tpu/ops/copying.py``: ``gather``,
``gather_table``, ``scatter``, ``scatter_scalar``, ``slice``, ``split``,
``concatenate``, ``concatenate_tables``, ``copy_if_else``, ``shift``,
``repeat``, ``tile``, ``interleave_columns``, ``get_element``,
``sample``, ``sequence`` and ``reverse``).

Fixed-width and temporal columns gather their data; a dictionary column
gathers its int32 codes and keeps its keys; a STRING column gathers row
lengths, scans them into new offsets (one host sync for the byte count)
and gathers its bytes; a LIST column does the same with its lengths and
its child, a STRUCT column gathers each field, and a two-limb decimal its
high limb beside its data.  Dictionaries over different keys meet over
the union of their keys (``ops/dictionary.py`` ``match_dictionaries``).
``scatter`` into a STRING, LIST, STRUCT or two-limb decimal target gathers
the target's rows and the source's, one after the other.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.core.table import Table
from cudf_tpu_torch.ops._utils import materialize_validity, segment_expand, signed_view

def gather(col: Column, gather_map: torch.Tensor, bounds_check: bool = True) -> Column:
    """out[i] = col[gather_map[i]].  With bounds_check, negative or
    out-of-range indices give nulls (libcudf out_of_bounds_policy::NULLIFY);
    without it the map must be in range."""
    m = gather_map.shape[0]
    in_range = None
    if bounds_check:
        in_range = (gather_map >= 0) & (gather_map < col.length)
        if col.length == 0:
            # every row is out of range: all nulls
            return _all_null(col, m)
        gather_map = torch.where(in_range, gather_map, 0)
    validity = None if col.validity is None else col.validity[gather_map]
    if in_range is not None:
        validity = in_range if validity is None else validity & in_range
    if col.dtype.is_string:
        return _gather_strings(col, gather_map, in_range, validity)
    if col.dtype.is_list:
        return _gather_lists(col, gather_map, in_range, validity)
    if col.dtype.is_struct:
        return Column(col.dtype, m, None, validity, children=[
            gather(c, gather_map, bounds_check=False) for c in col.children])
    return Column(col.dtype, m, _take(col.data, gather_map), validity,
                  children=_row_children(col, lambda c: gather(c, gather_map, False)))


def _row_children(col: Column, fn):
    """A column's children after a row op: a two-limb decimal's high limb
    takes the op, a dictionary's keys stay."""
    return [fn(c) for c in col.children] if col.dtype.is_decimal else col.children


def _all_null(col: Column, m: int) -> Column:
    dev = col.device
    none = torch.zeros(m, dtype=torch.bool, device=dev)
    if col.dtype.is_string:
        return Column(col.dtype, m, torch.zeros(0, dtype=torch.uint8, device=dev), none,
                      torch.zeros(m + 1, dtype=torch.int64, device=dev))
    if col.dtype.is_list:
        return Column(col.dtype, m, None, none, torch.zeros(m + 1, dtype=torch.int64, device=dev),
                      [slice(col.children[0], 0, 0)])
    if col.dtype.is_struct:
        return Column(col.dtype, m, None, none, children=[_all_null(c, m) for c in col.children])
    return Column(col.dtype, m, torch.zeros(m, dtype=col.data.dtype, device=dev), none,
                  children=_row_children(col, lambda c: _all_null(c, m)))


def _gather_lists(col: Column, rows: torch.Tensor, in_range, validity) -> Column:
    """The rows' lists, one after another: new offsets from the gathered
    lengths (one host sync for the element count), then one gather of
    the child."""
    from cudf_tpu_torch.ops.lists import make_list_column, offsets_of

    starts = col.offsets[rows]
    lens = col.offsets[rows + 1] - starts
    if in_range is not None:
        lens = torch.where(in_range, lens, 0)
    offsets = offsets_of(lens)
    total = int(offsets[-1])
    elem = segment_expand(offsets, total)
    src = starts[elem] + torch.arange(total, dtype=torch.int64, device=col.device) - offsets[elem]
    return make_list_column(offsets, gather(col.children[0], src, bounds_check=False), validity)


def _gather_strings(col: Column, rows: torch.Tensor, in_range, validity) -> Column:
    """The rows' bytes, one after another, and their new offsets."""
    starts = col.offsets[rows]
    lengths = col.offsets[rows + 1] - starts
    if in_range is not None:
        lengths = torch.where(in_range, lengths, 0)
    offsets = torch.zeros(rows.shape[0] + 1, dtype=torch.int64, device=col.device)
    torch.cumsum(lengths, 0, out=offsets[1:])
    from cudf_tpu_torch.ops.strings import gather_ranges

    return Column(dt.STRING, rows.shape[0], gather_ranges(col.data, starts, offsets), validity,
                  offsets)


def _take(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """data[idx]; uint16/32/64 through their signed view (CUDA indexes no
    such unsigned type)."""
    return signed_view(data)[idx].view(data.dtype)


def gather_table(table: Table, gather_map: torch.Tensor, bounds_check: bool = True) -> Table:
    return Table.from_pairs(table.names,
                            [gather(c, gather_map, bounds_check) for c in table.columns])


def scatter(source: Column, scatter_map: torch.Tensor, target: Column) -> Column:
    """target[scatter_map[i]] = source[i] (cudf::scatter), in target's
    dtype; the target is not modified.  A STRING target gathers its rows
    and the source's, one after the other."""
    if target.dtype.is_string or target.dtype.is_nested or (
            target.dtype.is_decimal and (target.children or source.children)):
        from cudf_tpu_torch.ops.unary import cast

        rows = torch.arange(target.length, device=target.device)
        rows[scatter_map.long()] = target.length + torch.arange(
            scatter_map.shape[0], device=target.device)
        return gather(concatenate([target, cast(source, target.dtype)]), rows,
                      bounds_check=False)
    if target.dtype.is_dictionary:
        from cudf_tpu_torch.ops.dictionary import encode, match_dictionaries

        source = encode(source)
        if source.keys is not target.keys:
            target, source = match_dictionaries(target, source)
    smap = scatter_map.long()
    data = target.data.clone()
    signed_view(data)[smap] = signed_view(source.data.to(target.data.dtype))
    validity = None
    if target.validity is not None or source.validity is not None:
        validity = materialize_validity(target).clone()
        validity[smap] = materialize_validity(source)
    return Column(target.dtype, target.length, data, validity, children=target.children)


def slice(col: Column, start: int, stop: int) -> Column:  # noqa: A001
    start = max(0, min(start, col.length))
    stop = max(start, min(stop, col.length))
    if col.dtype.is_string:
        return gather(col, torch.arange(start, stop, device=col.device), bounds_check=False)
    validity = None if col.validity is None else col.validity[start:stop]
    if col.dtype.is_list:
        offs = col.offsets[start:stop + 1]
        c0, c1 = offs[[0, -1]].tolist()
        return Column(col.dtype, stop - start, None, validity, offs - c0,
                      [slice(col.children[0], c0, c1)])
    if col.dtype.is_struct:
        return Column(col.dtype, stop - start, None, validity,
                      children=[slice(c, start, stop) for c in col.children])
    return Column(col.dtype, stop - start, col.data[start:stop], validity,
                  children=_row_children(col, lambda c: slice(c, start, stop)))


def split(col: Column, splits: Sequence[int]) -> List[Column]:
    bounds = [0, *splits, col.length]
    return [slice(col, bounds[i], bounds[i + 1]) for i in range(len(bounds) - 1)]


def concatenate(cols: Sequence[Column]) -> Column:
    """Vertical concat; mixed numeric dtypes are promoted as numpy
    promotes them, temporal units to the finest; dictionary columns must
    share their keys column."""
    cols = list(cols)
    if not cols:
        raise ValueError("need at least one column")
    if len(cols) == 1:
        return cols[0]
    validity = None
    if any(c.validity is not None for c in cols):
        validity = torch.cat([materialize_validity(c) for c in cols])
    first = cols[0]
    if first.dtype.is_string:
        if not all(c.dtype.is_string for c in cols):
            raise TypeError("cannot concatenate STRING and non-STRING columns")
        shift, offsets = 0, [first.offsets[:1]]
        for c in cols:
            offsets.append(c.offsets[1:] + shift)
            shift = shift + c.offsets[-1]
        off = torch.cat(offsets)
        return Column(dt.STRING, off.shape[0] - 1, torch.cat([c.data for c in cols]),
                      validity, off)
    if first.dtype.is_nested:
        return _concatenate_nested(cols, validity)
    if first.dtype.is_decimal:
        return _concatenate_decimals(cols, validity)
    if first.dtype.is_dictionary:
        if any(not c.dtype.is_dictionary or c.keys is not first.keys for c in cols):
            from cudf_tpu_torch.ops.dictionary import unify_dictionaries

            cols = unify_dictionaries(cols)
            first = cols[0]
        data = torch.cat([c.data for c in cols])
        return Column(first.dtype, data.shape[0], data, validity, children=first.children)
    target = first.dtype
    for c in cols[1:]:
        target = dt.common_dtype(target, c.dtype)
    if target.is_temporal:
        from cudf_tpu_torch.ops.unary import cast

        cols = [cast(c, target) for c in cols]
    data = torch.cat([signed_view(c.data.to(target.torch_storage)) for c in cols])
    data = data.view(target.torch_storage)
    return Column(target, data.shape[0], data, validity)


def _concatenate_nested(cols: Sequence[Column], validity) -> Column:
    """LIST columns: the children one after another, the offsets shifted;
    STRUCT columns: field by field.  The dtypes must agree."""
    first = cols[0]
    if any(c.dtype.id != first.dtype.id for c in cols):
        raise TypeError(f"cannot concatenate {first.dtype!r} with other layouts")
    n = sum(c.length for c in cols)
    if first.dtype.is_struct:
        if any(c.dtype != first.dtype for c in cols):
            raise TypeError("cannot concatenate STRUCT columns of different fields")
        return Column(first.dtype, n, None, validity, children=[
            concatenate([c.children[i] for c in cols]) for i in range(len(first.children))])
    from cudf_tpu_torch.ops.lists import make_list_column

    shift, offsets = 0, [first.offsets[:1]]
    for c in cols:
        offsets.append(c.offsets[1:] + shift)
        shift = shift + c.offsets[-1]
    return make_list_column(torch.cat(offsets), concatenate([c.children[0] for c in cols]),
                            validity)


def _concatenate_decimals(cols: Sequence[Column], validity) -> Column:
    """Decimal columns at the finest of their scales, in the widest of
    their widths (two limbs when any has two)."""
    from cudf_tpu_torch.ops.decimal import bits_of, rescale

    if not all(c.dtype.is_decimal for c in cols):
        raise TypeError("cannot concatenate decimal and non-decimal columns")
    scale = min(c.dtype.scale for c in cols)
    target = dt.decimal_dtype(scale, max(bits_of(c.dtype) for c in cols))
    cols = [rescale(c, scale) for c in cols]
    data = torch.cat([c.data.to(target.torch_storage) for c in cols])
    if not any(c.children for c in cols):
        return Column(target, data.shape[0], data, validity)
    from cudf_tpu_torch.ops.decimal128 import limbs, make_decimal128

    return make_decimal128(torch.cat([limbs(c)[0] for c in cols]), data, scale, validity)


def concatenate_tables(tables: Sequence[Table]) -> Table:
    names = tables[0].names
    return Table.from_pairs(names, [concatenate([t[n] for t in tables]) for n in names])


def copy_if_else(mask: torch.Tensor, lhs, rhs) -> Column:
    """out[i] = mask[i] ? lhs[i] : rhs[i] (cudf::copy_if_else).  Either
    side may be a host scalar, which broadcasts without a full column.
    Columns and scalars meet in their common dtype, as in the reference;
    two dictionaries over the same keys select codes."""
    from cudf_tpu_torch.ops.binaryop import scalar_operand
    from cudf_tpu_torch.ops.unary import cast

    n = mask.shape[0]
    sides = [x if isinstance(x, Column) else scalar_operand(x) for x in (lhs, rhs)]
    dtypes = [s.dtype if isinstance(s, Column) else s[1] for s in sides]
    if any(d.is_string or d.is_dictionary for d in dtypes):
        return _select_keyed(mask, sides, n)
    target = dt.common_dtype(*dtypes)
    vals, valids = [], []
    for s in sides:
        if isinstance(s, Column):
            c = cast(s, target)
            vals.append(c.data)
            valids.append(c.validity)
        elif s[0] is None:
            vals.append(0)
            valids.append(torch.zeros(n, dtype=torch.bool, device=mask.device))
        else:
            vals.append(s[0])
            valids.append(None)
    if not isinstance(vals[0], torch.Tensor) and not isinstance(vals[1], torch.Tensor):
        vals[0] = torch.full((n,), vals[0], dtype=target.torch_storage, device=mask.device)
    data = torch.where(mask, vals[0], vals[1]).to(target.torch_storage)
    validity = None
    if valids[0] is not None or valids[1] is not None:
        ones = torch.ones(n, dtype=torch.bool, device=mask.device)
        validity = torch.where(mask, ones if valids[0] is None else valids[0],
                               ones if valids[1] is None else valids[1])
    return Column(target, n, data, validity)


def _select_keyed(mask: torch.Tensor, sides, n: int) -> Column:
    """copy_if_else of dictionary and string sides: codes when both are
    dictionaries over one keys column, else the decoded strings' rows."""
    if all(isinstance(s, Column) and s.dtype.is_dictionary for s in sides):
        if sides[0].keys is not sides[1].keys:
            from cudf_tpu_torch.ops.dictionary import match_dictionaries

            sides = list(match_dictionaries(*sides))
        codes = copy_if_else(mask, Column(dt.INT32, n, sides[0].data, sides[0].validity),
                             Column(dt.INT32, n, sides[1].data, sides[1].validity))
        return Column(sides[0].dtype, n, codes.data, codes.validity, children=sides[0].children)
    cols = []
    for s in sides:
        if not isinstance(s, Column):
            s = Column.full(n, s[0], dt.STRING, device=mask.device)
        cols.append(s.decode_dictionary())
    if not all(c.dtype.is_string for c in cols):
        raise TypeError("copy_if_else of a string and a non-string side")
    both = concatenate(cols)
    rows = torch.arange(n, device=mask.device)
    return gather(both, torch.where(mask, rows, rows + n), bounds_check=False)


def sequence(length: int, start=0, step=1, dtype=dt.INT64, *, device) -> Column:
    """start, start + step, ... (length values of ``dtype`` on ``device``)."""
    dtype = dt.dtype(dtype)
    data = start + step * torch.arange(length, dtype=torch.int64, device=device)
    return Column(dtype, length, data.to(dtype.torch_storage))


def reverse(col: Column) -> Column:
    idx = torch.arange(col.length - 1, -1, -1, dtype=torch.int64, device=col.device)
    return gather(col, idx, bounds_check=False)


def scatter_scalar(value, scatter_map: torch.Tensor, target: Column) -> Column:
    """target[scatter_map[i]] = value (a null value nulls the rows)."""
    from cudf_tpu_torch.core.column import is_null_scalar

    m = scatter_map.shape[0]
    if target.dtype.is_dictionary and not is_null_scalar(value):
        src = Column.from_pylist([value] * m, device=target.device)
    else:
        dtype = target.dtype.value_type if target.dtype.is_dictionary else target.dtype
        src = Column.full(m, value, dtype, device=target.device)
    return scatter(src, scatter_map, target)


def shift(col: Column, periods: int, fill_value=None) -> Column:
    """cudf::shift: row i takes row i - periods; the rows shifted in are
    null, or ``fill_value``."""
    n, p = col.length, int(periods)
    if col.dtype.is_string:
        idx = torch.arange(n, dtype=torch.int64, device=col.device) - p
        out = gather(col, idx, bounds_check=True)
    else:
        k = min(abs(p), n)
        blank = torch.zeros(k, dtype=col.data.dtype, device=col.device)
        valid = materialize_validity(col)
        none = torch.zeros(k, dtype=torch.bool, device=col.device)
        if p >= 0:
            data = torch.cat([blank, col.data[:n - k]])
            validity = torch.cat([none, valid[:n - k]])
        else:
            data = torch.cat([col.data[k:], blank])
            validity = torch.cat([valid[k:], none])
        out = Column(col.dtype, n, data, validity, children=col.children)
    if fill_value is not None:
        from cudf_tpu_torch.ops.replace import replace_where

        pos = torch.arange(n, dtype=torch.int64, device=col.device) - p
        out = replace_where(out, (pos < 0) | (pos >= n), fill_value)
    return out


def repeat(col: Column, counts) -> Column:
    """Row i repeated counts[i] times (cudf::repeat): an int repeats every
    row; a tensor of counts costs one host sync for the total."""
    if isinstance(counts, int):
        idx = torch.arange(col.length, dtype=torch.int64,
                           device=col.device).repeat_interleave(counts)
        return gather(col, idx, bounds_check=False)
    counts = torch.as_tensor(counts, dtype=torch.int64, device=col.device)
    offsets = torch.zeros(counts.shape[0] + 1, dtype=torch.int64, device=col.device)
    torch.cumsum(counts, 0, out=offsets[1:])
    return gather(col, segment_expand(offsets, int(offsets[-1])), bounds_check=False)


def tile(col: Column, count: int) -> Column:
    """The whole column, ``count`` times over."""
    idx = torch.arange(col.length, dtype=torch.int64, device=col.device).repeat(count)
    return gather(col, idx, bounds_check=False)


def interleave_columns(cols: Sequence[Column]) -> Column:
    """Row-major interleave of k same-length columns
    (cudf::interleave_columns): c0[0], c1[0], ..., c0[1], c1[1], ..."""
    k, n = len(cols), cols[0].length
    pos = torch.arange(n * k, dtype=torch.int64, device=cols[0].device)
    return gather(concatenate(cols), (pos % k) * n + pos // k, bounds_check=False)


def get_element(col: Column, i: int):
    """Row i as a host scalar (None when null): a Python int, float or
    bool, a numpy datetime64 / timedelta64, a str (a dictionary's key)."""
    i = int(i) + (col.length if i < 0 else 0)
    if not 0 <= i < col.length:
        raise IndexError(f"row {i} of a {col.length}-row column")
    return slice(col, i, i + 1).to_numpy().tolist()[0] if col.dtype.is_string or \
        col.dtype.is_dictionary else _fixed_element(col, i)


def _fixed_element(col: Column, i: int):
    if col.validity is not None and not bool(col.validity[i]):
        return None
    v = col.data[i].item()
    if col.dtype.is_temporal:
        return np.array(v, dtype=np.int64).view(col.dtype.to_numpy())[()]
    if col.data.dtype == torch.uint64 and v < 0:
        v += 1 << 64
    return v


def sample(col: Column, n: int, seed: int = 0, replace: bool = False) -> Column:
    """n rows drawn from an explicit ``torch.Generator`` seeded with
    ``seed`` on the column's device: with ``replace`` uniformly, else the
    head of a random permutation (no row twice).  The rows are not the
    reference's, which draws with ``jax.random``."""
    return gather(col, sample_rows(col.length, n, seed, replace, col.device),
                  bounds_check=False)


def sample_rows(rows: int, n: int, seed: int, replace: bool, device) -> torch.Tensor:
    """The n row positions ``sample`` takes out of ``rows``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    if replace:
        return torch.randint(0, rows, (n,), generator=gen, device=device)
    if n > rows:
        raise ValueError("cannot take a larger sample than the column without replace")
    return torch.randperm(rows, generator=gen, device=device)[:n]
