"""The device CSV tokenizer (port of ``cudf_tpu/io/csv_device.py``):
quote state, field extraction, unquoting, type inference and the typed
parse, all on the device from one host-to-device copy of the file's
bytes (libcudf's csv_gpu.cu and its FST, as three data-parallel passes):

1. quote state: ``in_quote[b]`` is the parity of the quotes before byte
   b (an escaped ``""`` flips twice, so it changes no structure);
2. structure: record breaks are unquoted newlines; field breaks are
   unquoted delimiters and record breaks;
3. extraction: field k of every row as a byte range, the chars of a
   column gathered from the file's bytes (``ops/strings.gather_ranges``).

Numbers parse through ``ops/strings.to_numbers``; quoted fields lose
their outer quotes and unescape ``""`` on the device
(``string_spans.replace_literal_device``).  An inferred numeric column
whose later rows do not parse widens as pandas widens it (int, then
float, then strings).  Ragged rows raise ``RaggedCsv``: ``read_csv``
gives them, and nothing else, to the pyarrow tier.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.core.table import Table

_INFER_ROWS = 64
_BOOL_SPELLINGS = ("True", "TRUE", "true", "False", "FALSE", "false")


class RaggedCsv(ValueError):
    """Rows of more than one width: the one shape the device tier gives
    to the host tier."""


def _structure(buf: torch.Tensor, delim: int, quote: int = ord('"')):
    """(field-break mask, record-break mask) over the bytes."""
    is_q = buf == quote
    inq = (torch.cumsum(is_q, 0, dtype=torch.int32) - is_q.int()) & 1
    unquoted = inq == 0
    del inq
    nl = (buf == ord("\n")) & unquoted
    fb = ((buf == delim) & unquoted) | nl
    return fb, nl


def tokenize(data: bytes, delim: str = ",", *, device):
    """(bytes on the device, field starts, field ends, row of each field,
    n_fields, n_rows).  A field excludes its separator; a \\r before a
    record break is trimmed."""
    raw = np.frombuffer(data, np.uint8)
    if raw.size and raw[-1] != ord("\n"):
        raw = np.concatenate([raw, np.frombuffer(b"\n", np.uint8)])
    buf = torch.from_numpy(raw.copy()).to(device)
    nb = buf.shape[0]
    fb, nl = _structure(buf, ord(delim))
    ends = torch.nonzero(fb).flatten()
    is_rec = nl[ends]
    starts = torch.zeros_like(ends)
    starts[1:] = ends[:-1] + 1
    prev = buf[(ends - 1).clamp(0, max(nb - 1, 0))]
    ends = torch.where(is_rec & (prev == 13) & (ends > starts), ends - 1, ends)
    row = torch.cumsum(is_rec, 0) - is_rec.long()
    return buf, starts, ends, row, ends.shape[0], int(is_rec.sum())


def _field_column(buf: torch.Tensor, starts: torch.Tensor, ends: torch.Tensor,
                  sel: torch.Tensor) -> Column:
    """A STRING column of the selected fields' bytes."""
    from cudf_tpu_torch.ops.strings import gather_ranges, new_offsets

    s = starts[sel]
    offsets = new_offsets(ends[sel] - s)
    return Column(dt.STRING, sel.shape[0], gather_ranges(buf, s, offsets), None, offsets)


def _unquote(col: Column) -> Column:
    """Outer quotes stripped and doubled quotes unescaped, on the device."""
    from cudf_tpu_torch.ops.string_spans import replace_literal_device
    from cudf_tpu_torch.ops.strings import gather_ranges, new_offsets

    if col.data.shape[0] == 0:
        return col
    lens = col.offsets[1:] - col.offsets[:-1]
    first = col.data[col.offsets[:-1].clamp(max=col.data.shape[0] - 1)]
    quoted = (lens >= 2) & (first == ord('"'))
    if not bool(quoted.any()):
        return col
    cut = quoted.long()
    offsets = new_offsets(lens - 2 * cut)
    out = Column(dt.STRING, col.length, gather_ranges(col.data, col.offsets[:-1] + cut, offsets),
                 None, offsets)
    return replace_literal_device(out, '""', '"')


def _infer_dtype(samples: List[str]):
    seen_float = seen_any = False
    all_bool = True
    for s in samples:
        if s == "":
            continue
        seen_any = True
        if s not in _BOOL_SPELLINGS:
            all_bool = False
        try:
            int(s)
            continue
        except ValueError:
            pass
        try:
            float(s)
            seen_float = True
            continue
        except ValueError:
            if not all_bool:
                return dt.STRING
    if not seen_any:                 # every field empty: pandas reads NaN floats
        return dt.FLOAT64
    if all_bool:
        return dt.BOOL8
    return dt.FLOAT64 if seen_float else dt.INT64


def _widened_numbers(col: Column, target: dt.DType) -> Optional[Column]:
    """The column parsed as ``target`` (inferred from the first
    ``_INFER_ROWS`` rows), or as FLOAT64 when a later row is no integer,
    as pandas widens it; None when a row is no number (a STRING column)."""
    from cudf_tpu_torch.ops import strings as S

    for t in (target, dt.FLOAT64) if target == dt.INT64 else (target,):
        values, parsed = S.parse_numbers(col, t.is_float)
        if S.first_unparsed(col, parsed) is None:
            return Column(t, col.length, values.to(t.torch_storage),
                          None if col.validity is None else parsed)
    return None


def _bool_spelled(col: Column, lens: torch.Tensor) -> torch.Tensor:
    """Rows spelled as one of pandas' booleans."""
    from cudf_tpu_torch.ops import strings as S

    ok = torch.zeros(col.length, dtype=torch.bool, device=col.device)
    for sp in _BOOL_SPELLINGS:
        ok |= S.startswith(col, sp).data & (lens == len(sp))
    return ok


def _parse_bools(col: Column) -> Column:
    from cudf_tpu_torch.ops import strings as S

    lens = col.offsets[1:] - col.offsets[:-1]
    val = torch.zeros(col.length, dtype=torch.bool, device=col.device)
    for sp in ("True", "TRUE", "true"):
        val |= S.startswith(col, sp).data & (lens == len(sp))
    return Column(dt.BOOL8, col.length, val)


def read_csv_device(path_or_data, delimiter: str = ",", header: bool = True,
                    usecols: Optional[List[str]] = None,
                    dtypes: Optional[Dict[str, object]] = None, *, device) -> Table:
    """A CSV's columns as a Table on ``device`` through the device
    tokenizer.  Empty fields are nulls (pandas' reading).  ``dtypes`` may
    name numeric dtypes, "str" / "object", or "category" (a DICTIONARY
    column, as pandas reads it)."""
    from cudf_tpu_torch.ops import copying
    from cudf_tpu_torch.ops import strings as S
    from cudf_tpu_torch.ops.dictionary import encode

    if isinstance(path_or_data, (bytes, bytearray)):
        data = bytes(path_or_data)
    else:
        with open(path_or_data, "rb") as f:
            data = f.read()
    buf, starts, ends, row, n_fields, n_rows = tokenize(data, delimiter, device=device)
    if n_rows == 0:
        return Table({})
    is_rec = torch.nonzero(row[1:] != row[:-1]).flatten() if n_fields > 1 else None
    fpr = int(is_rec[0]) + 1 if is_rec is not None and is_rec.numel() else n_fields
    if fpr * n_rows != n_fields:
        raise RaggedCsv("ragged rows: the host tier reads them")
    if header:
        names = _unquote(_field_column(buf, starts, ends,
                                       torch.arange(fpr, device=buf.device))).to_pylist()
        first_row = 1
    else:
        names = [f"f{i}" for i in range(fpr)]
        first_row = 0
    ndata = n_rows - first_row
    want = set(usecols) if usecols else None
    cols: Dict[str, Column] = {}
    for j, name in enumerate(names):
        if want is not None and name not in want:
            continue
        sel = (torch.arange(ndata, device=buf.device) + first_row) * fpr + j
        col = _unquote(_field_column(buf, starts, ends, sel))
        lens = col.offsets[1:] - col.offsets[:-1]
        nonempty = lens > 0
        target = (dtypes or {}).get(name)
        category = str(target) == "category"
        inferred = target is None
        if inferred or category:
            head = copying.slice(col, 0, _INFER_ROWS).to_pylist()
            target = dt.STRING if category else _infer_dtype([h for h in head if h is not None])
        elif str(target) in ("str", "object", "string"):
            target = dt.STRING
        else:
            target = dt.dtype(target)
        if target == dt.BOOL8:
            if not inferred or bool((_bool_spelled(col, lens) | ~nonempty).all()):
                cols[name] = _parse_bools(col)
                continue
            target = dt.STRING
        all_there = bool(nonempty.all())
        if target.is_numeric:
            src = col if all_there else col.with_validity(nonempty)
            if not inferred:                     # a named dtype: a bad row raises
                cols[name] = S.to_numbers(src, target)
                continue
            parsed = _widened_numbers(src, target)
            if parsed is not None:
                cols[name] = parsed
                continue
            target = dt.STRING
        if not all_there:
            col = col.with_validity(nonempty)
        cols[name] = encode(col) if category else col
    return Table(cols)
