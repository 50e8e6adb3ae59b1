"""JSON reader and writer (port of ``cudf_tpu/io/json.py``).

``read_json`` of NDJSON (``lines=True``) and of the records orient (a
top-level array) takes the device tokenizer (``json_device.py``);
nested objects or arrays (``UnsupportedJson``) go to pyarrow's reader
for lines and to pandas' for records, as the reference sends them, and
so does every other orient or option; each counted in ``IO_ROUTES``.
The option ``io.json.device_tokenizer`` off sends lines to pyarrow and
records to pandas.

``write_json`` of the records orient builds the text on the device (the
shape of ``models/io_paths.py``'s CSV): each field's bytes as a digit
or key byte matrix with its lengths, or as spans of a string column's
escaped bytes, placed after the row's earlier fields by one scatter a
piece.  Values are written as pandas' ``to_json`` writes them (ujson's
``double_precision=10``): a float's whole part and at most 10 decimals
rounded as ujson rounds, trailing zeros dropped but one ("1.0"),
``%.10g`` beyond 1e16 or under 1e-15 (those few rows formatted on the
host); NaN and infinities as null; strings escaped as pandas escapes
them (``\\/``, ``\\uXXXX`` for control and non-ASCII characters,
surrogate pairs above the BMP); timestamps and durations as epoch
milliseconds; every line ended.  The reference writes a float 1.0 as 1
and leaves off the last newline (ROADMAP.md §3).  Other orients, nested
or decimal columns and options take pandas' writer.
"""

from __future__ import annotations

import io as _io
from typing import List, Optional

import numpy as np
import torch

from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.io import IO_ROUTES
from cudf_tpu_torch.utils.config import get_option


def _frame(t):
    from cudf_tpu_torch.frame.dataframe import DataFrame
    from cudf_tpu_torch.frame.index import default_index

    return DataFrame._from(t, default_index(t.num_rows))


def _source(src) -> np.ndarray:
    """The text as uint8: a file read once, without a copy."""
    if hasattr(src, "read"):
        src = src.read()
    if isinstance(src, str) and ("\n" in src or src.lstrip().startswith(("{", "["))):
        src = src.encode()
    if isinstance(src, (bytes, bytearray, memoryview)):
        return np.frombuffer(src, np.uint8)
    return np.fromfile(src, np.uint8)


def read_json(path_or_buf, lines: bool = False, orient=None, dtype=None, *, device="cuda",
              **kw):
    """A DataFrame on ``device``.  dtype: {column: dtype} ("category"
    makes a DICTIONARY column, as pandas)."""
    from cudf_tpu_torch.core.table import Table
    from cudf_tpu_torch.io.json_device import UnsupportedJson, read_json_device

    data = _source(path_or_buf)
    first = np.flatnonzero(~np.isin(data[:4096], [32, 9, 10, 13]))
    records = not lines and orient in (None, "records") and first.size > 0 and \
        data[first[0]] == ord("[")
    device_shape = not kw and (dtype is None or isinstance(dtype, dict)) and \
        (lines and orient in (None, "records") or records)
    if device_shape and get_option("io.json.device_tokenizer"):
        try:
            t, n = read_json_device(data, records=records, dtypes=dtype, device=device)
        except UnsupportedJson:
            pass
        else:
            IO_ROUTES["native"] += 1
            if t.num_columns == 0:
                from cudf_tpu_torch.frame.dataframe import DataFrame
                from cudf_tpu_torch.frame.index import default_index

                return DataFrame._from(t, default_index(n))
            return _frame(t)
    if device_shape and lines:
        IO_ROUTES["pyarrow"] += 1
        import pyarrow.json as pajson

        df = _frame(Table.from_arrow(pajson.read_json(_io.BytesIO(data.tobytes())),
                                     device=device))
        return df.astype(dtype) if dtype else df
    IO_ROUTES["pandas"] += 1
    import pandas as pd

    from cudf_tpu_torch.frame.dataframe import DataFrame

    pdf = pd.read_json(_io.BytesIO(data.tobytes()), orient=orient, lines=lines,
                       **({"dtype": dtype} if dtype is not None else {}), **kw)
    return DataFrame.from_pandas(pdf, device=device)


# ----------------------------------------------------------------------
# the writer's pieces: (kind, payload, lengths [n])
#   "const":  payload bytes, written where lengths say len(payload)
#   "mat":    payload uint8 [n, w], the first lengths[i] of row i
#   "spans":  payload (chars, starts [n]): lengths[i] bytes from starts[i]
# ----------------------------------------------------------------------

def _const(b: bytes, n: int, device, on: Optional[torch.Tensor] = None):
    lens = torch.full((n,), len(b), dtype=torch.int64, device=device)
    return ("const", b, lens if on is None else torch.where(on, lens, 0))


_POW10 = [10 ** k for k in range(19)]


def int_text(x: torch.Tensor):
    """(uint8 [n, w], lengths) of int64 values in decimal."""
    n, dev = x.shape[0], x.device
    neg = x < 0
    ndig = torch.ones(n, dtype=torch.int64, device=dev)
    for p in range(1, 19):
        ndig += torch.div(x, _POW10[p], rounding_mode="trunc") != 0
    lens = ndig + neg
    width = int(lens.max()) if n else 1
    pow10 = torch.tensor(_POW10, dtype=torch.int64, device=dev)
    cols = []
    for k in range(width):
        j = (ndig - 1 - (k - neg.long())).clamp(0, 18)
        digit = torch.fmod(torch.div(x, pow10[j], rounding_mode="trunc"), 10).abs()
        cols.append(torch.where(neg & (k == 0), ord("-"), 48 + digit))
    return torch.stack(cols, 1).to(torch.uint8), lens


def float_text(x: torch.Tensor):
    """(uint8 [n, w], lengths, host rows) of float64 values as ujson writes
    them with 10 decimals; ``host rows`` (beyond 1e16, under 1e-15) need
    ``%.10g``, which the caller writes."""
    neg = x < 0
    a = x.abs()
    host = (a > 1e16) | ((a != 0) & (a < 1e-15))
    a = torch.where(host | ~torch.isfinite(a), 0.0, a)
    whole_f = torch.trunc(a)
    whole = whole_f.long()
    tmp = (a - whole_f) * 1e10
    frac = torch.trunc(tmp).long()
    diff = tmp - frac.double()
    frac = frac + ((diff > 0.5) | ((diff == 0.5) & ((frac == 0) | (frac & 1 == 1)))).long()
    roll = frac >= 10 ** 10
    frac = torch.where(roll, 0, frac)
    whole = whole + roll.long()
    tz = torch.zeros_like(frac)
    f = frac.clone()
    for _ in range(9):
        z = (f != 0) & (f % 10 == 0)
        f = torch.where(z, f // 10, f)
        tz += z.long()
    fwidth = torch.where(frac == 0, 1, 10 - tz)
    wmat, wlens = int_text(whole)
    cols = [torch.where(neg, ord("-"), 0).to(torch.uint8).unsqueeze(1), wmat,
            torch.full_like(wlens, ord(".")).to(torch.uint8).unsqueeze(1)]
    pieces = [neg.long(), wlens, torch.ones_like(wlens)]
    fcols = []
    for k in range(10):
        j = (fwidth - 1 - k).clamp(min=0)
        fcols.append(48 + (f // torch.pow(10, j)) % 10)
    cols.append(torch.stack(fcols, 1).to(torch.uint8))
    pieces.append(fwidth)
    mat, lens = _pack(list(zip(cols, pieces)), x.shape[0], x.device)
    return mat, lens, host


def _pack(pieces, n: int, device):
    """Matrix pieces concatenated a row at a time into one [n, w] matrix
    (a byte past a piece's length goes to a spare slot: no host sync)."""
    lens = sum(ln for _, ln in pieces)
    width = sum(mat.shape[1] for mat, _ in pieces)
    flat = torch.zeros(n * width + 1, dtype=torch.uint8, device=device)
    at = torch.arange(n, device=device) * width
    for mat, ln in pieces:
        for k in range(mat.shape[1]):
            flat[torch.where(k < ln, at + k, n * width)] = mat[:, k]
        at = at + ln
    return flat[:-1].view(n, width), lens


def _host_rows(mat, lens, rows: torch.Tensor, texts: List[str]):
    """Rows of a matrix piece replaced by host-made text."""
    if not texts:
        return mat, lens
    width = max(mat.shape[1], max(len(t) for t in texts))
    if width > mat.shape[1]:
        mat = torch.cat([mat, mat.new_zeros((mat.shape[0], width - mat.shape[1]))], 1)
    fix = np.zeros((len(texts), width), np.uint8)
    for i, t in enumerate(texts):
        fix[i, :len(t)] = np.frombuffer(t.encode(), np.uint8)
    mat[rows] = torch.from_numpy(fix).to(mat.device)
    lens = lens.clone()
    lens[rows] = torch.tensor([len(t) for t in texts], dtype=torch.int64, device=lens.device)
    return mat, lens


_SHORT = {ord('"'): ord('"'), ord("\\"): ord("\\"), ord("/"): ord("/"), 8: ord("b"),
          12: ord("f"), 10: ord("n"), 13: ord("r"), 9: ord("t")}
_HEX = torch.tensor(list(b"0123456789abcdef"), dtype=torch.uint8)


def escape(col: Column) -> Column:
    """A STRING column's JSON text without its quotes, escaped as pandas
    escapes it."""
    from cudf_tpu_torch.ops.strings import new_offsets

    b = col.data
    special = (b < 0x20) | (b == 34) | (b == 92) | (b == 47) | (b >= 0x80)
    if not bool(special.any()):
        return col
    dev, total = b.device, b.shape[0]
    short = torch.zeros(256, dtype=torch.uint8, device=dev)
    for c, e in _SHORT.items():
        short[c] = e
    bl = b.long()
    sb = short[bl]
    # a lead byte's code point (continuation bytes write nothing)
    nxt = [torch.cat([bl[k:], bl.new_zeros(k)]) & 0x3F for k in (1, 2, 3)]
    lead2, lead3, lead4 = (bl >= 0xC0) & (bl < 0xE0), (bl >= 0xE0) & (bl < 0xF0), bl >= 0xF0
    cp = torch.where(lead2, ((bl & 0x1F) << 6) | nxt[0], torch.where(
        lead3, ((bl & 0x0F) << 12) | (nxt[0] << 6) | nxt[1],
        ((bl & 0x07) << 18) | (nxt[0] << 12) | (nxt[1] << 6) | nxt[2]))
    cp = torch.where(bl < 0x80, bl, cp)
    cont = (bl >= 0x80) & (bl < 0xC0)
    out_len = torch.where(sb > 0, 2, torch.where(bl < 0x20, 6, torch.where(
        bl < 0x80, 1, torch.where(cont, 0, torch.where(cp >= 0x10000, 12, 6)))))
    pos = torch.cumsum(out_len, 0) - out_len
    out = torch.empty(int(out_len.sum()), dtype=torch.uint8, device=dev)
    plain = out_len == 1
    out[pos[plain]] = b[plain]
    two = sb > 0
    out[pos[two]] = 92
    out[pos[two] + 1] = sb[two]
    hexd = _HEX.to(dev)
    u = (out_len == 6) | (out_len == 12)
    at, c = pos[u], cp[u]
    hi = 0xD800 + ((c - 0x10000) >> 10)
    lo = 0xDC00 + ((c - 0x10000) & 0x3FF)
    pair = c >= 0x10000
    for unit, shift in ((torch.where(pair, hi, c), 0), (lo, 6)):
        m = torch.ones_like(pair) if shift == 0 else pair
        base = at[m] + shift
        out[base] = 92
        out[base + 1] = ord("u")
        for k in range(4):
            out[base + 2 + k] = hexd[(unit[m] >> (12 - 4 * k)) & 0xF]
    pre = torch.zeros(total + 1, dtype=torch.long, device=dev)
    pre[1:] = torch.cumsum(out_len, 0)
    offsets = new_offsets(pre[col.offsets[1:]] - pre[col.offsets[:-1]])
    return Column(dt.STRING, col.length, out, col.validity, offsets)


def _string_pieces(col: Column, n: int, device, null) -> list:
    """The quoted, escaped text of a STRING or DICTIONARY column."""
    if col.dtype.is_dictionary:
        keys = escape(col.keys)
        kl = keys.offsets[1:] - keys.offsets[:-1]
        codes = col.data.long()
        if keys.length and bool((kl == kl[0]).all()):
            w, at = int(kl[0]), int(keys.offsets[0])
            mat = keys.data[at:at + keys.length * w].view(keys.length, w)[codes] if w else \
                torch.zeros((n, 0), dtype=torch.uint8, device=device)
            body = ("mat", mat, torch.full((n,), w, dtype=torch.int64, device=device))
        else:
            body = ("spans", (keys.data, keys.offsets[:-1][codes]), kl[codes])
    else:
        esc = escape(col)
        body = ("spans", (esc.data, esc.offsets[:-1]), esc.offsets[1:] - esc.offsets[:-1])
    if null is None:
        return [_const(b'"', n, device), body, _const(b'"', n, device)]
    on = ~null
    kind, payload, lens = body
    return [_const(b'"', n, device, on), (kind, payload, torch.where(on, lens, 0)),
            _const(b'"', n, device, on), _const(b"null", n, device, null)]


def _epoch_ms(col: Column) -> torch.Tensor:
    """Ticks as epoch milliseconds (pandas' ``date_unit="ms"``, floored)."""
    ticks = col.data.long()
    per_s = _unit_per_second(col.dtype)
    if per_s is None:                           # days
        return ticks * 86_400_000
    if per_s <= 1000:
        return ticks * (1000 // per_s)
    return torch.div(ticks, per_s // 1000, rounding_mode="floor")


def _unit_per_second(d) -> Optional[int]:
    i = d.id
    if i in (dt.TypeId.TIMESTAMP_DAYS, dt.TypeId.DURATION_DAYS):
        return None
    if i in (dt.TypeId.TIMESTAMP_SECONDS, dt.TypeId.DURATION_SECONDS):
        return 1
    if i in (dt.TypeId.TIMESTAMP_MILLISECONDS, dt.TypeId.DURATION_MILLISECONDS):
        return 10 ** 3
    if i in (dt.TypeId.TIMESTAMP_MICROSECONDS, dt.TypeId.DURATION_MICROSECONDS):
        return 10 ** 6
    return 10 ** 9


def _value_pieces(col: Column, n: int, device) -> list:
    d = col.dtype
    null = None if col.validity is None or bool(col.validity.all()) else ~col.validity
    if d.is_string or d.is_dictionary:
        return _string_pieces(col, n, device, null)
    if d.is_bool:
        table = torch.tensor([list(b"false"), list(b"true\0")], dtype=torch.uint8,
                             device=device)
        v = col.data.bool()
        mat, lens = table[v.long()], torch.where(v, 4, 5)
    elif d.is_float:
        x = col.data.double()
        mat, lens, host = float_text(x)
        if null is None:
            null = ~torch.isfinite(x) if not bool(torch.isfinite(x).all()) else None
        else:
            null = null | ~torch.isfinite(x)
        rows = torch.nonzero(host if null is None else host & ~null).flatten()
        mat, lens = _host_rows(mat, lens, rows, ["%.10g" % v for v in x[rows].tolist()])
    elif d.is_temporal:
        mat, lens = int_text(_epoch_ms(col))
    elif d.id == dt.TypeId.UINT64:
        x = col.data.view(torch.int64) if col.data.dtype != torch.int64 else col.data
        mat, lens = int_text(torch.where(x < 0, 0, x))
        rows = torch.nonzero(x < 0).flatten()
        mat, lens = _host_rows(mat, lens, rows, [str(v + 2 ** 64) for v in x[rows].tolist()])
    else:
        mat, lens = int_text(col.data.long())
    if null is None:
        return [("mat", mat, lens)]
    return [("mat", mat, torch.where(null, 0, lens)), _const(b"null", n, device, null)]


def device_writable(col: Column) -> bool:
    d = col.dtype
    return (d.is_numeric or d.is_bool or d.is_string or d.is_temporal or
            (d.is_dictionary and col.keys.dtype.is_string)) and not d.is_decimal


def _key_text(name) -> bytes:
    import json

    return json.dumps(str(name)).replace("/", "\\/").encode()


def assemble(pieces, n: int, device) -> torch.Tensor:
    """uint8 text: every row's pieces one after another, rows in order."""
    from cudf_tpu_torch.ops.strings import byte_rows, new_offsets

    row_len = sum(p[2] for p in pieces)
    starts = torch.cumsum(row_len, 0) - row_len
    total = int(row_len.sum()) if n else 0
    out = torch.empty(total + 1, dtype=torch.uint8, device=device)   # the last: a spare slot
    at = starts.clone()
    for kind, payload, lens in pieces:
        if kind == "const":
            for k, c in enumerate(payload):
                out[torch.where(lens > k, at + k, total)] = c
        elif kind == "mat":
            for k in range(payload.shape[1]):
                out[torch.where(lens > k, at + k, total)] = payload[:, k]
        else:
            chars, src = payload
            offsets = new_offsets(lens)
            m = int(offsets[-1])
            rows = byte_rows(offsets, m)
            for a in range(0, m, 1 << 27):
                row = rows[a:a + (1 << 27)].long()
                within = torch.arange(a, a + row.shape[0], device=device) - offsets[row]
                out[at[row] + within] = chars[src[row] + within]
        at = at + lens
    return out[:total]


def _records(pieces, n: int, device, lines: bool) -> torch.Tensor:
    """One record a row: ended by newlines, or joined by commas in [ ]
    (pandas writes "\n" for no rows with lines, "[]" without)."""
    if n == 0:
        return torch.tensor(list(b"\n" if lines else b"[]"), dtype=torch.uint8, device=device)
    body = assemble(pieces + [_const(b"\n" if lines else b",", n, device)], n, device)
    if lines:
        return body
    return torch.cat([body.new_tensor(list(b"[")), body[:-1], body.new_tensor(list(b"]"))])


def json_text(table, lines: bool) -> torch.Tensor:
    """uint8 tensor on the table's device: the records orient's text."""
    n = table.num_rows
    device = table.device if table.num_columns else torch.device("cpu")
    pieces = []
    for j, (name, col) in enumerate(table.items()):
        pieces.append(_const((b"{" if j == 0 else b",") + _key_text(name) + b":", n, device))
        pieces += _value_pieces(col, n, device)
    pieces.append(_const(b"{}" if not pieces else b"}", n, device))
    return _records(pieces, n, device, lines)


def _emit(text: bytes, path):
    IO_ROUTES["native"] += 1
    if path is None:
        return text.decode()
    if hasattr(path, "write"):
        path.write(text.decode())
        return None
    with open(path, "wb") as f:
        f.write(text)
    return None


def write_series_json(s, path=None, orient="records", lines=False, **kw):
    """A Series' records orient: its values as a list, or one a line."""
    col = s._column
    if orient != "records" or kw or not device_writable(col):
        IO_ROUTES["pandas"] += 1
        return s.to_pandas().to_json(path, orient=orient, lines=lines, **kw)
    n = col.length
    pieces = _value_pieces(col, n, col.device) if n else []
    return _emit(_records(pieces, n, col.device, lines).cpu().numpy().tobytes(), path)


def write_json(df, path=None, orient="records", lines=False, **kw):
    """The frame's JSON text, returned (``path`` None) or written."""
    table = df._table
    if orient != "records" or kw or not all(device_writable(c) for c in table.columns):
        IO_ROUTES["pandas"] += 1
        return df.to_pandas().to_json(path, orient=orient, lines=lines, **kw)
    return _emit(json_text(table, lines).cpu().numpy().tobytes(), path)
