"""The device JSON tokenizer (port of ``cudf_tpu/io/json_device.py``):
NDJSON (one flat object a line) and the records orient (one top-level
array of flat objects) into columns, from one host-to-device copy of the
text (libcudf's FST tokenizer and ``json_column.cu``, as data-parallel
passes):

1. escapes: a byte is escaped when the backslash run before it is odd,
   found from the backslashes' positions alone;
2. strings: the parity of the unescaped quotes before each byte
   (``cumsum`` in uint8);
3. structure: unquoted braces give the depth (``cumsum`` in int8); the
   fields are the colons at depth 1, a record ends at the brace that
   closes depth 1; nested objects or arrays raise ``UnsupportedJson``;
4. extraction: a field's key is the quoted span before its colon, its
   value the span to the next comma or closing brace at depth 1,
   trimmed; the keys group by their packed bytes (``torch.unique``) into
   columns in the order of first appearance (pandas'), the last of a
   repeated key winning; values parse on the device (``ops/strings``'s
   parsers, widening int to float to strings as pandas does), strings
   lose their quotes and escapes on the device (``\\uXXXX`` and surrogate
   pairs to UTF-8).

Positions are int32 while the text is under 2^31 bytes.  A missing key
or ``null`` is a null.  A column of numbers with a null stays a nullable
int or float column (pandas reads an int column with a null as float64,
a bool one as float64 too): values and nulls are what they are in pandas.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np
import torch

from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.core.table import Table

_SAMPLE = 64
_WHITESPACE = np.array([32, 9, 10, 13], np.uint8)
_SIMPLE_ESCAPES = {ord('"'): 34, ord("\\"): 92, ord("/"): 47, ord("b"): 8, ord("f"): 12,
                   ord("n"): 10, ord("r"): 13, ord("t"): 9}


class UnsupportedJson(NotImplementedError):
    """Nested objects or arrays: the shape the device tier gives to the
    host tier."""


def _odd_run_ends(bs_pos: torch.Tensor) -> torch.Tensor:
    """Positions of the last backslash of each odd-length run, from the
    sorted positions of the backslashes."""
    if bs_pos.numel() == 0:
        return bs_pos
    start = torch.ones_like(bs_pos, dtype=torch.bool)
    start[1:] = bs_pos[1:] != bs_pos[:-1] + 1
    end = torch.ones_like(start)
    end[:-1] = start[1:]
    first, last = bs_pos[start], bs_pos[end]
    return last[(last - first) % 2 == 0]


def escaped_mask(buf: torch.Tensor) -> torch.Tensor:
    """bool[b]: byte b is escaped (the backslash run ending before it is odd)."""
    out = torch.zeros_like(buf, dtype=torch.bool)
    ends = _odd_run_ends(torch.nonzero(buf == 92).flatten()) + 1
    out[ends[ends < buf.shape[0]]] = True
    return out


def _index_dtype(n: int) -> torch.dtype:
    return torch.int32 if n < 2 ** 31 - 1 else torch.int64


def _positions(mask: torch.Tensor, idt: torch.dtype) -> torch.Tensor:
    return torch.nonzero(mask).flatten().to(idt)


def tokenize(buf: torch.Tensor, records: bool):
    """(colon positions, record ends, unescaped quote positions, value
    ends): each field's colon, each record's closing brace, every string
    quote, every comma or closing brace at depth 1."""
    idt = _index_dtype(buf.shape[0])
    q = buf == 34
    q &= ~escaped_mask(buf)
    inq = torch.cumsum(q, 0, dtype=torch.uint8) & 1        # parity through this byte
    outside = (inq ^ q.to(torch.uint8)) == 0                 # quote bytes count as outside
    del inq
    is_open = (buf == 123) & outside
    is_close = (buf == 125) & outside
    depth = torch.cumsum(is_open.to(torch.int8) - is_close.to(torch.int8), 0, dtype=torch.int8)
    del is_open
    n_arr = int(((buf == 91) & outside).sum())
    if depth.numel() and int(depth.max()) > 1:
        raise UnsupportedJson("nested JSON objects: the host tier reads them")
    if n_arr != (1 if records else 0) or (records and int(((buf == 93) & outside).sum()) != 1):
        raise UnsupportedJson("JSON arrays in the values: the host tier reads them")
    top = depth == 1
    colon = _positions((buf == 58) & outside & top, idt)
    rec_end = is_close & (depth == 0)
    vend = _positions(((buf == 44) & outside & top) | rec_end, idt)
    rec_end = _positions(rec_end, idt)
    del depth, top, is_close
    quotes = _positions(q, idt)
    return colon, rec_end, quotes, vend


def _trim(buf: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor):
    """[lo, hi) without surrounding whitespace (a pass per whitespace byte)."""
    nb = buf.shape[0]

    def ws(b):
        return (b == 32) | (b == 9) | (b == 10) | (b == 13)

    while True:
        move = (lo < hi) & ws(buf[lo.clamp(max=nb - 1).long()])
        if not bool(move.any()):
            break
        lo = lo + move.to(lo.dtype)
    while True:
        move = (hi > lo) & ws(buf[(hi - 1).clamp(min=0).long()])
        if not bool(move.any()):
            break
        hi = hi - move.to(hi.dtype)
    return lo, hi


def _key_codes(buf: torch.Tensor, start: torch.Tensor, lens: torch.Tensor):
    """(code of each field's key, the distinct keys' raw bytes): a key's
    bytes packed 8 to an int64 word; keys of at most 7 bytes group by one
    word (their length in the top byte), longer ones by a hash of their
    words checked row against row, or by the rows themselves."""
    width = int(lens.max())
    words = max((width + 7) // 8, 1)
    padded = torch.cat([buf, buf.new_zeros(8 * words)])
    k = torch.arange(8 * words, device=buf.device)
    mat = padded[start.long().unsqueeze(1) + k]
    mat = torch.where(k < lens.unsqueeze(1), mat, 0).contiguous().view(torch.int64)
    del padded
    if width <= 7:
        uniq, codes = torch.unique(mat[:, 0] | (lens.long() << 56), return_inverse=True)
        rows = torch.stack([uniq & ((1 << 56) - 1), uniq >> 56], 1)
    else:
        key = torch.cat([mat, lens.long().unsqueeze(1)], 1)
        mix = torch.tensor([(0x9E3779B97F4A7C15 * (i + 1)) % 2 ** 64 - 2 ** 63
                            for i in range(key.shape[1])], dtype=torch.int64, device=buf.device)
        h = ((key * mix) ^ (key >> 29)).sum(1)
        _, codes = torch.unique(h, return_inverse=True)
        first = torch.full((int(codes.max()) + 1,), key.shape[0], dtype=torch.long,
                           device=buf.device)
        first.scatter_reduce_(0, codes, torch.arange(key.shape[0], device=buf.device), "amin")
        if not bool((key[first[codes]] == key).all()):       # a hash collision
            _, codes = torch.unique(key, dim=0, return_inverse=True)
            first.fill_(key.shape[0])
            first = first[:int(codes.max()) + 1]
            first.scatter_reduce_(0, codes, torch.arange(key.shape[0], device=buf.device),
                                  "amin")
        rows = key[first]
    raw = []
    for row in rows.cpu().tolist():
        b = b"".join(int(w).to_bytes(8, "little", signed=True) for w in row[:-1])
        raw.append(b[:row[-1]])
    return codes, raw


def _utf8(cp: torch.Tensor):
    """(bytes [n, 4] uint8, lengths) of UTF-8 encodings of code points."""
    n1, n2, n3 = cp < 0x80, cp < 0x800, cp < 0x10000
    length = torch.where(n1, 1, torch.where(n2, 2, torch.where(n3, 3, 4)))
    lead = torch.where(n1, cp, torch.where(n2, 0xC0 | (cp >> 6), torch.where(
        n3, 0xE0 | (cp >> 12), 0xF0 | (cp >> 18))))
    cont = [0x80 | ((cp >> s) & 0x3F) for s in (0, 6, 12)]
    b1 = torch.where(length == 2, cont[0], torch.where(length == 3, cont[1], cont[2]))
    b2 = torch.where(length == 3, cont[0], cont[1])
    return torch.stack([lead, b1, b2, cont[0]], 1).to(torch.uint8), length


def _hex4(data: torch.Tensor, at: torch.Tensor) -> torch.Tensor:
    total = data.shape[0]
    v = torch.zeros_like(at)
    for k in range(4):
        c = data[(at + k).clamp(max=total - 1)].long() | 32       # lower case
        v = v * 16 + torch.where(c >= 97, c - 87, c - 48)
    return v


def unescape(col: Column) -> Column:
    """The column's JSON escapes resolved on the device: the simple ones
    to their byte, ``\\uXXXX`` (and surrogate pairs) to UTF-8."""
    from cudf_tpu_torch.ops.strings import new_offsets

    data = col.data
    bs = torch.nonzero(data == 92).flatten()
    if bs.numel() == 0:
        return col
    dev, total = data.device, data.shape[0]
    # in a run of backslashes every other one starts an escape (a value's
    # own runs end even, so runs that meet across rows keep their parity)
    start = torch.ones_like(bs, dtype=torch.bool)
    start[1:] = bs[1:] != bs[:-1] + 1
    run_first = bs[start][torch.cumsum(start, 0) - 1]
    esc = bs[(bs - run_first) % 2 == 0]
    code = data[(esc + 1).clamp(max=total - 1)].long()
    is_u = code == ord("u")
    cp = _hex4(data, esc + 2)
    lo_cp = _hex4(data, esc + 8)
    pair = is_u & (cp >= 0xD800) & (cp < 0xDC00) & (data[(esc + 6).clamp(max=total - 1)] == 92) \
        & (lo_cp >= 0xDC00) & (lo_cp < 0xE000)
    keep = ~torch.isin(esc, esc[pair] + 6)         # a pair's second half is no escape of its own
    esc, code, is_u, cp, lo_cp, pair = (t[keep] for t in (esc, code, is_u, cp, lo_cp, pair))
    cp = torch.where(pair, 0x10000 + ((cp - 0xD800) << 10) + (lo_cp - 0xDC00), cp)
    simple = torch.zeros(128, dtype=torch.long, device=dev)
    for c, v in _SIMPLE_ESCAPES.items():
        simple[c] = v
    cp = torch.where(is_u, cp, simple[code.clamp(max=127)])
    consumed = torch.where(pair, 12, torch.where(is_u, 6, 2))
    enc, enc_len = _utf8(cp)
    # every input byte's output length: 1, an escape's UTF-8 length, or 0
    # for the rest of an escape
    out_len = torch.ones(total + 1, dtype=torch.long, device=dev)
    cover = torch.zeros(total + 1, dtype=torch.long, device=dev)
    cover.index_add_(0, esc + 1, torch.ones_like(esc))
    cover.index_add_(0, (esc + consumed).clamp(max=total), -torch.ones_like(esc))
    out_len[torch.cumsum(cover, 0) > 0] = 0
    out_len[esc] = enc_len
    out_len = out_len[:total]
    pos = torch.cumsum(out_len, 0) - out_len
    out = torch.empty(int(out_len.sum()), dtype=torch.uint8, device=dev)
    plain = out_len == 1
    plain[esc] = False
    out[pos[plain]] = data[plain]
    for k in range(4):
        m = enc_len > k
        out[pos[esc[m]] + k] = enc[m, k]
    pre = torch.zeros(total + 1, dtype=torch.long, device=dev)
    pre[1:] = torch.cumsum(out_len, 0)
    offsets = new_offsets(pre[col.offsets[1:]] - pre[col.offsets[:-1]])
    return Column(dt.STRING, col.length, out, col.validity, offsets)


def _strip_quotes(col: Column, quoted: torch.Tensor) -> Column:
    from cudf_tpu_torch.ops.strings import gather_ranges, new_offsets

    lens = col.offsets[1:] - col.offsets[:-1]
    cut = quoted.long()
    offsets = new_offsets(lens - 2 * cut)
    return Column(dt.STRING, col.length,
                  gather_ranges(col.data, col.offsets[:-1] + cut, offsets), col.validity,
                  offsets)


def _value_column(raw: Column, lens: torch.Tensor, target=None) -> Column:
    """A column from the raw value spans (empty: missing or null), of
    ``target`` when named (as ``read_csv``'s ``dtype``: a numeric or bool
    dtype parses and a row that does not raises, "category" encodes the
    strings, "str" keeps them), else inferred."""
    from cudf_tpu_torch.io.csv_device import _infer_dtype, _widened_numbers
    from cudf_tpu_torch.ops import strings as S
    from cudf_tpu_torch.ops.copying import gather
    from cudf_tpu_torch.ops.dictionary import encode

    if target is not None:
        name = str(target)
        col = _value_column(raw, lens)
        if name == "category":
            return encode(col if col.dtype.is_string else _text_of(raw, lens))
        if name in ("str", "object", "string"):
            return col if col.dtype.is_string else _text_of(raw, lens)
        want = dt.dtype(target)
        if col.dtype == want:
            return col
        if col.dtype.is_string or col.dtype.is_bool != want.is_bool:
            present = lens > 0
            return S.to_numbers(raw if bool(present.all()) else raw.with_validity(present), want)
        from cudf_tpu_torch.ops.unary import cast

        return cast(col, want)

    n = raw.length
    present = lens > 0
    all_there = bool(present.all())
    sample_rows = torch.nonzero(present).flatten()[:_SAMPLE]
    sample = gather(raw, sample_rows, bounds_check=False).host_strings()
    first = raw.data[raw.offsets[:-1].clamp(max=max(raw.data.shape[0] - 1, 0))] \
        if raw.data.shape[0] else torch.zeros(n, dtype=torch.uint8, device=raw.device)
    if sample and all(s.startswith('"') for s in sample):
        return _text_of(raw, lens)
    if sample and all(s in ("true", "false") for s in sample):
        from cudf_tpu_torch.ops import strings as S

        is_true = S.startswith(raw, "true").data & (lens == 4)
        is_false = S.startswith(raw, "false").data & (lens == 5)
        if bool((is_true | is_false | ~present).all()):
            return Column(dt.BOOL8, n, is_true, None if all_there else present)
    target = _infer_dtype(sample)
    src = raw if all_there else raw.with_validity(present)
    if target.is_numeric:
        parsed = _widened_numbers(src, target)
        if parsed is not None:
            return parsed
    return src


def _text_of(raw: Column, lens: torch.Tensor) -> Column:
    """The values' JSON text, strings unquoted and unescaped."""
    first = raw.data[raw.offsets[:-1].clamp(max=max(raw.data.shape[0] - 1, 0))] \
        if raw.data.shape[0] else torch.zeros(raw.length, dtype=torch.uint8, device=raw.device)
    present = lens > 0
    col = unescape(_strip_quotes(raw, present & (first == 34)))
    return col if bool(present.all()) else col.with_validity(present)


def read_json_device(data, records: bool = False,
                     usecols: Optional[List[str]] = None, dtypes=None, *, device):
    """(Table on ``device``, rows) of NDJSON (``records=False``) or of a
    top-level array of flat objects, given as bytes or a uint8 array;
    ``dtypes`` {column: dtype}."""
    import warnings

    from cudf_tpu_torch.ops.strings import gather_ranges, new_offsets

    raw = data if isinstance(data, np.ndarray) else np.frombuffer(data, np.uint8)
    if records:
        head = raw[:4096][~np.isin(raw[:4096], _WHITESPACE)]
        tail = raw[-4096:][~np.isin(raw[-4096:], _WHITESPACE)]
        if head.size == 0 or head[0] != ord("[") or tail[-1] != ord("]"):
            raise ValueError("the records orient needs one top-level array")
    if raw.size == 0:
        return Table({}), 0
    with warnings.catch_warnings():     # a read-only text is only read
        warnings.simplefilter("ignore", UserWarning)
        buf = torch.from_numpy(raw).to(device)
    colon, rec_end, quotes, vend = tokenize(buf, records)
    n_rows, n_fields = rec_end.numel(), colon.numel()
    if n_fields == 0:
        return Table({}), n_rows
    row_of = torch.searchsorted(rec_end, colon)
    kq = torch.searchsorted(quotes, colon) - 1
    key_end = quotes[kq.clamp(min=0)]
    key_start = quotes[(kq - 1).clamp(min=0)] + 1
    del quotes, kq
    val_end = vend[torch.searchsorted(vend, colon, right=True).clamp(max=vend.numel() - 1)]
    val_start, val_end = _trim(buf, colon + 1, val_end)
    del vend, colon
    # a literal null is an empty span (a quoted "null" is four bytes more)
    nul = (val_end - val_start) == 4
    for k, c in enumerate(b"null"):
        nul &= buf[(val_start + k).clamp(max=buf.shape[0] - 1).long()] == c
    val_end = torch.where(nul, val_start, val_end)
    codes, raw_keys = _key_codes(buf, key_start, key_end - key_start)
    del key_start, key_end
    # the same name spelled with other escapes is the same column
    names_of = [json.loads(b'"' + k + b'"') for k in raw_keys]
    names = list(dict.fromkeys(names_of))
    remap = torch.tensor([names.index(n) for n in names_of], dtype=torch.long,
                         device=buf.device)
    codes = remap[codes]
    n_cols = len(names)
    field_ids = torch.arange(n_fields, device=buf.device)
    first = torch.full((n_cols,), n_fields, dtype=torch.long, device=buf.device)
    first.scatter_reduce_(0, codes, field_ids, "amin")
    order = torch.argsort(first).tolist()             # pandas: the order keys first appear
    fdt = _index_dtype(n_fields)
    slot = row_of.long() * n_cols + codes
    field_of = torch.full((n_rows * n_cols,), -1, dtype=fdt, device=buf.device)
    field_of.scatter_reduce_(0, slot, field_ids.to(fdt), "amax")   # a repeated key: the last
    field_of = field_of.view(n_rows, n_cols)
    del slot, codes, row_of, field_ids
    cols: Dict[str, Column] = {}
    for j in order:
        if usecols is not None and names[j] not in usecols:
            continue
        fidx = field_of[:, j].long()
        there = fidx >= 0
        f = fidx.clamp(min=0)
        starts = val_start[f].long()
        lens = torch.where(there, val_end[f].long() - starts, 0)
        offsets = new_offsets(lens)
        raw_col = Column(dt.STRING, n_rows, gather_ranges(buf, starts, offsets), None, offsets)
        cols[names[j]] = _value_column(raw_col, lens, (dtypes or {}).get(names[j]))
    return Table(cols), n_rows
