"""String operations over the bytes-plus-offsets layout (port of
``cudf_tpu/ops/strings.py``).

A STRING column is ``data`` (uint8, every row's UTF-8 bytes one after
another) and ``offsets`` (int64[n + 1]).  The ops here work on those
buffers on the column's device:

- per-row reductions are differences of one prefix sum taken at the
  offsets (``row_sums``), and the first or last byte of a row with a
  property is a ``torch.searchsorted`` over that prefix sum
  (``first_in_row``, ``last_in_row``), so most ops need no byte -> row
  map at all;
- where one is needed (``byte_rows``) it is one prefix sum of row-start
  marks, int32 while the rows fit, and so are the prefix sums while the
  bytes fit: at 1.2e9 bytes each such array is 4.8 GB, not 9.6;
- an op that changes the bytes rebuilds the column once: each output
  byte made from its row and its place in the row (``build_bytes``, a
  chunk of output bytes at a time, so no per-byte int64 array outgrows
  the chunk), per-row byte ranges gathered into new offsets
  (``substrings``); each costs one host sync for the new byte count.

Case maps, the character classes and ``slice`` are UTF-8 aware
(``ops/unicode_case.py`` decodes code points where a byte is not ASCII).
The regex ops run the device DFA of ``ops/regex_engine.py`` and the
span consumers of ``ops/string_spans.py``.  Numbers and timestamps parse
and format on the device too (the reference formats floats and parses
timestamps through pandas).  What none of them covers (a pattern with
backreferences or lookaround, an expanding case map such as ß -> SS, a
float past 15 digits, "inf", a timestamp that is not fixed-width ISO
8601, float and duration text, ``split_record``'s lists) runs per row on
the host; ``STRING_ROUTES`` counts every op by the route it took.

Unlike the reference, ``get(i)`` past a row's end is null, as in pandas
(the reference slices and gives "").
"""

from __future__ import annotations

import functools
import re
from typing import Callable, List, Optional

import numpy as np
import torch

from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.core import bitmask as bm
from cudf_tpu_torch.ops import datetime as dto
from cudf_tpu_torch.utils import tracing

# how many string ops took each route: "device" (the column's own
# device) or "host" (a Python loop over the rows)
STRING_ROUTES = {"device": 0, "host": 0}
_DEPTH = [0]
_INT32_MAX = 2 ** 31 - 1


def counted(fn):
    """Counts one call of a string op as ``device`` unless it, or an op it
    calls, took the host route; nested ops count once, at the outermost."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        _DEPTH[0] += 1
        before = STRING_ROUTES["host"]
        try:
            out = fn(*args, **kwargs)
        finally:
            _DEPTH[0] -= 1
        if _DEPTH[0] == 0 and STRING_ROUTES["host"] == before:
            STRING_ROUTES["device"] += 1
        return out
    return run


# ----------------------------------------------------------------------
# infrastructure
# ----------------------------------------------------------------------

def index_dtype(count: int) -> torch.dtype:
    """int32 while ``count`` positions fit it, else int64."""
    return torch.int32 if count <= _INT32_MAX else torch.int64


def total_bytes(col: Column) -> int:
    return int(col.data.shape[0])


def lengths(col: Column) -> torch.Tensor:
    """int64[n] byte lengths."""
    return col.offsets[1:] - col.offsets[:-1]


def prefix(mask: torch.Tensor) -> torch.Tensor:
    """[total + 1]: prefix[k] = mask[:k].sum(), int32 while it fits."""
    out = torch.zeros(mask.shape[0] + 1, dtype=index_dtype(mask.shape[0]), device=mask.device)
    torch.cumsum(mask, 0, dtype=out.dtype, out=out[1:])
    return out


def row_sums(col: Column, mask: torch.Tensor, pre: Optional[torch.Tensor] = None):
    """int64[n]: how many bytes of each row ``mask`` marks."""
    pre = prefix(mask) if pre is None else pre
    return (pre[col.offsets[1:]] - pre[col.offsets[:-1]]).long()


def first_in_row(col: Column, pre: torch.Tensor) -> torch.Tensor:
    """int64[n]: each row's first marked byte (absolute), or the row's end
    when it has none; ``pre`` is ``prefix`` of the marks."""
    want = pre[col.offsets[:-1]] + 1
    pos = torch.searchsorted(pre[1:], want.to(pre.dtype)).long()
    return torch.minimum(pos, col.offsets[1:])


def last_in_row(col: Column, pre: torch.Tensor) -> torch.Tensor:
    """int64[n]: each row's last marked byte (absolute), or -1 + the row's
    start when it has none."""
    have = pre[col.offsets[1:]]
    pos = torch.searchsorted(pre[1:], have).long()
    none = have == pre[col.offsets[:-1]]
    return torch.where(none, col.offsets[:-1] - 1, pos)


def byte_rows(offsets: torch.Tensor, total: int) -> torch.Tensor:
    """[total]: the row of every byte (int32 while the rows fit): a prefix
    sum of marks at the rows' starts."""
    n = offsets.shape[0] - 1
    idt = index_dtype(n)
    marks = torch.zeros(total + 1, dtype=idt, device=offsets.device)
    if n > 1:
        marks.index_add_(0, offsets[1:n], torch.ones(n - 1, dtype=idt, device=offsets.device))
    return torch.cumsum(marks[:total], 0, dtype=idt)


def new_offsets(lens: torch.Tensor) -> torch.Tensor:
    out = torch.zeros(lens.shape[0] + 1, dtype=torch.int64, device=lens.device)
    torch.cumsum(lens, 0, out=out[1:])
    return out


def build_bytes(offsets: torch.Tensor, make: Callable, chunk: int = 1 << 27) -> torch.Tensor:
    """uint8[offsets[-1]]: ``make(row, within)`` of every output byte (its
    row, int64, and its position in the row), ``chunk`` bytes at a time so
    that no per-byte int64 array outgrows the chunk (one host sync)."""
    total = tracing.to_int(offsets[-1], "string_bytes")
    out = torch.empty(total, dtype=torch.uint8, device=offsets.device)
    rows = byte_rows(offsets, total)
    for a in range(0, total, chunk):
        row = rows[a:a + chunk].long()
        q = torch.arange(a, a + row.shape[0], device=offsets.device)
        out[a:a + row.shape[0]] = make(row, q - offsets[row])
    return out


def gather_ranges(data: torch.Tensor, starts: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Row i's output bytes [offsets[i], offsets[i + 1]) copied from
    ``data`` at ``starts[i]``."""
    return build_bytes(offsets, lambda row, within: data[starts[row] + within])


def substrings(col: Column, starts: torch.Tensor, lens: torch.Tensor,
               validity: Optional[torch.Tensor] = None) -> Column:
    """A STRING column of each row's bytes [starts, starts + lens) (absolute
    byte positions in ``col``), rows null where ``validity`` is False."""
    lens = torch.clamp(lens, min=0)
    if validity is not None:
        lens = torch.where(validity, lens, 0)
    offsets = new_offsets(lens)
    return Column(dt.STRING, col.length, gather_ranges(col.data, starts, offsets), validity,
                  offsets)


def is_char_start(chars: torch.Tensor) -> torch.Tensor:
    return (chars & 0xC0) != 0x80


def has_non_ascii(col: Column) -> bool:
    """One host sync."""
    return total_bytes(col) > 0 and tracing.to_bool((col.data >= 128).any(), "ascii_check")


def _bools(col: Column, data: torch.Tensor) -> Column:
    return Column(dt.BOOL8, col.length, data, col.validity)


def _ints(col: Column, data: torch.Tensor) -> Column:
    return Column(dt.INT64, col.length, data.long(), col.validity)


def host_map(col: Column, fn: Callable, dtype) -> Column:
    """The host route: ``fn`` of every valid row's Python string, nulls
    kept; counted in ``STRING_ROUTES``."""
    STRING_ROUTES["host"] += 1
    vals = col.host_strings()
    out = [None if v is None else fn(v) for v in vals]
    return Column.from_pylist(out, dtype, device=col.device)


def over_keys(col: Column, op: Callable):
    """``op`` of a STRING column; of a dictionary column, ``op`` of its keys
    gathered by code (a list of columns gathered each), null where the
    code is."""
    if not col.dtype.is_dictionary:
        return op(col)
    from cudf_tpu_torch.ops.copying import gather

    out = op(col.keys)
    codes = col.data if col.validity is None else torch.where(col.validity, col.data, 0)

    def by_code(c):
        g = gather(c, codes.long(), bounds_check=False)
        return g.with_validity(bm.and_masks(g.validity, col.validity))
    return [by_code(c) for c in out] if isinstance(out, list) else by_code(out)


def pattern_bytes(pat: str) -> List[int]:
    return list(pat.encode("utf-8"))


# ----------------------------------------------------------------------
# attributes
# ----------------------------------------------------------------------

@counted
def length(col: Column) -> Column:
    """Characters a row (count_characters): bytes that start a character
    (ASCII text: the byte lengths, after one check)."""
    if not has_non_ascii(col):
        return _ints(col, lengths(col))
    return _ints(col, row_sums(col, is_char_start(col.data)))


@counted
def byte_count(col: Column) -> Column:
    return _ints(col, lengths(col))


# ----------------------------------------------------------------------
# case maps
# ----------------------------------------------------------------------

def _ascii_case(b: torch.Tensor, kind: str) -> torch.Tensor:
    upper = (b >= 65) & (b <= 90)
    lower = (b >= 97) & (b <= 122)
    if kind == "lower":
        return torch.where(upper, b + 32, b)
    if kind == "upper":
        return torch.where(lower, b - 32, b)
    return torch.where(upper, b + 32, torch.where(lower, b - 32, b))      # swapcase


def _case(col: Column, kind: str, python: Callable) -> Column:
    if has_non_ascii(col) or kind in ("capitalize", "title"):
        from cudf_tpu_torch.ops import unicode_case as uc

        out = uc.case_map(col, kind) if total_bytes(col) else col
        if out is None:
            return host_map(col, python, dt.STRING)
        return out
    return Column(dt.STRING, col.length, _ascii_case(col.data, kind), col.validity, col.offsets)


@counted
def lower(col: Column) -> Column:
    return _case(col, "lower", str.lower)


@counted
def upper(col: Column) -> Column:
    return _case(col, "upper", str.upper)


@counted
def swapcase(col: Column) -> Column:
    return _case(col, "swapcase", str.swapcase)


@counted
def capitalize(col: Column) -> Column:
    return _case(col, "capitalize", str.capitalize)


@counted
def title(col: Column) -> Column:
    return _case(col, "title", str.title)


# ----------------------------------------------------------------------
# character classes
# ----------------------------------------------------------------------

_ASCII_CLASSES = {
    "isdigit": lambda b: (b >= 48) & (b <= 57),
    "isdecimal": lambda b: (b >= 48) & (b <= 57),
    "isnumeric": lambda b: (b >= 48) & (b <= 57),
    "isalpha": lambda b: ((b >= 65) & (b <= 90)) | ((b >= 97) & (b <= 122)),
    "isalnum": lambda b: ((b >= 48) & (b <= 57)) | ((b >= 65) & (b <= 90))
    | ((b >= 97) & (b <= 122)),
    "isspace": lambda b: (b == 32) | ((b >= 9) & (b <= 13)),
}


def _char_class(col: Column, kind: str) -> Column:
    """pandas' ``str.isX``: every character in the class and the row not
    empty; ``isupper``/``islower``: a cased character and none of the other
    case."""
    if has_non_ascii(col):
        from cudf_tpu_torch.ops import unicode_case as uc

        out = uc.char_class_all(col, kind)
        if out is None:
            return host_map(col, getattr(str, kind), dt.BOOL8)
        return out
    b = col.data
    if kind in ("isupper", "islower"):
        up = row_sums(col, (b >= 65) & (b <= 90)) > 0
        lo = row_sums(col, (b >= 97) & (b <= 122)) > 0
        return _bools(col, (up & ~lo) if kind == "isupper" else (lo & ~up))
    misses = row_sums(col, ~_ASCII_CLASSES[kind](b))
    return _bools(col, (misses == 0) & (lengths(col) > 0))


def _class_op(kind):
    def op(col: Column) -> Column:
        return _char_class(col, kind)
    op.__name__ = kind
    return counted(op)


isdigit = _class_op("isdigit")
isdecimal = _class_op("isdecimal")
isnumeric = _class_op("isnumeric")
isalpha = _class_op("isalpha")
isalnum = _class_op("isalnum")
isspace = _class_op("isspace")
isupper = _class_op("isupper")
islower = _class_op("islower")


# ----------------------------------------------------------------------
# strip, slice, get
# ----------------------------------------------------------------------

@counted
def strip(col: Column, to_strip: Optional[str] = None, side: str = "both") -> Column:
    """cudf::strings::strip: whitespace, or the characters of ``to_strip``
    (ASCII ones byte by byte, others as whole UTF-8 sequences), off
    either end."""
    b = col.data
    if to_strip is None:
        strip_mask = _ASCII_CLASSES["isspace"](b)
    else:
        strip_mask = torch.zeros_like(b, dtype=torch.bool)
        for ch in set(to_strip):
            seq = pattern_bytes(ch)
            strip_mask |= _literal_covered(col, seq) if len(seq) > 1 else (b == seq[0])
    keep = prefix(~strip_mask)
    lo = first_in_row(col, keep) if side in ("both", "left") else col.offsets[:-1]
    hi = last_in_row(col, keep) + 1 if side in ("both", "right") else col.offsets[1:]
    return substrings(col, lo, torch.maximum(hi - lo, torch.zeros_like(lo)), col.validity)


def _literal_covered(col: Column, seq) -> torch.Tensor:
    """bool[total]: bytes inside an occurrence of the byte sequence."""
    starts = literal_match_positions(col, seq)
    out = starts.clone()
    for j in range(1, len(seq)):
        out[j:] |= starts[:-j]
    return out


def _bounds(v: Optional[int], default: torch.Tensor, nchars: torch.Tensor) -> torch.Tensor:
    if v is None:
        return default
    v = torch.full_like(nchars, v)
    return torch.clamp(torch.where(v < 0, nchars + v, v), min=torch.zeros_like(nchars),
                       max=nchars)


@counted
def slice_strings(col: Column, start: Optional[int] = None, stop: Optional[int] = None,
                  step: Optional[int] = None) -> Column:
    """Characters [start:stop] of every row, as Python slices them."""
    if step not in (None, 1):
        return host_map(col, lambda s: s[start:stop:step], dt.STRING)
    pre, nchars = char_bytes(col)
    s = _bounds(start, torch.zeros_like(nchars), nchars)
    e = torch.maximum(_bounds(stop, nchars, nchars), s)
    lo = byte_of_char(col, pre, nchars, s)
    hi = byte_of_char(col, pre, nchars, e)
    return substrings(col, lo, hi - lo, col.validity)


def char_bytes(col: Column):
    """(prefix of character starts, characters a row): the tools that turn
    character positions into byte positions; ASCII text (one check) needs
    neither, and gives None for the prefix."""
    if not has_non_ascii(col):
        return None, lengths(col)
    pre = prefix(is_char_start(col.data))
    return pre, (pre[col.offsets[1:]] - pre[col.offsets[:-1]]).long()


def byte_of_char(col: Column, pre: Optional[torch.Tensor], nchars: torch.Tensor,
                 k: torch.Tensor) -> torch.Tensor:
    """Absolute byte position of character ``k`` (0 <= k <= nchars) of
    each row: the row's end when k == nchars."""
    if pre is None:
        return col.offsets[:-1] + torch.minimum(k, nchars)
    base = pre[col.offsets[:-1]].long()
    pos = torch.searchsorted(pre[1:], (base + k + 1).to(pre.dtype)).long()
    return torch.where(k >= nchars, col.offsets[1:], torch.minimum(pos, col.offsets[1:]))


@counted
def get(col: Column, i: int) -> Column:
    """Character ``i`` of every row; null where the row is shorter (pandas)."""
    pre, nchars = char_bytes(col)
    k = torch.full_like(nchars, i)
    k = torch.where(k < 0, nchars + k, k)
    inside = (k >= 0) & (k < nchars)
    k = torch.where(inside, k, 0)
    lo = byte_of_char(col, pre, nchars, k)
    hi = byte_of_char(col, pre, nchars, k + 1)
    return substrings(col, lo, hi - lo, bm.and_masks(col.validity, inside))


# ----------------------------------------------------------------------
# literal find, contains, count, affixes
# ----------------------------------------------------------------------

def literal_match_positions(col: Column, seq) -> torch.Tensor:
    """bool[total]: the byte sequence starts at this byte and ends inside
    the same row."""
    total, k = total_bytes(col), len(seq)
    if total == 0 or k == 0:
        return torch.full((total,), k == 0, dtype=torch.bool, device=col.device)
    b = col.data
    match = torch.zeros(total, dtype=torch.bool, device=col.device)
    if k > total:
        return match
    m = match[:total - k + 1]
    m.copy_(b[:total - k + 1] == seq[0])
    for j in range(1, k):
        m &= b[j:total - k + 1 + j] == seq[j]
    # a match must not run over its row's end: no row may start inside it
    if k > 1:
        starts = torch.zeros(total + 1, dtype=torch.bool, device=col.device)
        starts[col.offsets[1:-1]] = True
        crosses = torch.zeros(total, dtype=torch.bool, device=col.device)
        for j in range(1, k):
            crosses[:total - j] |= starts[j:total]
        match &= ~crosses
    return match


@counted
def contains_literal(col: Column, pat: str) -> Column:
    if pat == "":
        return _bools(col, torch.ones(col.length, dtype=torch.bool, device=col.device))
    return _bools(col, row_sums(col, literal_match_positions(col, pattern_bytes(pat))) > 0)


@counted
def find_literal(col: Column, pat: str, from_end: bool = False) -> Column:
    """Character position of the first (last) occurrence, -1 when none
    (find.cu)."""
    if pat == "":
        pre, nchars = char_bytes(col)
        return _ints(col, nchars if from_end else torch.zeros_like(nchars))
    pm = prefix(literal_match_positions(col, pattern_bytes(pat)))
    found = row_sums(col, None, pm) > 0
    at = last_in_row(col, pm) if from_end else first_in_row(col, pm)
    cpre, _ = char_bytes(col)
    chars_before = at - col.offsets[:-1] if cpre is None else \
        (cpre[torch.clamp(at, min=0)] - cpre[col.offsets[:-1]]).long()
    return _ints(col, torch.where(found, chars_before, -1))


def _affix(col: Column, pat: str, at_end: bool) -> torch.Tensor:
    seq = pattern_bytes(pat)
    lens = lengths(col)
    ok = lens >= len(seq)
    total = total_bytes(col)
    if not seq or total == 0:
        return ok
    base = col.offsets[1:] - len(seq) if at_end else col.offsets[:-1]
    for j, c in enumerate(seq):
        ok = ok & (col.data[torch.clamp(base + j, 0, total - 1)] == c)
    return ok


@counted
def startswith(col: Column, pat: str) -> Column:
    return _bools(col, _affix(col, pat, False))


@counted
def endswith(col: Column, pat: str) -> Column:
    return _bools(col, _affix(col, pat, True))


def _has_border(seq) -> bool:
    """Whether two occurrences of the sequence can overlap."""
    return any(seq[:k] == seq[-k:] for k in range(1, len(seq)))


@counted
def count_literal(col: Column, pat: str) -> Column:
    """Non-overlapping occurrences (str.count); a pattern whose occurrences
    can overlap takes the greedy span selection."""
    seq = pattern_bytes(pat)
    if not seq:
        pre, nchars = char_bytes(col)
        return _ints(col, nchars + 1)
    if _has_border(seq):
        from cudf_tpu_torch.ops import string_spans as sp

        return _ints(col, sp.count_spans(col, sp.literal_spans(col, pat)))
    return _ints(col, row_sums(col, literal_match_positions(col, seq)))


# ----------------------------------------------------------------------
# padding and repetition
# ----------------------------------------------------------------------

def _fill_bytes(fillchar: str) -> torch.Tensor:
    if len(fillchar) != 1:
        raise TypeError("fillchar must be a character, not str")
    return torch.tensor(pattern_bytes(fillchar), dtype=torch.uint8)


@counted
def pad(col: Column, width: int, side: str = "left", fillchar: str = " ") -> Column:
    """ljust / rjust / center (pad.cu): ``width`` characters, ``side`` the
    side padded ("left": rjust; "both": CPython's centring)."""
    fill = _fill_bytes(fillchar).to(col.device)
    f = fill.shape[0]
    nchars = length(col).data
    lens = lengths(col)
    padn = torch.clamp(width - nchars, min=0)
    if side == "left":
        left = padn
    elif side == "right":
        left = torch.zeros_like(padn)
    else:                                     # str.center: marg // 2 + (marg & width & 1)
        left = padn // 2 + (padn & width & 1)
    offsets = new_offsets(lens + padn * f)
    last = max(total_bytes(col) - 1, 0)

    def make(row, within):
        lp, ln = left[row] * f, lens[row]
        body = (within >= lp) & (within < lp + ln)
        filler = fill[torch.where(within < lp, within, within - lp - ln) % f]
        if not total_bytes(col):
            return filler
        src = torch.clamp(col.offsets[:-1][row] + within - lp, 0, last)
        return torch.where(body, col.data[src], filler)
    return Column(dt.STRING, col.length, build_bytes(offsets, make), col.validity, offsets)


@counted
def zfill(col: Column, width: int) -> Column:
    """Zeros on the left, after a leading sign (str.zfill)."""
    nchars = length(col).data
    lens = lengths(col)
    padn = torch.clamp(width - nchars, min=0)
    total_in = total_bytes(col)
    first = col.data[torch.clamp(col.offsets[:-1], 0, max(total_in - 1, 0))] if total_in \
        else torch.zeros(col.length, dtype=torch.uint8, device=col.device)
    sign = ((lens > 0) & ((first == ord("+")) | (first == ord("-")))).long()
    offsets = new_offsets(lens + padn)

    def make(row, within):
        hs, pn = sign[row], padn[row]
        src = col.offsets[:-1][row] + torch.where(within < hs, within, within - pn)
        chars = col.data[torch.clamp(src, 0, total_in - 1)] if total_in else \
            torch.zeros_like(src, dtype=torch.uint8)
        return torch.where((within >= hs) & (within < hs + pn), 48, chars).to(torch.uint8)
    return Column(dt.STRING, col.length, build_bytes(offsets, make), col.validity, offsets)


@counted
def repeat_strings(col: Column, times: int) -> Column:
    """Each row ``times`` times (repeat_strings.cu)."""
    lens = lengths(col)
    offsets = new_offsets(lens * max(int(times), 0))
    data = build_bytes(offsets, lambda row, within: col.data[
        col.offsets[:-1][row] + within % torch.clamp(lens[row], min=1)])
    return Column(dt.STRING, col.length, data, col.validity, offsets)


# ----------------------------------------------------------------------
# regex
# ----------------------------------------------------------------------

def _regex_or_host(col: Column, device_fn, host_fn, dtype):
    """The device route, or the host route when the regex engine refuses
    the pattern (or its Unicode-aware classes meet non-ASCII rows)."""
    from cudf_tpu_torch.ops.regex_engine import Unsupported

    try:
        return device_fn()
    except Unsupported:
        return host_map(col, host_fn, dtype)


def _predicate(col: Column, pat: str, flags: int, mode: str, python) -> Column:
    from cudf_tpu_torch.ops import regex_engine as rex

    def device():
        d = rex.compile_dfa(pat, flags, search=mode == "search")
        if d.unicode and has_non_ascii(col):
            raise rex.Unsupported("a Unicode-aware class over non-ASCII rows")
        return _bools(col, rex.run_predicate(col, pat, flags, mode))
    rx = re.compile(pat, flags)
    return _regex_or_host(col, device, lambda s: getattr(rx, python)(s) is not None, dt.BOOL8)


@counted
def contains_re(col: Column, pat: str, flags: int = 0) -> Column:
    return _predicate(col, pat, flags, "search", "search")


@counted
def match_re(col: Column, pat: str, flags: int = 0) -> Column:
    return _predicate(col, pat, flags, "match", "match")


@counted
def fullmatch_re(col: Column, pat: str, flags: int = 0) -> Column:
    return _predicate(col, pat, flags, "fullmatch", "fullmatch")


@counted
def replace_re(col: Column, pat: str, repl: str, n: int = -1, flags: int = 0) -> Column:
    from cudf_tpu_torch.ops import string_spans as sp

    rx = re.compile(pat, flags)
    return _regex_or_host(col, lambda: sp.replace_re_device(col, pat, repl, n, flags),
                          lambda s: rx.sub(repl, s, count=max(n, 0)), dt.STRING)


@counted
def count_re(col: Column, pat: str, flags: int = 0) -> Column:
    from cudf_tpu_torch.ops import string_spans as sp

    rx = re.compile(pat, flags)
    return _regex_or_host(col, lambda: sp.count_re_device(col, pat, flags),
                          lambda s: len(rx.findall(s)), dt.INT64)


@counted
def extract_re(col: Column, pat: str, flags: int = 0) -> List[Column]:
    """One STRING column a group: each row's first match's groups, null
    where the row does not match."""
    from cudf_tpu_torch.ops import regex_engine as rex
    from cudf_tpu_torch.ops import string_spans as sp

    try:
        return sp.extract_re_device(col, pat, flags)
    except rex.Unsupported:
        pass
    rx = re.compile(pat, flags)
    STRING_ROUTES["host"] += 1
    found = [None if v is None else rx.search(v) for v in col.host_strings()]
    return [Column.from_strings([m.group(g + 1) if m else None for m in found],
                                device=col.device) for g in range(rx.groups)]


@counted
def replace_literal(col: Column, pat: str, repl: str, n: int = -1) -> Column:
    from cudf_tpu_torch.ops import string_spans as sp

    if not pat:
        return host_map(col, lambda s: s.replace(pat, repl, n), dt.STRING)
    return sp.replace_literal_device(col, pat, repl, n)


@counted
def split_expand(col: Column, sep: Optional[str], maxsplit: int = -1,
                 regex: bool = False) -> List[Column]:
    """``str.split(sep, n=maxsplit, expand=True)``: one STRING column a
    piece, null where a row has fewer (split.cu's expand mode)."""
    from cudf_tpu_torch.ops import regex_engine as rex
    from cudf_tpu_torch.ops import string_spans as sp

    if sep:
        try:
            return sp.split_columns(col, sep, maxsplit, regex)
        except rex.Unsupported:
            pass
    STRING_ROUTES["host"] += 1
    if regex and sep:
        rx = re.compile(sep)
        parts = [None if v is None else rx.split(v, maxsplit=max(maxsplit, 0))
                 for v in col.host_strings()]
    else:
        parts = [None if v is None else v.split(sep or None, maxsplit)
                 for v in col.host_strings()]
    width = max((len(p) for p in parts if p is not None), default=0)
    return [Column.from_strings([p[i] if p is not None and i < len(p) else None
                                 for p in parts], device=col.device) for i in range(width)]


@counted
def split_record(col: Column, sep: Optional[str], maxsplit: int = -1,
                 regex: bool = False) -> Column:
    """``str.split(sep, n=maxsplit, expand=False)``: a LIST<STRING> column
    of each row's pieces, null where the row is (split_record.cu); on the
    device where the span engine takes the separator, else the host."""
    from cudf_tpu_torch.ops import regex_engine as rex
    from cudf_tpu_torch.ops import string_spans as sp
    from cudf_tpu_torch.ops.lists import from_pylists

    if sep:
        try:
            return sp.split_lists(col, sep, maxsplit, regex)
        except rex.Unsupported:
            pass
    STRING_ROUTES["host"] += 1
    if regex and sep:
        rx = re.compile(sep)
        parts = [None if v is None else rx.split(v, maxsplit=max(maxsplit, 0))
                 for v in col.host_strings()]
    else:
        parts = [None if v is None else v.split(sep or None, maxsplit)
                 for v in col.host_strings()]
    return from_pylists(parts, dt.STRING, device=col.device)


@counted
def findall_re(col: Column, pat: str, flags: int = 0) -> Column:
    """``str.findall``: a LIST<STRING> column of each row's non-overlapping
    matches, left to right, null where the row is; on the device for a
    pattern without groups that the span engine takes, else the host
    (``re.findall``, which gives the groups)."""
    from cudf_tpu_torch.ops import regex_engine as rex
    from cudf_tpu_torch.ops import string_spans as sp
    from cudf_tpu_torch.ops.lists import from_pylists

    rx = re.compile(pat, flags)
    if rx.groups == 0:
        try:
            return sp.findall_lists(col, pat, flags)
        except rex.Unsupported:
            pass
    STRING_ROUTES["host"] += 1
    return from_pylists([None if v is None else rx.findall(v) for v in col.host_strings()],
                        None if rx.groups > 1 else dt.STRING, device=col.device)


def join_strings(col: Column, sep: str = "") -> Optional[str]:
    """Every valid row joined by ``sep`` (None when there is none), read
    back as one host string."""
    keep = [v for v in col.host_strings() if v is not None]
    return sep.join(keep) if keep else None


@counted
def concat(parts, chunk: int = 1 << 27) -> Column:
    """Row-wise concatenation of STRING columns and host strings (at least
    one column); a row is null where any column's is.  Each part's bytes
    are scattered to their place, ``chunk`` bytes at a time."""
    cols = [p for p in parts if isinstance(p, Column)]
    ref = cols[0]
    n, dev = ref.length, ref.device
    lens = []
    for p in parts:
        if isinstance(p, Column):
            lens.append(lengths(p))
        else:
            lens.append(torch.full((n,), len(p.encode("utf-8")), dtype=torch.int64, device=dev))
    offsets = new_offsets(sum(lens))
    out = torch.empty(tracing.to_int(offsets[-1], "string_bytes"), dtype=torch.uint8, device=dev)
    at = offsets[:-1].clone()                 # where each row's next part goes
    for p, ln in zip(parts, lens):
        if not isinstance(p, Column):
            for i, b in enumerate(pattern_bytes(p)):
                out[at + i] = b
        elif total_bytes(p):                  # the part's bytes, moved by their row's shift
            rows, shift = byte_rows(p.offsets, total_bytes(p)), at - p.offsets[:-1]
            for a in range(0, total_bytes(p), chunk):
                row = rows[a:a + chunk].long()
                dest = torch.arange(a, a + row.shape[0], device=dev) + shift[row]
                out[dest] = p.data[a:a + row.shape[0]]
        at = at + ln
    return Column(dt.STRING, n, out, bm.and_masks(*[c.validity for c in cols]), offsets)


# ----------------------------------------------------------------------
# parsing: strings -> numbers and timestamps
# ----------------------------------------------------------------------

def _row_byte(col: Column, j, lo: torch.Tensor) -> torch.Tensor:
    """Byte ``lo + j`` of each row as int64 (0 past the buffer)."""
    total = total_bytes(col)
    if total == 0:
        return torch.zeros_like(lo)
    return col.data[torch.clamp(lo + j, max=total - 1)].long()


def parse_numbers(col: Column, floats: bool):
    """(values int64 or float64 [n], parsed bool[n]) of every row,
    surrounding whitespace ignored: integers ``[+-]?d+`` (at most 18
    digits), floats ``[+-]?(d+[.d*]|.d+)([eE][+-]?d+)?``, held exact by one
    rounding (at most 15 significant digits and a power of ten within
    1e+-22).  One pass over the byte positions, every row at once.  Rows
    outside those (longer numbers, "inf", "nan") are parsed on the host,
    counted in ``STRING_ROUTES``.  ``parsed`` is False for a null row and
    for a row that is no number."""
    starts, ln = col.offsets[:-1], lengths(col)
    width = tracing.to_int(ln.max(), "string_width") if col.length else 0
    if 0 < width <= (15 if floats else 18) and \
            tracing.to_bool(((col.data >= 48) & (col.data <= 57)).all(), "digit_check"):
        return _parse_digits(col, floats, width)
    zero = torch.zeros(col.length, dtype=torch.int64, device=col.device)
    no = torch.zeros(col.length, dtype=torch.bool, device=col.device)
    mant, sig, digits, frac, eval_, enum, exp_chars, letters, lead = (zero.clone()
                                                                      for _ in range(9))
    neg, eneg, dot, in_exp, started, ended = (no.clone() for _ in range(6))
    ok = ~no
    for j in range(width):
        b = _row_byte(col, j, starts)
        inrow = j < ln
        ws = inrow & _ASCII_CLASSES["isspace"](b)
        ch = inrow & ~ws
        ok &= ~(ch & ended)                  # text after the trailing whitespace
        ended |= started & ws
        first = ch & ~started
        started |= ch
        isd = (b >= 48) & (b <= 57)
        sign = (b == 43) | (b == 45)
        letter = ch & ((b | 32) >= 97) & ((b | 32) <= 122)
        lead = torch.where(letter & (letters == 0), b | 32, lead)
        letters += letter.long()
        m = ch & ~in_exp                     # the mantissa
        lead_sign = first & sign
        neg |= lead_sign & (b == 45)
        take = m & isd
        sig += (take & ((mant > 0) | (b > 48))).long()
        mant = torch.where(take & (sig <= 18), mant * 10 + (b - 48), mant)
        digits += take.long()
        frac += (take & dot).long()
        is_dot = m & (b == 46) & ~dot
        is_e = m & ((b | 32) == 101) & (digits > 0)
        fine = isd | lead_sign
        if floats:
            fine = fine | is_dot | is_e
            x = ch & in_exp                  # the exponent
            x_sign = x & sign & (exp_chars == 0)
            eneg |= x_sign & (b == 45)
            ok &= ~x | isd | x_sign
            eval_ = torch.where(x & isd & (enum < 6), eval_ * 10 + (b - 48), eval_)
            enum += (x & isd).long()
            exp_chars += x.long()
            in_exp |= is_e
        ok &= ~m | fine
        dot |= is_dot & floats
    ok &= digits > 0
    exp10 = -frac + torch.clamp(sig - 18, min=0)   # digits past 18 were dropped
    if floats:
        ok &= ~in_exp | (enum > 0)
        exp10 = exp10 + torch.where(eneg, -eval_, eval_)
        exact = (sig <= 15) & (exp10.abs() <= 22)
    else:
        exact = sig <= 18
    valid = ok if col.validity is None else ok & col.validity
    if floats:
        m = mant.double()
        p = torch.pow(10.0, exp10.abs().double())
        values = torch.where(exp10 >= 0, m * p, m / p)
        values = torch.where(neg, -values, values)
    else:
        values = torch.where(neg, -mant, mant)
    # rows the device cannot hold exact, or that spell inf / nan: the host
    spelled = ~ok & (digits == 0) & ((letters == 3) | (letters == 8)) & \
        ((lead == 105) | (lead == 110)) if floats else torch.zeros_like(ok)
    host = ((ok & ~exact) | spelled) if col.validity is None else \
        ((ok & ~exact) | spelled) & col.validity
    rows = tracing.synced("host_route", host, torch.nonzero, host).squeeze(1)
    if rows.numel():
        from cudf_tpu_torch.ops.copying import gather

        STRING_ROUTES["host"] += 1
        got = []
        for s in gather(col, rows, bounds_check=False).host_strings():
            try:
                v = float(s) if floats else int(s)
            except (ValueError, OverflowError):
                v = None
            got.append(None if not floats and v is not None and not -2 ** 63 <= v < 2 ** 63
                       else v)
        good = tracing.synced("host_values", col.device, torch.tensor,
                              [g is not None for g in got], dtype=torch.bool, device=col.device)
        vals = tracing.synced("host_values", col.device, torch.tensor,
                              [0 if g is None else g for g in got],
                              dtype=values.dtype, device=col.device)
        values[rows] = vals
        valid[rows] = good
    return values, valid


def _parse_digits(col: Column, floats: bool, width: int):
    """``parse_numbers`` of rows made of digits alone (one check): a fold
    of the digits, exact in int64 and, at most 15 of them, in float64."""
    starts, ln = col.offsets[:-1], lengths(col)
    value = torch.zeros(col.length, dtype=torch.int64, device=col.device)
    for j in range(width):
        value = torch.where(j < ln, value * 10 + (_row_byte(col, j, starts) - 48), value)
    ok = ln > 0 if col.validity is None else (ln > 0) & col.validity
    return (value.double() if floats else value), ok


def first_unparsed(col: Column, parsed: torch.Tensor) -> Optional[tuple]:
    """(position, string) of the first valid row that did not parse, or
    None: one host sync."""
    bad = ~parsed if col.validity is None else col.validity & ~parsed
    rows = tracing.synced("parse_errors", bad, torch.nonzero, bad).squeeze(1)
    if rows.numel() == 0:
        return None
    from cudf_tpu_torch.ops.copying import gather

    i = tracing.to_int(rows[0], "parse_errors")
    return i, gather(col, rows[:1], bounds_check=False).host_strings()[0]


@counted
def to_numbers(col: Column, target: dt.DType) -> Column:
    """cudf::strings::to_integers / to_floats into ``target``: a row that is
    no number raises ValueError, as pandas' ``astype``."""
    if target.is_bool:
        raise TypeError("a cast of strings to bool: pandas gives every non-empty string "
                        "True; use a comparison")
    values, parsed = parse_numbers(col, target.is_float)
    bad = first_unparsed(col, parsed)
    if bad is not None:
        raise ValueError(f"could not convert string to {target!r}: {bad[1]!r}")
    return Column(target, col.length, values.to(target.torch_storage),
                  None if col.validity is None else parsed)


_MONTHS = ("January", "February", "March", "April", "May", "June", "July", "August",
           "September", "October", "November", "December")
_DAYS = ("Monday", "Tuesday", "Wednesday", "Thursday", "Friday", "Saturday", "Sunday")
# a directive's field: (name, digits) of a number; the names are text
_NUMERIC = {"Y": ("year", 4), "m": ("month", 2), "d": ("day", 2), "H": ("hour", 2),
            "M": ("minute", 2), "S": ("second", 2), "y": ("year2", 2), "j": ("doy", 3),
            "I": ("hour12", 2), "f": ("micro", 6), "w": ("wday_sun", 1), "u": ("wday_iso", 1),
            "U": ("week_sun", 2), "W": ("week_mon", 2), "G": ("iso_year", 4),
            "V": ("iso_week", 2)}
_TEXT = {"b": [m[:3] for m in _MONTHS], "B": list(_MONTHS), "a": [d[:3] for d in _DAYS],
         "A": list(_DAYS), "p": ["AM", "PM"]}
# the C locale's %c, %x and %X, as Python's strftime gives them (%c's day
# is padded with a space)
_LOCALE = {"c": "%a %b %_d %H:%M:%S %Y", "x": "%m/%d/%y", "X": "%H:%M:%S"}


def _directives(fmt: str, tz: Optional[str] = None):
    """The format's pieces: ("lit", text), ("num", field, digits),
    ("num_sp", field, digits) (padded with spaces), ("text", directive),
    ("offset", colon) or ("zone",), or None when a directive is outside
    Python's documented set (the host route).  ``%3f`` / ``%9f``
    (fractions of 3 and 9 digits), ``%.f`` (a row's own fraction, as a
    Timestamp prints it: none, 6 or 9 digits after a dot) and ``%:z`` (the
    UTC offset as +HH:MM, +HH:MM:SS where it has seconds) are this
    module's own; ``%z`` is +HHMM (+HHMMSS), and ``%z`` and ``%Z`` of a
    naive column are empty, as Python gives them."""
    out, i = [], 0
    while i < len(fmt):
        c = fmt[i]
        if c != "%":
            out.append(("lit", c))
            i += 1
            continue
        d = fmt[i + 1:i + 2]
        if d in ("3", "9", ":", ".", "_"):
            d, i = fmt[i + 1:i + 3], i + 3
        else:
            i += 2
        if d == "%":
            out.append(("lit", "%"))
        elif d in _NUMERIC:
            out.append(("num",) + _NUMERIC[d])
        elif d == "_d":
            out.append(("num_sp", "day", 2))
        elif d in _LOCALE:
            out.extend(_directives(_LOCALE[d], tz))
        elif d in ("3f", "9f"):
            out.append(("num", "milli" if d == "3f" else "nano", int(d[0])))
        elif d in _TEXT:
            out.append(("text", d))
        elif d in (":z", "z"):
            if tz is not None:
                out.append(("offset", d == ":z"))
        elif d == "Z":
            if tz is not None:
                out.append(("zone",))
        elif d == ".f":
            out.append(("fraction",))
        else:
            return None
    return out


# the name directives whose names are all of one width (%c's among them)
_FIXED_NAMES = ("a", "b", "p")


def _text_index(d: str, f: dict) -> torch.Tensor:
    """Each row's name in ``_TEXT[d]``."""
    return {"b": f["month"] - 1, "B": f["month"] - 1, "a": f["weekday"], "A": f["weekday"],
            "p": f["ampm"]}[d]


def _text_table(names, dev):
    width = max(len(s) for s in names)
    tab = torch.zeros(len(names), width, dtype=torch.uint8)
    for i, s in enumerate(names):
        tab[i, :len(s)] = torch.tensor(list(s.encode()), dtype=torch.uint8)
    return (tracing.synced("host_values", dev, tab.to, dev),
            tracing.synced("host_values", dev, torch.tensor, [len(s) for s in names], device=dev))


@counted
def strftime(col: Column, fmt: str) -> Column:
    """``dt.strftime`` on the device: each directive a per-row field
    written as its digits (or a month, day or zone name), null where the
    timestamp is.  A directive outside Python's documented set takes the
    host route (Python's ``strftime`` of each value, as the reference
    formats every directive)."""
    pieces = _directives(fmt, col.dtype.tz)
    if pieces is None:
        return _strftime_host(col, fmt)
    f = dto.strftime_parts(col)
    n, dev = col.length, col.device
    if all(p[0] in ("lit", "num", "num_sp") or (p[0] == "text" and p[1] in _FIXED_NAMES)
           for p in pieces):
        return _fixed_width_text(col, pieces, f)
    lens, makers = [], []
    for piece in pieces:
        if piece[0] == "lit":
            raw = tracing.synced("host_values", dev, torch.tensor, pattern_bytes(piece[1]),
                                 dtype=torch.uint8, device=dev)
            lens.append(torch.full((n,), raw.shape[0], dtype=torch.int64, device=dev))
            makers.append(lambda row, w, raw=raw: raw[torch.clamp(w, max=raw.shape[0] - 1)])
        elif piece[0] in ("num", "num_sp"):
            v, k = f[piece[1]], piece[2]
            lens.append(torch.full((n,), k, dtype=torch.int64, device=dev))
            pow10 = tracing.synced("host_values", dev, torch.tensor,
                                   [10 ** (k - 1 - i) for i in range(k)], device=dev)

            def digit(row, w, v=v, pow10=pow10, k=k, spaced=piece[0] == "num_sp"):
                p = pow10[torch.clamp(w, max=k - 1)]
                out = 48 + v[row].abs() // p % 10
                if spaced:
                    out = torch.where((v[row].abs() < p) & (w < k - 1), 32, out)
                return out.to(torch.uint8)
            makers.append(digit)
        elif piece[0] == "zone":
            from cudf_tpu_torch.ops import timezone

            idx = timezone.abbreviation_ids(col.data, col.dtype.tz, col.dtype.time_unit)
            tab, tlen = _text_table(timezone.abbreviations(col.dtype.tz), dev)
            lens.append(tlen[idx])
            makers.append(lambda row, w, tab=tab, idx=idx:
                          tab[idx[row], torch.clamp(w, max=tab.shape[1] - 1)])
        elif piece[0] == "text":
            d = piece[1]
            idx = _text_index(d, f)
            tab, tlen = _text_table(_TEXT[d], dev)
            lens.append(tlen[idx])
            makers.append(lambda row, w, tab=tab, idx=idx:
                          tab[idx[row], torch.clamp(w, max=tab.shape[1] - 1)])
        elif piece[0] == "fraction":
            ns = f["nano"]
            k = torch.where(ns == 0, 0, torch.where(ns % 1000 == 0, 7, 10))
            lens.append(k)

            def fraction(row, w, ns=ns, k=k):
                digits = torch.where(k[row] == 7, ns[row] // 1000, ns[row])
                p = torch.clamp(k[row] - 1 - w, 0, 8)
                return torch.where(w == 0, 46, 48 + digits // 10 ** p % 10).to(torch.uint8)
            makers.append(fraction)
        else:               # +HH:MM (+HH:MM:SS), or +HHMM (+HHMMSS): seconds where it has them
            off, colon = f["offset_sec"], piece[1]
            step = 3 if colon else 2
            lens.append(torch.where(off % 60 != 0, 9, 6) if colon else
                        torch.where(off % 60 != 0, 7, 5))
            sep = tracing.synced("host_values", dev, torch.tensor, pattern_bytes("+-:"),
                                 dtype=torch.uint8, device=dev)

            def offset(row, w, off=off, sep=sep, step=step):
                o = off[row]
                a = o.abs()
                hms = torch.stack([a // 3600, a // 60 % 60, a % 60])
                # w: 0 sign, then two digits a field, with ':' between them at step 3
                field = hms.gather(0, torch.clamp((w - 1) // step, 0, 2)[None])[0]
                dig = (48 + torch.where((w - 1) % step == 0, field // 10, field % 10)).to(
                    torch.uint8)
                if step == 3:
                    dig = torch.where(w % 3 == 0, sep[2], dig)
                return torch.where(w == 0, sep[(o < 0).long()], dig)
            makers.append(offset)
    if col.validity is not None:
        lens = [torch.where(col.validity, ln, 0) for ln in lens]
    offsets = new_offsets(sum(lens))

    def make_all(row, within):
        out = torch.zeros(within.shape[0], dtype=torch.uint8, device=dev)
        lo = torch.zeros_like(within)
        for ln, make in zip(lens, makers):
            hi = lo + ln[row]
            out = torch.where((within >= lo) & (within < hi),
                              make(row, torch.clamp(within - lo, min=0)), out)
            lo = hi
        return out
    return Column(dt.STRING, n, build_bytes(offsets, make_all), col.validity, offsets)


def _fixed_width_text(col: Column, pieces, f) -> Column:
    """strftime of literals, numbers and names of one width (%a, %b, %p):
    every row the same width, so a (rows x width) byte matrix filled a
    column at a time."""
    cols = []
    for piece in pieces:
        if piece[0] == "lit":
            cols += [torch.full((col.length,), b, dtype=torch.uint8, device=col.device)
                     for b in pattern_bytes(piece[1])]
        elif piece[0] == "text":
            tab, _ = _text_table(_TEXT[piece[1]], col.device)
            names = tab[_text_index(piece[1], f)]
            cols += list(names.unbind(1))
        else:
            v, k = f[piece[1]].abs(), piece[2]
            for i in range(k):
                digit = 48 + v // 10 ** (k - 1 - i) % 10
                if piece[0] == "num_sp" and i < k - 1:
                    digit = torch.where(v < 10 ** (k - 1 - i), 32, digit)
                cols.append(digit.to(torch.uint8))
    mat = torch.stack(cols, 1)
    lens = torch.full((col.length,), mat.shape[1], dtype=torch.int64, device=col.device)
    if col.validity is not None:
        mat, lens = mat[col.validity], torch.where(col.validity, lens, 0)
    return Column(dt.STRING, col.length, mat.reshape(-1), col.validity, new_offsets(lens))


def _strftime_host(col: Column, fmt: str) -> Column:
    """The host route of ``strftime``: Python's ``datetime.strftime`` of
    each value's wall clock (to the microsecond), as pandas formats."""
    import datetime as _dt

    STRING_ROUTES["host"] += 1
    wall = col
    if col.dtype.tz is not None:
        from cudf_tpu_torch.ops import timezone

        wall = timezone.wall_clock_column(col)
    days, secs, sub, tps = dto.days_and_time(wall.data, col.dtype.time_unit)
    micros = tracing.tolist(sub * 1_000_000 // tps, "export")
    epoch = _dt.datetime(1970, 1, 1)
    valid = [True] * col.length if col.validity is None else tracing.tolist(col.validity, "export")
    out = [(epoch + _dt.timedelta(days=d, seconds=s, microseconds=u)).strftime(fmt) if ok
           else None for d, s, u, ok in zip(tracing.tolist(days, "export"),
                                                 tracing.tolist(secs, "export"), micros, valid)]
    return Column.from_strings(out, device=col.device)


def _iso_template(col: Column, fmt: Optional[str]):
    """The fixed-width layout of ``fmt`` (None: ISO 8601 "%Y-%m-%d", then an
    optional "[T ]%H:%M:%S" and fraction): [(field, start, digits)], the
    literal bytes [(position, byte)], and the fraction's start or None."""
    if fmt is None:
        return None
    fields, lits, pos, frac = [], [], 0, None
    for piece in _directives(fmt) or [("host",)]:
        if piece[0] == "lit":
            for b in pattern_bytes(piece[1]):
                lits.append((pos, b))
                pos += 1
        elif piece[0] == "num" and piece[1] == "micro":
            if frac is not None:
                raise NotImplementedError("a format with two fractions")
            frac = pos
            pos += 9        # up to 9 digits; only at the end
        elif piece[0] == "num" and piece[1] in ("year", "month", "day", "hour", "minute",
                                                "second"):
            fields.append((piece[1], pos, piece[2]))
            pos += piece[2]
        else:
            raise NotImplementedError(f"to_datetime format {fmt!r}: fixed-width numeric "
                                      "fields only")
    return fields, lits, pos, frac


def _parse_timestamps(col: Column, fmt: Optional[str]):
    """(days int64 [n], seconds of the day int64 [n], nanoseconds of the
    second int64 [n], parsed bool[n], fraction digits int64 [n]) of
    fixed-width ISO 8601 rows or rows of ``fmt``'s fixed fields: kept apart
    until the unit is known, so that years 1-9999 hold in any unit that
    holds them."""
    lo, hi = col.offsets[:-1], col.offsets[1:]
    ln = hi - lo
    dev = col.device
    zero = torch.zeros(col.length, dtype=torch.int64, device=dev)

    def num(start, k):
        v, ok = zero.clone(), ln >= start + k
        for j in range(k):
            b = _row_byte(col, start + j, lo)
            ok &= (b >= 48) & (b <= 57)
            v = v * 10 + (b - 48)
        return v, ok

    def lit(pos, ch):
        return (ln > pos) & (_row_byte(col, pos, lo) == ord(ch))

    t = _iso_template(col, fmt)
    if t is None:                                  # ISO 8601
        y, ok = num(0, 4)
        mo, ok2 = num(5, 2)
        d, ok3 = num(8, 2)
        ok = ok & ok2 & ok3 & lit(4, "-") & lit(7, "-")
        hh = mi = ss = zero
        # times too: one sync spares dates
        if col.length and tracing.to_int(ln.max(), "string_width") > 10:
            timed = ln > 10
            sep = lit(10, "T") | lit(10, " ")
            hh, a = num(11, 2)
            mi, b = num(14, 2)
            ss, c = num(17, 2)
            with_s = ln > 16
            ok &= ~timed | (sep & a & b & lit(13, ":") & (ln >= 16))
            ok &= ~with_s | (lit(16, ":") & c)
            hh, mi = torch.where(timed, hh, 0), torch.where(timed, mi, 0)
            ss = torch.where(with_s, ss, 0)
            fixed = torch.where(with_s, 19, torch.where(timed, 16, 10))
            ok &= (ln == fixed) | ((fixed == 19) & lit(19, ".") & (ln > 20))
        else:
            ok &= ln == 10
        frac_at = torch.where(ln > 19, 20, ln)
    else:
        fields, lits, width, frac = t
        vals = {"year": zero, "month": zero + 1, "day": zero + 1, "hour": zero,
                "minute": zero, "second": zero}
        ok = torch.ones(col.length, dtype=torch.bool, device=dev)
        for name, start, k in fields:
            vals[name], good = num(start, k)
            ok &= good
        for pos, b in lits:
            ok &= lit(pos, chr(b))
        y, mo, d = vals["year"], vals["month"], vals["day"]
        hh, mi, ss = vals["hour"], vals["minute"], vals["second"]
        if frac is None:
            ok &= ln == width
            frac_at = ln
        else:
            ok &= (ln > frac) & (ln <= width)
            frac_at = torch.full_like(ln, frac)
    ndig = torch.clamp(ln - frac_at, min=0)
    ok &= ndig <= 9
    fr = zero.clone()
    for j in range(min(tracing.to_int(ndig.max(), "string_width") if col.length else 0, 9)):
        b = _row_byte(col, j, lo + frac_at)
        inside = j < ndig
        ok &= ~inside | ((b >= 48) & (b <= 57))
        fr = fr + torch.where(inside, (b - 48) * 10 ** (8 - j), 0)
    ok &= (mo >= 1) & (mo <= 12) & (d >= 1) & (hh < 24) & (mi < 60) & (ss < 60)
    ok &= d <= dto.days_in_month(y, torch.clamp(mo, 1, 12))
    days = dto.days_from_civil(y, torch.clamp(mo, 1, 12), d)
    if col.validity is not None:
        ok &= col.validity
    return days, hh * 3600 + mi * 60 + ss, fr, ok, torch.where(ok, ndig, 0)


@counted
def to_timestamps(col: Column, format: Optional[str] = None, errors: str = "raise",
                  target: Optional[dt.DType] = None) -> Column:
    """Strings -> timestamps on the device (convert_datetime.cu): ISO 8601
    (``YYYY-MM-DD[( |T)HH:MM[:SS[.f]]]``) or a format of fixed-width
    numeric fields.  Rows the device rejects are tried on the host
    (``datetime.fromisoformat`` / ``strptime``, counted) and then raise
    ValueError, or are NaT under ``errors="coerce"``.  The unit is
    pandas 3's: microseconds, nanoseconds where a fraction has more than 6
    digits; or ``target``'s."""
    import datetime as _datetime

    days, secs, frac, ok, ndig = _parse_timestamps(col, format)
    missed = ~ok if col.validity is None else col.validity & ~ok
    rows = tracing.synced("host_route", missed, torch.nonzero, missed).squeeze(1)
    if rows.numel():
        from cudf_tpu_torch.ops.copying import gather

        STRING_ROUTES["host"] += 1
        epoch = _datetime.datetime(1970, 1, 1)
        got = []
        for s in gather(col, rows, bounds_check=False).host_strings():
            try:
                v = _datetime.datetime.strptime(s, format) if format else \
                    _datetime.datetime.fromisoformat(s)
                if v.tzinfo is not None:
                    v = v.astimezone(_datetime.timezone.utc).replace(tzinfo=None)
                delta = v - epoch
                got.append((delta.days, delta.seconds, delta.microseconds * 1000))
            except ValueError:
                if errors == "raise":
                    raise ValueError(f"time data {s!r} doesn't match format "
                                     f"{format or 'ISO8601'!r}") from None
                got.append(None)
        parts = tracing.synced("host_values", col.device, torch.tensor,
                               [(0, 0, 0) if g is None else g for g in got],
                               dtype=torch.int64, device=col.device).reshape(-1, 3)
        days[rows], secs[rows], frac[rows] = parts[:, 0], parts[:, 1], parts[:, 2]
        ok[rows] = tracing.synced("host_values", col.device, torch.tensor,
                                 [g is not None for g in got], device=col.device)
        ndig[rows] = torch.where(parts[:, 2] % 1000 != 0, 9, 0)
    if target is None:
        fine = tracing.to_bool((ndig > 6).any(), "digit_check")
        target = dt.TIMESTAMP_NS if fine else dt.unit_dtype("M", "us")
    tps = {"s": 1, "ms": 10 ** 3, "us": 10 ** 6, "ns": 10 ** 9}[target.time_unit]
    seconds = days * 86400 + secs
    if target.time_unit == "ns":
        # datetime64[ns] holds 1677-09-21 00:12:43.145224192 to
        # 2262-04-11 23:47:16.854775807
        lo_s, lo_ns, hi_s, hi_ns = -9223372037, 145224192, 9223372036, 854775807
        inside = ((seconds > lo_s) | ((seconds == lo_s) & (frac >= lo_ns))) & \
            ((seconds < hi_s) | ((seconds == hi_s) & (frac <= hi_ns)))
        outside = ok & ~inside
        if tracing.to_bool(outside.any(), "range_check"):
            if errors == "raise":
                from cudf_tpu_torch.ops.copying import gather

                at = tracing.synced("range_check", outside, torch.nonzero, outside)[:1, 0]
                first = gather(col, at, bounds_check=False)
                raise OutOfBoundsDatetime(
                    f"Out of bounds nanosecond timestamp: {first.host_strings()[0]}")
            ok &= inside
    out = seconds * tps + torch.div(frac, 10 ** 9 // tps, rounding_mode="floor")
    valid = ok if (col.validity is not None
                   or not tracing.to_bool(ok.all(), "null_check")) else None
    return Column(target, col.length, torch.where(ok, out, 0), valid)


class OutOfBoundsDatetime(ValueError):
    """A timestamp outside what its unit holds (pandas' error of that name)."""


# ----------------------------------------------------------------------
# formatting: numbers, bools and timestamps -> strings
# ----------------------------------------------------------------------

def _format_ints(col: Column) -> Column:
    """Decimal digits of every integer (from_integers.cu): a digit peel
    with truncating division, so INT64_MIN needs no absolute value."""
    x = col.data.long()
    neg = (x < 0).long()
    ndig = torch.ones_like(x)
    for k in range(1, 19):
        ndig += (torch.div(x, 10 ** k, rounding_mode="trunc") != 0).long()
    offsets = new_offsets(ndig + neg)
    pow10 = tracing.synced("host_values", x.device, torch.tensor, [10 ** k for k in range(19)],
                           device=x.device)

    def make(row, within):
        k = torch.clamp(ndig[row] - 1 - (within - neg[row]), 0, 18)
        dig = torch.fmod(torch.div(x[row], pow10[k], rounding_mode="trunc"), 10).abs()
        return torch.where((neg[row] == 1) & (within == 0), 45, dig + 48).to(torch.uint8)
    return Column(dt.STRING, col.length, build_bytes(offsets, make), col.validity, offsets)


def _format_bools(col: Column) -> Column:
    table = tracing.synced("host_values", col.device, torch.tensor, pattern_bytes("FalseTrue"),
                           dtype=torch.uint8, device=col.device)
    true = col.data.long()
    offsets = new_offsets(5 - true)
    data = build_bytes(offsets, lambda row, within: table[within + 5 * true[row]])
    return Column(dt.STRING, col.length, data, col.validity, offsets)


def _timestamp_format(col: Column) -> str:
    """pandas' text of a timestamp column: the date alone when every valid
    value is a naive midnight, else the time too, with the fewest fraction
    digits (3, 6 or 9) that hold every value; a tz-aware column's rows as
    its Timestamps print (their own fraction, the UTC offset): one sync."""
    f = dto.strftime_parts(col)
    valid = torch.ones_like(f["nano"], dtype=torch.bool) if col.validity is None \
        else col.validity
    ns = torch.where(valid, f["nano"], 0)
    clock = torch.where(valid, f["hour"] * 3600 + f["minute"] * 60 + f["second"], 0)
    any_ns, any_us, any_ms, any_time = tracing.tolist(torch.stack([
        (ns % 1000 != 0).any(), (ns % 10 ** 6 != 0).any(), (ns != 0).any(),
        (clock != 0).any()]), "time_units")
    if not (any_ms or any_time) and col.dtype.tz is None:
        return "%Y-%m-%d"
    if col.dtype.tz is not None:
        return "%Y-%m-%d %H:%M:%S%.f%:z"
    return "%Y-%m-%d %H:%M:%S" + (".%9f" if any_ns else ".%f" if any_us else
                                  ".%3f" if any_ms else "")


def _format_duration(ticks: int, unit: str) -> str:
    per = {"s": 1, "ms": 10 ** 3, "us": 10 ** 6, "ns": 10 ** 9}[unit]
    days, rem = divmod(ticks, 86400 * per)
    secs, sub = divmod(rem, per)
    text = f"{days} days {'+' if days < 0 else ''}{secs // 3600:02d}:{secs % 3600 // 60:02d}:" \
           f"{secs % 60:02d}"
    ns = sub * (10 ** 9 // per)
    if ns:                   # as a Timedelta prints: 6 digits, 9 below a microsecond
        text += f".{ns:09d}" if ns % 1000 else f".{ns // 1000:06d}"
    return text


@counted
def from_column(col: Column) -> Column:
    """Numbers, bools and temporals -> their text as pandas' ``astype(str)``
    gives it; nulls stay null.  Integers, bools and timestamps format on
    the device; floats (Python's shortest repr) and durations on the host."""
    d = col.dtype
    if d.is_integer and d.id != dt.TypeId.UINT64:
        return _format_ints(col)
    if d.is_bool:
        return _format_bools(col)
    if d.is_timestamp:
        return strftime(col, _timestamp_format(col))
    if d.is_float:
        one = (lambda v: str(np.float32(v))) if d.id == dt.TypeId.FLOAT32 else repr
        return _host_values(col, one)
    if d.is_duration or d.id == dt.TypeId.UINT64:
        one = (lambda v: _format_duration(v, d.time_unit)) if d.is_duration else str
        return _host_values(col, one)
    raise TypeError(f"cannot format a {d!r} column as strings")


def _host_values(col: Column, one) -> Column:
    """The host route for formatting: ``one`` of every valid value."""
    STRING_ROUTES["host"] += 1
    data = tracing.synced("export", col.data, col.data.cpu)
    if col.dtype.id == dt.TypeId.UINT64:
        data = data.view(torch.int64).numpy().view(np.uint64)
    values = data.tolist()
    valid = [True] * col.length if col.validity is None else tracing.tolist(col.validity, "export")
    return Column.from_strings([one(v) if ok else None for v, ok in zip(values, valid)],
                               device=col.device)
