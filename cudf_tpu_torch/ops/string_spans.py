"""Match spans and what consumes them: replace, count, extract, split
(port of ``cudf_tpu/ops/string_spans.py``).

Spans live on the flat byte buffer: ``spans[p]`` is the length of the
match starting at byte p (0: none), from ``regex_engine.match_spans`` or
``literal_spans``.  ``select_greedy`` keeps the leftmost non-overlapping
ones of each row, as ``re.finditer`` and ``str.replace`` do, in one pass
of the rows a byte position a step; the consumers rebuild columns with a
prefix sum and a gather (replace.cu's size-then-copy in one program).
Where the regex engine refuses a pattern, each function raises
``regex_engine.Unsupported`` and the caller takes the host route.
"""

from __future__ import annotations

import re
from typing import List, Tuple

import torch

from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.core import bitmask as bm
from cudf_tpu_torch.ops import regex_engine as rex
from cudf_tpu_torch.ops import strings as so
from cudf_tpu_torch.utils import tracing


def max_row_len(col: Column) -> int:
    """One host sync."""
    if col.length == 0 or so.total_bytes(col) == 0:
        return 0
    return tracing.to_int(so.lengths(col).max(), "string_width")


def literal_spans(col: Column, pat: str) -> torch.Tensor:
    """int16[total]: the pattern's byte length where it starts, else 0."""
    seq = so.pattern_bytes(pat)
    if not seq:
        raise rex.Unsupported("an empty literal")
    return so.literal_match_positions(col, seq).to(torch.int16) * len(seq)


def regex_spans(col: Column, pat: str, flags: int = 0) -> torch.Tensor:
    d = rex.compile_dfa(pat, flags, search=False, strict_spans=True)
    if d.unicode and so.has_non_ascii(col):
        raise rex.Unsupported("a Unicode-aware class over non-ASCII rows")
    return rex.match_spans(col, pat, flags)


def select_greedy(col: Column, spans: torch.Tensor,
                  max_matches: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """(selected bool[total]: a kept span starts here, covered bool[total]:
    inside a kept span): each row's spans left to right, one taken where
    the last one ended, at most ``max_matches`` a row (-1: all)."""
    total = so.total_bytes(col)
    starts, lens = col.offsets[:-1], so.lengths(col)
    sel = torch.zeros(total + 1, dtype=torch.bool, device=col.device)
    covered = torch.zeros(total + 1, dtype=torch.bool, device=col.device)
    next_free = torch.zeros(col.length, dtype=torch.int64, device=col.device)
    count = torch.zeros(col.length, dtype=torch.int64, device=col.device)
    for j in range(max_row_len(col)):
        live = j < lens
        p = torch.where(live, starts + j, total)       # a dead row writes the spare slot
        ml = spans[torch.clamp(p, max=max(total - 1, 0))].long()
        take = live & (ml > 0) & (next_free <= j)
        if max_matches >= 0:
            take &= count < max_matches
        next_free = torch.where(take, j + ml, next_free)
        count += take.long()
        sel[p] = take
        covered[p] = live & (next_free > j)
    return sel[:total], covered[:total]


def assemble_replace(col: Column, sel: torch.Tensor, covered: torch.Tensor,
                     repl: str) -> Column:
    """Every kept span replaced by ``repl``: each byte emits itself, ``repl``
    (a span's first byte) or nothing (the rest of a span)."""
    rb = tracing.synced("host_values", col.device, torch.tensor,
                        so.pattern_bytes(repl) or [0], dtype=torch.uint8, device=col.device)
    r = len(so.pattern_bytes(repl))
    total = so.total_bytes(col)
    idt = so.index_dtype(total * max(r, 1))
    r_t, zero, one = (tracing.synced("host_values", col.device, torch.tensor, v, dtype=idt,
                                    device=col.device) for v in (r, 0, 1))
    emit = torch.where(covered, torch.where(sel, r_t, zero), one)
    pre = torch.zeros(total + 1, dtype=emit.dtype, device=col.device)
    torch.cumsum(emit, 0, dtype=emit.dtype, out=pre[1:])
    offsets = torch.zeros(col.length + 1, dtype=torch.int64, device=col.device)
    offsets[1:] = pre[col.offsets[1:]].long()
    out_total = tracing.to_int(offsets[-1], "string_bytes")
    q = torch.arange(out_total, dtype=pre.dtype, device=col.device)
    src = torch.searchsorted(pre[1:], q, right=True)     # the byte emitting each output byte
    within = q - pre[src]
    del q
    chars = torch.where(sel[src], rb[torch.clamp(within, max=max(r - 1, 0)).long()],
                        col.data[src])
    return Column(dt.STRING, col.length, chars, col.validity, offsets)


def replace_spans(col: Column, spans: torch.Tensor, repl: str, n: int = -1) -> Column:
    sel, covered = select_greedy(col, spans, n)
    return assemble_replace(col, sel, covered, repl)


def count_spans(col: Column, spans: torch.Tensor) -> torch.Tensor:
    """int64[n]: the non-overlapping spans of each row."""
    sel, _ = select_greedy(col, spans)
    return so.row_sums(col, sel)


def replace_re_device(col: Column, pat: str, repl: str, n: int = -1,
                      flags: int = 0) -> Column:
    if "\\" in repl:
        raise rex.Unsupported("group references in the replacement")
    return replace_spans(col, regex_spans(col, pat, flags), repl, n)


def replace_literal_device(col: Column, pat: str, repl: str, n: int = -1) -> Column:
    return replace_spans(col, literal_spans(col, pat), repl, n)


def count_re_device(col: Column, pat: str, flags: int = 0) -> Column:
    return Column(dt.INT64, col.length, count_spans(col, regex_spans(col, pat, flags)),
                  col.validity)


def extract_re_device(col: Column, pat: str, flags: int = 0) -> List[Column]:
    """``str.extract`` of a pattern that is one group around the whole of
    it (``(\\d+)``): each row's first match, null where none."""
    toks = list(rex.sre_parse.parse(pat, flags))
    if not (len(toks) == 1 and toks[0][0] is rex.sre_c.SUBPATTERN
            and re.compile(pat, flags).groups == 1):
        raise rex.Unsupported("the group is not the whole pattern")
    spans = regex_spans(col, pat, flags)
    sel, _ = select_greedy(col, spans, 1)
    pre = so.prefix(sel)
    found = so.row_sums(col, None, pre) > 0
    at = so.first_in_row(col, pre)
    ml = spans[torch.clamp(at, max=max(so.total_bytes(col) - 1, 0))].long()
    return [so.substrings(col, at, torch.where(found, ml, 0),
                          bm.and_masks(col.validity, found))]


def kth_in_row(col: Column, pre: torch.Tensor, k: int) -> torch.Tensor:
    """int64[n]: each row's k-th marked byte (0-based), or the row's end."""
    want = pre[col.offsets[:-1]].long() + k + 1
    pos = torch.searchsorted(pre[1:], want.to(pre.dtype)).long()
    return torch.minimum(pos, col.offsets[1:])


def split_columns(col: Column, pat: str, maxsplit: int = -1, regex: bool = False,
                  flags: int = 0) -> List[Column]:
    """``str.split(pat, n=maxsplit, expand=True)``: piece k of every row in
    column k, null where a row has fewer pieces (or is null)."""
    spans = regex_spans(col, pat, flags) if regex else literal_spans(col, pat)
    sel, _ = select_greedy(col, spans, maxsplit)
    pre = so.prefix(sel)
    pieces = so.row_sums(col, None, pre) + 1
    width = tracing.to_int(pieces.max(), "string_width") if col.length else 1
    total = so.total_bytes(col)
    lo = col.offsets[:-1]
    out = []
    for k in range(width):
        sep = kth_in_row(col, pre, k)
        has = k < pieces
        out.append(so.substrings(col, lo, sep - lo, bm.and_masks(col.validity, has)))
        if k + 1 < width:
            lo = sep + spans[torch.clamp(sep, max=max(total - 1, 0))].long()
    return out


def _pieces_column(col: Column, starts: torch.Tensor, ends: torch.Tensor) -> Column:
    """A STRING column of the byte ranges [starts, ends) of ``col``."""
    offsets = so.new_offsets(ends - starts)
    return Column(dt.STRING, starts.shape[0], so.gather_ranges(col.data, starts, offsets),
                  offsets=offsets)


def split_lists(col: Column, pat: str, maxsplit: int = -1, regex: bool = False,
                flags: int = 0):
    """``str.split(pat, n=maxsplit, expand=False)`` as a LIST<STRING>
    column: the kept separators, in byte order, end one piece and start
    the next; a row's first piece starts at the row, its last ends there."""
    from cudf_tpu_torch.ops.lists import make_list_column, offsets_of

    spans = regex_spans(col, pat, flags) if regex else literal_spans(col, pat)
    sel, _ = select_greedy(col, spans, maxsplit)
    valid = torch.ones(col.length, dtype=torch.bool, device=col.device) \
        if col.validity is None else col.validity
    pieces = torch.where(valid, so.row_sums(col, sel) + 1, 0)
    list_offsets = offsets_of(pieces)
    m = tracing.to_int(list_offsets[-1], "string_bytes")
    starts = torch.zeros(m, dtype=torch.int64, device=col.device)
    ends = torch.zeros(m, dtype=torch.int64, device=col.device)
    first = tracing.masked(list_offsets[:-1], valid, "compaction")
    last = tracing.masked(list_offsets[1:], valid, "compaction") - 1
    starts[first] = tracing.masked(col.offsets[:-1], valid, "compaction")
    ends[last] = tracing.masked(col.offsets[1:], valid, "compaction")
    pos = tracing.synced("compaction", sel, torch.nonzero, sel).squeeze(1)
    row = torch.searchsorted(col.offsets[1:], pos, right=True)
    keep = valid[row]
    pos, row = tracing.masked(pos, keep, "compaction"), tracing.masked(row, keep, "compaction")
    # the k-th separator of a row ends its piece k and starts piece k + 1
    k = torch.arange(pos.shape[0], device=col.device) - \
        offsets_of(torch.where(valid, pieces - 1, 0))[row]
    at = list_offsets[row] + k
    ends[at] = pos
    starts[at + 1] = pos + spans[pos].long()
    return make_list_column(list_offsets, _pieces_column(col, starts, ends),
                            None if col.validity is None else col.validity)


def findall_lists(col: Column, pat: str, flags: int = 0):
    """``str.findall`` of a pattern without groups as a LIST<STRING>
    column: every kept span, in byte order, is one element."""
    from cudf_tpu_torch.ops.lists import make_list_column, offsets_of

    spans = regex_spans(col, pat, flags)
    sel, _ = select_greedy(col, spans)
    pos = tracing.synced("compaction", sel, torch.nonzero, sel).squeeze(1)
    counts = so.row_sums(col, sel)
    if col.validity is not None:
        counts = torch.where(col.validity, counts, 0)
        pos = pos[col.validity[torch.searchsorted(col.offsets[1:], pos, right=True)]]
    return make_list_column(offsets_of(counts),
                            _pieces_column(col, pos, pos + spans[pos].long()), col.validity)
