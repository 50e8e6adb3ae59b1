"""nvtext-style text operations (port of ``cudf_tpu/ops/text.py``;
libcudf's nvtext: tokenize.cu, generate_ngrams.cu, minhash.cu, jaccard.cu,
edit_distance.cu, normalize.cu).

On the column's device, over the bytes and offsets:

- ``count_tokens``, ``normalize_spaces`` and ``minhash``, as the
  reference has them (``minhash`` a chunk of rows at a time, its int64
  shingle hashes bounded by ``CHUNK_BYTES``);
- ``tokenize``, ``character_ngrams``, ``ngrams_tokenize``,
  ``jaccard_index`` and ``tokenize_with_vocabulary``, which the reference
  computes on the host: tokens are spans of the bytes (a whitespace
  token, as Python's ``str.split()`` gives it, is a maximal run of bytes
  that are no whitespace, the multi-byte Unicode spaces included; a
  delimiter splits through ``ops/string_spans.py`` ``split_lists``),
  n-grams are spans over the character starts, and a Jaccard index counts
  the distinct shingles of each row by a sort of their bytes packed into
  int64 words.  The outputs are the reference's.

On the host, as in the reference, each call counted in
``ops/_utils.py`` ``HOST_ROUTES``: ``edit_distance``,
``porter_stemmer_measure``, ``wordpiece_tokenize`` and
``byte_pair_encoding`` (sequential per token by construction).
"""

from __future__ import annotations

import re
from typing import List, Optional

import torch

from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.ops import strings as so
from cudf_tpu_torch.ops._utils import count_host_route
from cudf_tpu_torch.ops.lists import from_pylists, make_list_column, offsets_of
from cudf_tpu_torch.ops.row_ops import _s64, _shr, lex_sort_permutation
from cudf_tpu_torch.utils import tracing

__all__ = ["count_tokens", "tokenize", "character_ngrams", "ngrams_tokenize", "minhash",
           "jaccard_index", "edit_distance", "normalize_spaces", "porter_stemmer_measure",
           "tokenize_with_vocabulary", "wordpiece_tokenize", "byte_pair_encoding"]

# per-byte int64 work (shingle hashes, packed shingles) is done this many
# bytes of the column at a time
CHUNK_BYTES = 1 << 27

# the UTF-8 sequences of the non-ASCII code points Python's str.split()
# takes for whitespace: U+0085, U+00A0, U+1680, U+2000-U+200A, U+2028,
# U+2029, U+202F, U+205F, U+3000
_WIDE_SPACES = ([(0xC2, 0x85), (0xC2, 0xA0), (0xE1, 0x9A, 0x80), (0xE2, 0x80, 0xA8),
                 (0xE2, 0x80, 0xA9), (0xE2, 0x80, 0xAF), (0xE2, 0x81, 0x9F), (0xE3, 0x80, 0x80)]
                + [(0xE2, 0x80, b) for b in range(0x80, 0x8B)])


def _is_space(b: torch.Tensor) -> torch.Tensor:
    """The reference's device whitespace: space and \\t-\\r."""
    return (b == 32) | ((b >= 9) & (b <= 13))


def _python_space(data: torch.Tensor) -> torch.Tensor:
    """bool per byte: part of a character Python's ``str.isspace`` holds
    (ASCII \\t-\\r, \\x1c-\\x1f and space, and the multi-byte spaces)."""
    sp = ((data >= 9) & (data <= 13)) | ((data >= 28) & (data <= 32))
    if data.numel() and tracing.to_bool((data >= 0xC2).any(), "ascii_check"):
        total = data.shape[0]
        for seq in _WIDE_SPACES:
            k = len(seq)
            if total < k:
                continue
            hit = torch.ones(total - k + 1, dtype=torch.bool, device=data.device)
            for i, b in enumerate(seq):
                hit &= data[i:total - k + 1 + i] == b
            for i in range(k):
                sp[i:total - k + 1 + i] |= hit
    return sp


def _row_valid(col: Column) -> torch.Tensor:
    return torch.ones(col.length, dtype=torch.bool, device=col.device) \
        if col.validity is None else col.validity


def _byte_row(col: Column) -> torch.Tensor:
    return so.byte_rows(col.offsets, so.total_bytes(col)).long()


def _pieces(col: Column, starts: torch.Tensor, ends: torch.Tensor) -> Column:
    """A STRING column of the byte ranges [starts, ends) of ``col``."""
    offsets = so.new_offsets(ends - starts)
    return Column(dt.STRING, starts.shape[0], so.gather_ranges(col.data, starts, offsets),
                  offsets=offsets)


def _row_ranges(col: Column, per_byte: int = 1):
    """(lo, hi, first byte, end byte) of consecutive row ranges of about
    ``CHUNK_BYTES / per_byte`` bytes each: the cuts searched on the device,
    one host sync for all of them."""
    step = max(CHUNK_BYTES // per_byte, 1)
    total = so.total_bytes(col)
    want = torch.arange(step, max(total, step), step, device=col.device)
    cuts = torch.searchsorted(col.offsets, want, right=True) - 1
    bounds = torch.cat([cuts.new_zeros(1), cuts, cuts.new_full((1,), col.length)])
    bounds = tracing.synced("text_chunks", bounds, torch.unique_consecutive, bounds)
    rows = tracing.tolist(bounds, "text_chunks")
    starts = tracing.tolist(col.offsets[bounds], "text_chunks")
    for i in range(len(rows) - 1):
        if rows[i + 1] > rows[i]:
            yield rows[i], rows[i + 1], starts[i], starts[i + 1]


def _rows(col: Column, lo: int, hi: int, a: int, b: int) -> Column:
    """Rows [lo, hi) of a STRING column whose bytes are [a, b): views."""
    return Column(dt.STRING, hi - lo, col.data[a:b],
                  None if col.validity is None else col.validity[lo:hi],
                  col.offsets[lo:hi + 1] - a)


def _chunked(col: Column, fn) -> Column:
    """``fn`` of each chunk of rows (``_row_ranges``), the results
    concatenated: per-byte work bounded by ``CHUNK_BYTES``."""
    from cudf_tpu_torch.ops import copying

    if so.total_bytes(col) <= CHUNK_BYTES:
        return fn(col)
    return copying.concatenate([fn(_rows(col, *r)) for r in _row_ranges(col)])


def count_tokens(col: Column, delimiter: Optional[str] = None) -> Column:
    """INT64 tokens a row (tokenize.cu's counting pass): a token starts at
    a byte that is no separator after a separator or at its row's start;
    the separator is ASCII whitespace, or ``delimiter``'s first character."""
    if so.total_bytes(col) > CHUNK_BYTES:
        return _chunked(col, lambda part: count_tokens(part, delimiter))
    total = so.total_bytes(col)
    if total == 0:
        return Column(dt.INT64, col.length, torch.zeros(col.length, dtype=torch.int64,
                                                        device=col.device), col.validity)
    b = col.data
    sep = _is_space(b) if delimiter is None else b == ord(delimiter[0])
    start = ~sep
    start[1:] &= sep[:-1]
    first = col.offsets[:-1][so.lengths(col) > 0]          # a row's first byte
    start[first] = ~sep[first]
    return Column(dt.INT64, col.length, so.row_sums(col, start), col.validity)


def _token_spans(col: Column):
    """(starts, ends, row) int64 of every whitespace token of the valid
    rows, in byte order: ``str.split()``'s pieces."""
    total = so.total_bytes(col)
    if total == 0:
        z = torch.zeros(0, dtype=torch.int64, device=col.device)
        return z, z, z
    word = ~_python_space(col.data)
    if col.validity is not None:
        word &= col.validity[_byte_row(col)]
    begin, end = word.clone(), word.clone()
    begin[1:] &= ~word[:-1]
    end[:-1] &= ~word[1:]
    # a token never crosses a row's border
    cuts = col.offsets[1:-1][col.offsets[1:-1] < total]
    begin[cuts] = word[cuts]
    end[cuts - 1] = word[cuts - 1]
    starts = tracing.synced("compaction", begin, torch.nonzero, begin).squeeze(1)
    ends = tracing.synced("compaction", end, torch.nonzero, end).squeeze(1) + 1
    return starts, ends, torch.searchsorted(col.offsets[1:], starts, right=True)


def _tokens(col: Column, delimiter: Optional[str] = None):
    """(every non-empty piece of ``str.split(delimiter)`` of the valid rows
    as a STRING column, each piece's row)."""
    if delimiter is None:
        starts, ends, row = _token_spans(col)
        return _pieces(col, starts, ends), row
    from cudf_tpu_torch.ops import copying
    from cudf_tpu_torch.ops.string_spans import split_lists

    lists = split_lists(col, delimiter)
    nonempty = so.lengths(lists.children[0]) > 0
    keep = tracing.synced("compaction", nonempty, torch.nonzero, nonempty).squeeze(1)
    return (copying.gather(lists.children[0], keep, bounds_check=False),
            torch.searchsorted(lists.offsets[1:], keep, right=True))


def tokenize(col: Column, delimiter: Optional[str] = None) -> Column:
    """Every token of every valid row, as one STRING column (tokenize.cu)."""
    return _chunked(col, lambda part: _tokens(part, delimiter)[0])


def _list_validity(col: Column):
    if col.validity is None or tracing.to_bool(col.validity.all(), "null_check"):
        return None
    return col.validity


def _char_starts(col: Column):
    """(character start positions (int64, byte order) of the valid rows,
    their row, characters a row)."""
    cs = so.is_char_start(col.data)
    if col.validity is not None and cs.numel():
        cs &= col.validity[_byte_row(col)]
    pos = tracing.synced("compaction", cs, torch.nonzero, cs).squeeze(1)
    return pos, torch.searchsorted(col.offsets[1:], pos, right=True), so.row_sums(col, cs)


def _ngram_spans(col: Column, n: int):
    """(starts, ends, grams a row): every run of n characters of each row."""
    pos, row, nchars = _char_starts(col)
    local = torch.arange(pos.shape[0], device=col.device) - offsets_of(nchars)[row]
    keep = local + n <= nchars[row]
    # the gram ends where the character n places on starts, or at its row's end
    after = torch.cat([pos, col.offsets[-1:]])
    nxt = after[torch.clamp(torch.arange(pos.shape[0], device=col.device) + n,
                            max=pos.shape[0])]
    ends = torch.where(local + n < nchars[row], nxt, col.offsets[1:][row])
    return (tracing.masked(pos, keep, "compaction"), tracing.masked(ends, keep, "compaction"),
            torch.clamp(nchars - n + 1, min=0))


def character_ngrams(col: Column, n: int = 2) -> Column:
    """LIST<STRING>: each row's n-grams of characters (generate_ngrams.cu),
    a null row null."""
    starts, ends, counts = _ngram_spans(col, n)
    counts = torch.where(_row_valid(col), counts, 0)
    return make_list_column(offsets_of(counts), _pieces(col, starts, ends),
                            _list_validity(col))


def ngrams_tokenize(col: Column, n: int = 2, separator: str = "_") -> Column:
    """LIST<STRING>: each row's n-grams of whitespace tokens joined by
    ``separator``, a null row null."""
    starts, ends, row = _token_spans(col)
    ntok = tracing.synced("token_counts", row, torch.bincount, row, minlength=col.length,
                          syncs=2) if row.numel() else \
        torch.zeros(col.length, dtype=torch.int64, device=col.device)
    first_tok = offsets_of(ntok)
    grams = torch.clamp(ntok - n + 1, min=0)
    # gram g of row r starts at the row's token first_tok[r] + (g - its first gram)
    gram_row = tracing.synced("token_counts", grams, torch.repeat_interleave,
                              torch.arange(col.length, device=col.device), grams)
    t0 = first_tok[:-1][gram_row] + torch.arange(gram_row.shape[0], device=col.device) - \
        offsets_of(grams)[:-1][gram_row]
    tok_len = ends - starts
    sep = tracing.synced("host_values", col.device, torch.tensor, so.pattern_bytes(separator),
                         dtype=torch.uint8, device=col.device)
    k_sep = sep.shape[0]
    cum = torch.cat([torch.zeros(1, dtype=torch.int64, device=col.device),
                     torch.cumsum(tok_len, 0)])
    gram_len = cum[t0 + n] - cum[t0] + (n - 1) * k_sep
    offsets = so.new_offsets(gram_len)

    def make(g, w):
        out = torch.zeros(w.shape[0], dtype=torch.uint8, device=col.device)
        at = torch.zeros_like(w)
        for k in range(n):
            tk = t0[g] + k
            ln = tok_len[tk]
            in_tok = (w >= at) & (w < at + ln)
            out = torch.where(in_tok, col.data[torch.where(in_tok, starts[tk] + w - at, 0)], out)
            at = at + ln
            if k < n - 1 and k_sep:
                in_sep = (w >= at) & (w < at + k_sep)
                out = torch.where(in_sep, sep[torch.clamp(w - at, 0, k_sep - 1)], out)
                at = at + k_sep
        return out

    m = gram_row.shape[0]
    data = so.build_bytes(offsets, make) if m else torch.zeros(0, dtype=torch.uint8,
                                                                device=col.device)
    child = Column(dt.STRING, m, data, offsets=offsets)
    return make_list_column(offsets_of(torch.where(_row_valid(col), grams, 0)), child,
                            _list_validity(col))


_FNV_PRIME = 1099511628211
_SIGN = torch.iinfo(torch.int64).min


def minhash(col: Column, seeds, width: int = 4) -> Column:
    """LIST<UINT64> [rows][seeds]: each row's minimum over its shingles of
    ``width`` bytes of a seeded remix of their polynomial hash (minhash.cu),
    all ones for a row without a shingle; a chunk of rows at a time."""
    seeds = [int(s) for s in (seeds.tolist() if hasattr(seeds, "tolist") else seeds)]
    n, ns, dev = col.length, len(seeds), col.device
    total = so.total_bytes(col)
    if total == 0:
        return from_pylists([[0] * ns] * n, device=dev)
    out = torch.empty(n, ns, dtype=torch.int64, device=dev)
    for lo, hi, a, b in _row_ranges(col, 8):
        chars = col.data[a:b].long()
        m = b - a
        pos = torch.arange(m, device=dev)
        row = torch.searchsorted(col.offsets[lo + 1:hi + 1] - a, pos, right=True)
        valid = pos + width <= col.offsets[lo + 1:hi + 1][row] - a
        h = torch.zeros(m, dtype=torch.int64, device=dev)
        for j in range(width):
            h = h * _FNV_PRIME + chars[torch.clamp(pos + j, max=max(m - 1, 0))]
        for i, s in enumerate(seeds):
            hs = (h ^ _s64(s & ((1 << 64) - 1))) * _FNV_PRIME
            hs = hs ^ _shr(hs, 33)
            # the unsigned minimum as a signed one over the bits with the sign flipped
            key = torch.where(valid, hs ^ _SIGN, torch.iinfo(torch.int64).max)
            best = torch.full((hi - lo,), torch.iinfo(torch.int64).max, dtype=torch.int64,
                              device=dev)
            best.scatter_reduce_(0, row, key, "amin")
            out[lo:hi, i] = best ^ _SIGN
    child = Column(dt.UINT64, n * ns, out.reshape(-1).view(torch.uint64))
    offsets = torch.arange(0, (n + 1) * ns, ns, dtype=torch.int64, device=dev)
    return make_list_column(offsets, child, col.validity)


def _shingle_keys(col: Column, width: int, words: int):
    """(row, packed words..., byte length) of every shingle of ``width``
    characters of each valid row: its bytes as little-endian int64 words."""
    starts, ends, _ = _ngram_spans(col, width)
    row = torch.searchsorted(col.offsets[1:], starts, right=True)
    lens = ends - starts
    ops = [row]
    total = so.total_bytes(col)
    for w in range(words):
        word = torch.zeros_like(starts)
        for k in range(8):
            at = starts + 8 * w + k
            byte = col.data[torch.clamp(at, max=max(total - 1, 0))].long()
            word |= torch.where(8 * w + k < lens, byte, 0) << (8 * k)
        ops.append(word)
    return ops + [lens]


def _distinct_per_row(ops: List[torch.Tensor], rows: int) -> torch.Tensor:
    """int64 [rows]: distinct operand tuples whose first operand is the row."""
    if ops[0].numel() == 0:
        return torch.zeros(rows, dtype=torch.int64, device=ops[0].device)
    order = lex_sort_permutation(ops)
    new = torch.zeros(order.shape[0], dtype=torch.bool, device=order.device)
    new[0] = True
    for op in ops:
        s = op[order]
        new[1:] |= s[1:] != s[:-1]
    return tracing.synced("token_counts", order, torch.bincount, ops[0][order][new],
                          minlength=rows, syncs=2)


def jaccard_index(a: Column, b: Column, width: int = 4) -> Column:
    """FLOAT64: |A ∩ B| / |A ∪ B| of each row pair's sets of ``width``-
    character shingles (jaccard.cu), 0.0 when both are empty, null where
    either row is; a chunk of rows at a time."""
    from cudf_tpu_torch.ops import copying
    from cudf_tpu_torch.core import bitmask as bm

    n, dev = a.length, a.device
    longest = max(tracing.to_int(so.lengths(c).max(), "string_width") if c.length else 0
                  for c in (a, b))
    words = max(1, -(-min(4 * width, max(longest, 1)) // 8))
    out = torch.zeros(n, dtype=torch.float64, device=dev)
    step = max(1, CHUNK_BYTES // (8 * max(longest, 1)))
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        ka = _shingle_keys(copying.slice(a, lo, hi), width, words)
        kb = _shingle_keys(copying.slice(b, lo, hi), width, words)
        na = _distinct_per_row(ka, hi - lo)
        nb = _distinct_per_row(kb, hi - lo)
        union = _distinct_per_row([torch.cat([x, y]) for x, y in zip(ka, kb)], hi - lo)
        inter = na + nb - union
        out[lo:hi] = torch.where(union > 0, inter.double() / torch.clamp(union, min=1), 0.0)
    return Column(dt.FLOAT64, n, out, bm.and_masks(a.validity, b.validity))


def _host_rows(col: Column, fn, dtype, name: str) -> Column:
    """The host route: ``fn`` of each valid row's string, nulls kept."""
    count_host_route(f"text.{name}")
    return Column.from_pylist([None if v is None else fn(v) for v in col.host_strings()],
                              dtype, device=col.device)


def _levenshtein(x: str, y: str) -> int:
    if len(x) < len(y):
        x, y = y, x
    prev = list(range(len(y) + 1))
    for i, cx in enumerate(x, 1):
        cur = [i]
        for j, cy in enumerate(y, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (cx != cy)))
        prev = cur
    return prev[-1]


def edit_distance(a: Column, b: Column) -> Column:
    """INT64 Levenshtein distance of each row pair (edit_distance.cu): the
    host route."""
    count_host_route("text.edit_distance")
    out = [None if x is None or y is None else _levenshtein(x, y)
           for x, y in zip(a.host_strings(), b.host_strings())]
    return Column.from_pylist(out, dt.INT64, device=a.device)


def normalize_spaces(col: Column) -> Column:
    """Runs of whitespace as one space, none at either end (normalize.cu)."""
    total = so.total_bytes(col)
    if total == 0:
        return col
    if total > CHUNK_BYTES:
        return _chunked(col, normalize_spaces)
    b = col.data
    sp = _is_space(b)
    row = _byte_row(col)
    pos = torch.arange(total, device=col.device)
    at_start = pos == col.offsets[:-1][row]
    keep = ~sp
    keep[1:] |= ~sp[:-1] & ~at_start[1:]
    last = torch.full((col.length,), -1, dtype=torch.int64, device=col.device)
    last.scatter_reduce_(0, row, torch.where(sp, -1, pos), "amax")
    keep &= pos <= last[row]
    norm = torch.where(sp, tracing.synced("host_values", col.device, torch.tensor, 32,
                                              dtype=torch.uint8, device=col.device), b)
    return Column(dt.STRING, col.length, tracing.masked(norm, keep, "compaction"), col.validity,
                  so.new_offsets(so.row_sums(col, keep)))


def _measure(s: str) -> int:
    vowels = "aeiou"
    seq = ""
    for i, ch in enumerate(s.lower()):
        is_v = ch in vowels or (ch == "y" and i > 0 and s[i - 1].lower() not in vowels)
        seq += "V" if is_v else "C"
    return len(re.findall("VC", seq.replace("VV", "V").replace("CC", "C")))


def porter_stemmer_measure(col: Column) -> Column:
    """INT32 Porter measure (the VC sequences) of each row: the host route."""
    return _host_rows(col, _measure, dt.INT32, "porter_stemmer_measure")


def tokenize_with_vocabulary(col: Column, vocab: Column, delimiter: Optional[str] = None,
                             default_id: int = -1) -> Column:
    """LIST<INT32> of each row's token ids in ``vocab`` (its first row
    holding the token), ``default_id`` for a token it lacks
    (nvtext::tokenize_with_vocabulary): the tokens' spans, then a search of
    the sorted vocabulary."""
    from cudf_tpu_torch.ops import binaryop, copying, search
    from cudf_tpu_torch.ops import sort as sort_ops

    tokens, row = _tokens(col, delimiter)
    order = sort_ops.sorted_order([vocab], [True], "last")
    sorted_vocab = copying.gather(vocab, order, bounds_check=False)
    lo = search.lower_bound(sorted_vocab, tokens)
    nv = sorted_vocab.length
    safe = torch.clamp(lo, 0, max(nv - 1, 0))
    if nv:
        eq = binaryop.binary_operation(copying.gather(sorted_vocab, safe, bounds_check=False),
                                       tokens, "eq")
        found = (lo < nv) & eq.data & (eq.validity if eq.validity is not None else True)
        ids = torch.where(found, order[safe], default_id)
    else:
        ids = torch.full_like(row, default_id)
    counts = tracing.synced("token_counts", row, torch.bincount, row, minlength=col.length,
                            syncs=2) if row.numel() else \
        torch.zeros(col.length, dtype=torch.int64, device=col.device)
    return make_list_column(offsets_of(counts), Column(dt.INT32, ids.shape[0],
                                                       ids.to(torch.int32)),
                            _list_validity(col))


def wordpiece_tokenize(col: Column, vocab, max_tokens: int = 128,
                       unk_token: str = "[UNK]") -> Column:
    """LIST<INT32> BERT wordpiece ids: greedy longest match first with
    ``##`` continuations (nvtext::subword_tokenize semantics), the host
    route."""
    count_host_route("text.wordpiece_tokenize")
    if isinstance(vocab, Column):
        vocab = {w: i for i, w in enumerate(vocab.to_pylist())}
    unk = vocab.get(unk_token, -1)
    max_word = max((len(w) for w in vocab), default=1)

    def encode_word(w: str) -> List[int]:
        out, start = [], 0
        while start < len(w):
            end = min(len(w), start + max_word)
            cur = None
            while end > start:
                piece = w[start:end] if start == 0 else "##" + w[start:end]
                if piece in vocab:
                    cur = vocab[piece]
                    break
                end -= 1
            if cur is None:
                return [unk]
            out.append(cur)
            start = end
        return out

    rows = []
    for v in col.host_strings():
        if v is None:
            rows.append(None)
            continue
        ids: List[int] = []
        for w in v.split():
            ids.extend(encode_word(w))
            if len(ids) >= max_tokens:
                break
        rows.append(ids[:max_tokens])
    return from_pylists(rows, dtype=dt.INT32, device=col.device)


def byte_pair_encoding(col: Column, merge_pairs, separator: str = " ") -> Column:
    """Each whitespace token's BPE merges, the pieces joined by
    ``separator`` (nvtext::byte_pair_encoding): the host route."""
    if isinstance(merge_pairs, Column):
        pairs = [tuple(p.split(" ", 1)) for p in merge_pairs.to_pylist()]
    else:
        pairs = [tuple(p) for p in merge_pairs]
    rank = {p: i for i, p in enumerate(pairs)}

    def encode(word: str) -> List[str]:
        parts = list(word)
        while len(parts) > 1:
            best, bi = None, -1
            for i in range(len(parts) - 1):
                r = rank.get((parts[i], parts[i + 1]))
                if r is not None and (best is None or r < best):
                    best, bi = r, i
            if best is None:
                break
            parts[bi:bi + 2] = [parts[bi] + parts[bi + 1]]
        return parts

    return _host_rows(col, lambda v: separator.join(p for w in v.split() for p in encode(w)),
                      dt.STRING, "byte_pair_encoding")
