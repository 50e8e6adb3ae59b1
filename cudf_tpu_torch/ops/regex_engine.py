"""The device regex: a DFA compiled on the host, run over the bytes on
the device (port of ``cudf_tpu/ops/regex_engine.py``).

1. Host: the standard library's ``re`` parser gives the pattern's parse
   tree; a Thompson NFA over bytes is built from it, then a DFA by
   subset construction, with the 256 byte values folded into classes
   that no edge tells apart.
2. Device: ``run_predicate`` steps every row at once, one byte position a
   step: the byte's class (a gather), the next state (a gather of the
   (state, class) table) and a mask for the rows already past their end.
   ``match_spans`` runs the anchored DFA from every byte of the column at
   once and keeps the longest match from each (leftmost-longest spans,
   ``ops/string_spans.py`` selects among them).

``.``, a negated class and a non-ASCII literal consume one whole UTF-8
sequence: their lead byte moves to continuation states (the reference
matched ``.`` and ``[^...]`` to one byte, so ``fullmatch(".{5}")`` of
"ñandú" was False).  Covered: literals, ``.``, classes (ASCII ranges,
negation, ``\\d \\w \\s`` and their negations), alternation, groups,
greedy ``* + ?`` and bounded ``{m,n}`` (unrolled), ``^`` and ``$`` at the
pattern's ends, IGNORECASE and DOTALL.  ``Unsupported`` (backreferences,
lookaround, lazy repeats in span mode, non-ASCII class members, ...)
sends the caller to the host route.  ``\\d``, ``\\w``, ``\\s`` and
IGNORECASE are Unicode-aware in Python, so a pattern with them runs on
the device only over ASCII rows (``Dfa.unicode``: the caller checks).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, FrozenSet, List, Set, Tuple

import numpy as np
import torch

import re._constants as sre_c
import re._parser as sre_parse

from cudf_tpu_torch.utils import tracing


class Unsupported(Exception):
    """A construct the device engine does not cover."""


_ALL = frozenset(range(256))
_ASCII = frozenset(range(128))
_NL = frozenset({10})
_DIGIT = frozenset(range(48, 58))
_WORD = _DIGIT | frozenset(range(65, 91)) | frozenset(range(97, 123)) | {95}
_SPACE = frozenset({9, 10, 11, 12, 13, 32, 28, 29, 30, 31})
_CONT = frozenset(range(0x80, 0xC0))
# lead bytes of 2-, 3- and 4-byte sequences
_LEADS = ((frozenset(range(0xC0, 0xE0)), 1), (frozenset(range(0xE0, 0xF0)), 2),
          (frozenset(range(0xF0, 0xF8)), 3))
_CATEGORY = {
    sre_c.CATEGORY_DIGIT: (_DIGIT, False), sre_c.CATEGORY_NOT_DIGIT: (_ASCII - _DIGIT, True),
    sre_c.CATEGORY_WORD: (_WORD, False), sre_c.CATEGORY_NOT_WORD: (_ASCII - _WORD, True),
    sre_c.CATEGORY_SPACE: (_SPACE, False), sre_c.CATEGORY_NOT_SPACE: (_ASCII - _SPACE, True),
}
MAX_UNROLL = 16
MAX_DFA_STATES = 2048


class _NFA:
    def __init__(self):
        self.eps: List[Set[int]] = []
        self.edges: List[List[Tuple[FrozenSet[int], int]]] = []

    def state(self) -> int:
        self.eps.append(set())
        self.edges.append([])
        return len(self.eps) - 1

    def chain(self, cur: int, sets) -> int:
        """States consuming one byte of each set in turn."""
        for bs in sets:
            nxt = self.state()
            self.edges[cur].append((frozenset(bs), nxt))
            cur = nxt
        return cur

    def char(self, cur: int, ascii_set: FrozenSet[int], multibyte: bool) -> int:
        """One character: a byte of ``ascii_set``, or (``multibyte``) any
        whole 2- to 4-byte UTF-8 sequence."""
        out = self.state()
        if ascii_set:
            self.edges[cur].append((frozenset(ascii_set), out))
        if multibyte:
            for lead, conts in _LEADS:
                mid = self.chain(cur, [lead] + [_CONT] * (conts - 1))
                self.edges[mid].append((_CONT, out))
        return out


def _swapcase(bs) -> FrozenSet[int]:
    out = set(bs)
    for b in bs:
        if 65 <= b <= 90:
            out.add(b + 32)
        elif 97 <= b <= 122:
            out.add(b - 32)
    return frozenset(out)


class _Compiler:
    def __init__(self, flags: int, strict_spans: bool):
        self.ignorecase = bool(flags & re.IGNORECASE)
        self.dotall = bool(flags & re.DOTALL)
        self.strict_spans = strict_spans
        self.ascii = bool(flags & re.ASCII)       # \\d, \\w, \\s and case folds stay ASCII
        self.unicode = self.ignorecase and not self.ascii
        self.anchor_start = self.anchor_end = False
        self.nfa = _NFA()

    def _class(self, items) -> Tuple[FrozenSet[int], bool]:
        """(ASCII bytes, whether any non-ASCII character) of ``[...]``."""
        negate, bs, non_ascii = False, set(), False
        for op, av in items:
            if op is sre_c.NEGATE:
                negate = True
            elif op is sre_c.LITERAL:
                if av > 127:
                    raise Unsupported("non-ASCII class member")
                bs.add(av)
            elif op is sre_c.RANGE:
                if av[1] > 127:
                    raise Unsupported("non-ASCII class range")
                bs.update(range(av[0], av[1] + 1))
            elif op is sre_c.CATEGORY and av in _CATEGORY:
                cat, wide = _CATEGORY[av]
                bs.update(cat)
                non_ascii |= wide
                self.unicode = not self.ascii
            else:
                raise Unsupported(f"class item {op}")
        bs = _swapcase(bs) if self.ignorecase else frozenset(bs)
        if negate:
            return _ASCII - bs, not non_ascii
        return frozenset(bs), non_ascii

    def tokens(self, toks, cur: int, top: bool) -> int:
        nfa = self.nfa
        for i, (op, av) in enumerate(toks):
            if op is sre_c.LITERAL:
                if av > 127:
                    if self.ignorecase:
                        raise Unsupported("non-ASCII literal under IGNORECASE")
                    cur = nfa.chain(cur, [{b} for b in chr(av).encode("utf-8")])
                else:
                    cur = nfa.char(cur, _swapcase({av}) if self.ignorecase else {av}, False)
            elif op is sre_c.NOT_LITERAL:
                if av > 127:
                    raise Unsupported("non-ASCII literal")
                bs = _swapcase({av}) if self.ignorecase else frozenset({av})
                cur = nfa.char(cur, _ASCII - bs, True)
            elif op is sre_c.ANY:
                cur = nfa.char(cur, _ASCII if self.dotall else _ASCII - _NL, True)
            elif op is sre_c.IN:
                cur = nfa.char(cur, *self._class(av))
            elif op is sre_c.SUBPATTERN:
                if av[1] or av[2]:
                    raise Unsupported("inline flags")
                cur = self.tokens(av[3], cur, False)
            elif op is sre_c.BRANCH:
                join = nfa.state()
                for br in av[1]:
                    b = nfa.state()
                    nfa.eps[cur].add(b)
                    nfa.eps[self.tokens(br, b, False)].add(join)
                cur = join
            elif op in (sre_c.MAX_REPEAT, sre_c.MIN_REPEAT):
                if op is sre_c.MIN_REPEAT and self.strict_spans:
                    raise Unsupported("lazy repeat in span mode")
                lo, hi, sub = av
                if lo > MAX_UNROLL:
                    raise Unsupported(f"repeat lower bound > {MAX_UNROLL}")
                for _ in range(lo):
                    cur = self.tokens(sub, cur, False)
                out = nfa.state()
                if hi == sre_c.MAXREPEAT:
                    loop = nfa.state()
                    nfa.eps[cur].add(loop)
                    back = self.tokens(sub, loop, False)
                    nfa.eps[back].add(loop)
                    nfa.eps[loop].add(out)
                else:
                    if hi - lo > MAX_UNROLL:
                        raise Unsupported(f"repeat span > {MAX_UNROLL}")
                    nfa.eps[cur].add(out)
                    for _ in range(hi - lo):
                        cur = self.tokens(sub, cur, False)
                        nfa.eps[cur].add(out)
                cur = out
            elif op is sre_c.AT and av is sre_c.AT_BEGINNING and top and i == 0:
                self.anchor_start = True
            elif op is sre_c.AT and av is sre_c.AT_END and top and i == len(toks) - 1:
                self.anchor_end = True
            else:
                raise Unsupported(f"construct {op} {av}")
        return cur


def _closure(nfa: _NFA, states) -> FrozenSet[int]:
    seen, stack = set(states), list(states)
    while stack:
        for t in nfa.eps[stack.pop()]:
            if t not in seen:
                seen.add(t)
                stack.append(t)
    return frozenset(seen)


@dataclass(frozen=True, eq=False)          # hashed by identity: compile_dfa caches
class Dfa:
    """``table[state * classes + class]`` is the next state, ``accept``
    the accepting states, ``class_map`` the class of each byte; state 0
    starts.  ``unicode``: the pattern's meaning differs on non-ASCII
    text (run it over ASCII rows only)."""
    table: np.ndarray
    accept: np.ndarray
    class_map: np.ndarray
    classes: int
    anchor_start: bool
    anchor_end: bool
    unicode: bool

    def tensors(self, device):
        return _dfa_tensors(self, str(torch.device(device)))


@lru_cache(maxsize=64)
def _dfa_tensors(d: Dfa, device: str):
    return tuple(tracing.synced("host_values", device, torch.from_numpy(a).to, device)
                 for a in (d.table.astype(np.int32), d.accept, d.class_map.astype(np.int32)))


@lru_cache(maxsize=256)
def compile_dfa(pattern: str, flags: int = 0, search: bool = True,
                strict_spans: bool = False) -> Dfa:
    """The pattern's DFA; ``search`` adds the implicit ``.*`` prefix
    (unless the pattern starts with ``^``)."""
    try:
        parsed = sre_parse.parse(pattern, flags)
    except re.error as err:
        raise Unsupported(str(err)) from None
    flags = parsed.state.flags               # with the pattern's own (?i) / (?s) / (?a)
    if flags & ~(re.IGNORECASE | re.DOTALL | re.UNICODE | re.VERBOSE | re.ASCII):
        raise Unsupported(f"flags {flags}")
    toks = list(parsed)
    c = _Compiler(flags, strict_spans)
    start = c.nfa.state()
    end = c.tokens(toks, start, True)
    nfa = c.nfa
    if search and not c.anchor_start:
        nfa.edges[start].append((_ALL, start))
    sets = sorted({bs for es in nfa.edges for bs, _ in es}, key=sorted)
    member = np.zeros((256, len(sets) + 1), bool)      # a byte's sets: its class
    for k, bs in enumerate(sets):
        member[list(bs), k] = True
    _, class_map = np.unique(member, axis=0, return_inverse=True)
    class_map = class_map.reshape(-1)
    classes = int(class_map.max()) + 1
    rep = np.zeros(classes, np.int64)
    rep[class_map[::-1]] = np.arange(255, -1, -1)
    first = _closure(nfa, {start})
    index: Dict[FrozenSet[int], int] = {first: 0}
    order, rows = [first], []
    while len(rows) < len(order):
        cur = order[len(rows)]
        row = []
        for k in range(classes):
            b = int(rep[k])
            nxt = {t for s in cur for bs, t in nfa.edges[s] if b in bs}
            key = _closure(nfa, nxt) if nxt else frozenset()
            if key not in index:
                if len(index) >= MAX_DFA_STATES:
                    raise Unsupported("DFA too large")
                index[key] = len(order)
                order.append(key)
            row.append(index[key])
        rows.append(row)
    return Dfa(np.asarray(rows, np.int32).reshape(-1), np.array([end in s for s in order]),
               class_map.astype(np.int32), classes, c.anchor_start, c.anchor_end, c.unicode)


def _row_bytes(col, j: int, starts, total: int) -> torch.Tensor:
    return col.data[torch.clamp(starts + j, max=max(total - 1, 0))].to(torch.int32)


def run_predicate(col, pattern: str, flags: int = 0, mode: str = "search") -> torch.Tensor:
    """bool[n]: whether each row satisfies the pattern under ``mode``
    (search, match or fullmatch): one DFA step a byte position, every row
    at once; one host sync for the longest row."""
    d = compile_dfa(pattern, flags, search=mode == "search")
    table, accept, class_map = d.tensors(col.device)
    final_only = d.anchor_end or mode == "fullmatch"
    starts = col.offsets[:-1]
    lens = col.offsets[1:] - starts
    total = int(col.data.shape[0])
    steps = tracing.to_int(lens.max(), "string_width") if col.length and total else 0
    state = torch.zeros(col.length, dtype=torch.int32, device=col.device)
    hit = torch.full((col.length,), bool(d.accept[0]) and not final_only, device=col.device)
    for j in range(steps):
        cls = class_map[_row_bytes(col, j, starts, total)]
        state = torch.where(j < lens, table[state * d.classes + cls], state)
        if not final_only:
            hit |= accept[state]
    return hit | accept[state]


def match_spans(col, pattern: str, flags: int = 0, chunk: int = 1 << 27) -> torch.Tensor:
    """int16[total]: the longest match of the anchored pattern starting at
    each byte (0: none), within the byte's row.  The DFA runs from every
    byte at once, one step a byte of lookahead, ``chunk`` start bytes at
    a time; one host sync for the longest row."""
    d = compile_dfa(pattern, flags, search=False, strict_spans=True)
    if d.accept[0]:
        raise Unsupported("the pattern matches the empty string")
    table, accept, class_map = d.tensors(col.device)
    total = int(col.data.shape[0])
    longest = int((col.offsets[1:] - col.offsets[:-1]).max()) if col.length and total else 0
    if longest > 32767:
        raise Unsupported("a row longer than 32767 bytes")
    out = torch.zeros(total, dtype=torch.int16, device=col.device)
    # each byte's class, padded so that every start's lookahead is a slice
    cls = torch.zeros(total + longest, dtype=torch.int32, device=col.device)
    cls[:total] = class_map[col.data.to(torch.int32)]
    ends = col.offsets[1:].contiguous()
    for a in range(0, total, chunk):
        b = min(a + chunk, total)
        pos = torch.arange(a, b, device=col.device)
        row = torch.searchsorted(ends, pos, right=True)
        room = (ends[row] - pos).to(torch.int16)        # bytes left in the row
        if d.anchor_start:
            room = torch.where(pos == col.offsets[:-1][row], room, 0)
        del row, pos
        state = torch.zeros(b - a, dtype=torch.int32, device=col.device)
        best = out[a:b]
        for j in range(longest):
            live = room > j
            nxt = table[state * d.classes + cls[a + j:b + j]]
            state = torch.where(live, nxt, state)
            ok = live & accept[state]
            if d.anchor_end:
                ok &= room == j + 1
            best.masked_fill_(ok, j + 1)
    return out
