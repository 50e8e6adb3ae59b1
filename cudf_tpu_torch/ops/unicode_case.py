"""Unicode case maps and character classes on the device (port of
``cudf_tpu/ops/unicode_case.py``).

Tables over the Basic Multilingual Plane are built once on the host from
CPython's own ``str`` methods (so they agree with pandas) and cached per
device.  ``decode_utf8`` turns the bytes into code points, a table
gather maps them, and ``encode_utf8`` writes them back.  A code point
outside the BMP, or one whose mapping is not one BMP code point (ß ->
SS), makes the op return None: the caller takes the host route.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np
import torch

from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.utils import tracing

_BMP = 1 << 16
_CLASSES = ("isdigit", "isdecimal", "isnumeric", "isalpha", "isalnum", "isspace", "isupper",
            "islower")


@lru_cache(maxsize=None)
def _host_table(kind: str) -> np.ndarray:
    """int32[65536] case map (-1 where the mapping is not one BMP code
    point), or bool[65536] for a class, ``cased`` included."""
    chars = [chr(cp) for cp in range(_BMP)]
    if kind in _CLASSES:
        return np.array([getattr(c, kind)() for c in chars], bool)
    if kind == "cased":       # CPython's title(): a word goes on after a cased char
        return np.array([c.islower() or c.isupper() or c.istitle() for c in chars], bool)
    tab = np.arange(_BMP, dtype=np.int32)
    for cp, c in enumerate(chars):
        m = getattr(c, kind)()
        if m != c:
            tab[cp] = ord(m) if len(m) == 1 and ord(m) < _BMP else -1
    return tab


@lru_cache(maxsize=None)
def _table(kind: str, device: str) -> torch.Tensor:
    return torch.from_numpy(_host_table(kind)).to(device)


def table(kind: str, device) -> torch.Tensor:
    return _table(kind, str(torch.device(device)))


def decode_utf8(col: Column):
    """(code points int32[c], row int64[c], index in the row int64[c]) of
    every character, c the column's character count."""
    buf = col.data.to(torch.int32)
    total = buf.shape[0]
    lead = (buf & 0xC0) != 0x80
    starts = tracing.synced("compaction", lead, torch.nonzero, lead).squeeze(1)
    b0 = buf[starts]
    nxt = [buf[torch.clamp(starts + i, max=total - 1)] & 0x3F for i in (1, 2, 3)]
    cp = torch.where(b0 < 0x80, b0, torch.where(
        b0 < 0xE0, ((b0 & 0x1F) << 6) | nxt[0], torch.where(
            b0 < 0xF0, ((b0 & 0x0F) << 12) | (nxt[0] << 6) | nxt[1],
            ((b0 & 0x07) << 18) | (nxt[0] << 12) | (nxt[1] << 6) | nxt[2])))
    row = torch.searchsorted(col.offsets[1:], starts, right=True)
    first = torch.searchsorted(starts, col.offsets[:-1])        # each row's first char
    return cp, row, torch.arange(starts.shape[0], device=buf.device) - first[row]


def encode_utf8(cp: torch.Tensor, row: torch.Tensor, n_rows: int, validity) -> Column:
    """A STRING column of every row's code points (``row`` ascending)."""
    ln = torch.where(cp < 0x80, 1, torch.where(cp < 0x800, 2, torch.where(cp < _BMP, 3, 4)))
    lens = torch.zeros(n_rows, dtype=torch.int64, device=cp.device).index_add_(0, row, ln.long())
    offsets = torch.zeros(n_rows + 1, dtype=torch.int64, device=cp.device)
    torch.cumsum(lens, 0, out=offsets[1:])
    total = tracing.to_int(offsets[-1], "string_bytes")
    char = torch.repeat_interleave(torch.arange(cp.shape[0], device=cp.device), ln,
                                   output_size=total)
    first = torch.cumsum(ln, 0) - ln
    within = torch.arange(total, device=cp.device) - first[char]
    c, k = cp[char], ln[char]
    # byte j of a k-byte sequence: lead bits, then 6 bits a byte from the top
    shift = 6 * (k - 1 - within)
    lead = torch.where(k == 2, 0xC0, torch.where(k == 3, 0xE0, 0xF0))
    out = torch.where(k == 1, c, torch.where(within == 0, lead | (c >> shift),
                                             0x80 | ((c >> shift) & 0x3F)))
    return Column(dt.STRING, n_rows, out.to(torch.uint8), validity, offsets)


def case_map(col: Column, kind: str) -> Optional[Column]:
    """lower / upper / swapcase / capitalize / title; None when a code
    point is outside the BMP or maps to more than one."""
    cp, row, idx = decode_utf8(col)
    if tracing.to_bool((cp >= _BMP).any(), "bmp_check"):
        return None
    dev = col.device
    if kind in ("upper", "lower", "swapcase"):
        mapped = table(kind, dev)[cp]
    else:
        up, lo = table("title", dev)[cp], table("lower", dev)[cp]
        if kind == "capitalize":
            mapped = torch.where(idx == 0, up, lo)
        else:                                  # title: after a cased char, lower
            cased = table("cased", dev)[cp]
            prev = torch.zeros_like(cased)
            prev[1:] = cased[:-1]
            mapped = torch.where(prev & (idx > 0), lo, up)
    if tracing.to_bool((mapped < 0).any(), "bmp_check"):
        return None
    return encode_utf8(mapped, row, col.length, col.validity)


def char_class_all(col: Column, kind: str) -> Optional[Column]:
    """Python's ``str.isX`` of every row: every character in the class and
    the row not empty; ``isupper``/``islower`` by the cased-character rule.
    None when a code point is outside the BMP."""
    cp, row, _ = decode_utf8(col)
    if tracing.to_bool((cp >= _BMP).any(), "bmp_check"):
        return None
    n, dev = col.length, col.device

    def any_of(hits):
        return torch.zeros(n, dtype=torch.int64, device=dev).index_add_(0, row, hits.long()) > 0

    nonempty = (col.offsets[1:] - col.offsets[:-1]) > 0
    if kind in ("isupper", "islower"):
        this = table(kind, dev)[cp]           # a cased character of the other case fails
        out = any_of(this) & ~any_of(table("cased", dev)[cp] & ~this)
    else:
        misses = (~table(kind, dev)[cp]).long()
        out = torch.zeros(n, dtype=torch.int64, device=dev).index_add_(0, row, misses) == 0
    return Column(dt.BOOL8, n, out & nonempty, col.validity)
