"""What every generator shares: seeds, db-benchmark's sampling helpers,
and "id<n>" keys formatted and parsed on the device.

A category column is held as plain tensors: int32 codes into a
dictionary of sorted, distinct STRING keys (uint8 chars, int64 offsets,
the port's DICTIONARY32 layout).  The reference reads the number each
key spells (``Dictionary.numbers``), parsed from the keys once the
window has closed, so that no table beside the keys takes device memory
in the window.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

# the longest "id" number any configuration formats (1.1e9 keys)
MAX_DIGITS = 10


@dataclass
class Dictionary:
    chars: torch.Tensor         # uint8
    offsets: torch.Tensor       # int64 [len + 1]
    _numbers: Optional[torch.Tensor] = None

    def numbers(self) -> torch.Tensor:
        """The number each key spells, int64, parsed once."""
        if self._numbers is None:
            self._numbers = parse_ids(self.chars, self.offsets)
        return self._numbers


@dataclass
class Data:
    """The generated inputs: {frame: {column: tensor}} in column order,
    the dictionary of each category column, and the configuration."""
    tables: Dict[str, Dict[str, torch.Tensor]]
    dicts: Dict[str, Dict[str, Dictionary]] = field(default_factory=dict)
    config: dict = field(default_factory=dict)

    def values(self, frame: str, col: str) -> torch.Tensor:
        """The integer behind each row of a column (a category's key
        number, or the column itself), int64."""
        t = self.tables[frame][col]
        d = self.dicts.get(frame, {}).get(col)
        return t.long() if d is None else d.numbers()[t.long()]

    def rows(self, frame: str) -> int:
        return next(iter(self.tables[frame].values())).shape[0]


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one stream of draws from ``seed``
    (any whole number: the pair is folded into 63 bits)."""
    mixed = (int(seed) * 0x9E3779B97F4A7C15 + stream * 0xBF58476D1CE4E5B9) % (1 << 63)
    return torch.Generator(device=device).manual_seed(mixed)


def rounded_uniform(n: int, g: torch.Generator, device) -> torch.Tensor:
    """R's ``round(runif(n, max=100), 6)``: float64."""
    return torch.round(torch.rand(n, generator=g, device=device, dtype=torch.float64) * 100,
                       decimals=6)


def sample_all(x: torch.Tensor, size: int, g: torch.Generator) -> torch.Tensor:
    """join-datagen.R's ``sample_all``: every element of x once, the rest
    drawn from x with replacement, all shuffled."""
    extra = x[torch.randint(0, x.numel(), (size - x.numel(),), generator=g, device=x.device)]
    y = torch.cat([x, extra])
    return y[torch.randperm(size, generator=g, device=x.device)]


def digits(v: torch.Tensor) -> torch.Tensor:
    """Decimal digits of each positive int64 value."""
    nd = torch.ones_like(v)
    t = v // 10
    for _ in range(MAX_DIGITS):
        nd += (t > 0).long()
        t = t // 10
    return nd


def id_dictionary(values: torch.Tensor, width: int = 0):
    """(the distinct positive values in key order, the dictionary of keys
    ``"id" + sprintf("%0<width>d", v)``), sorted as the strings sort: a
    digit string is ordered by its digits padded on the right, then by its
    length."""
    v = torch.unique(values.long())
    nd = digits(v).clamp(min=width)
    pad = torch.pow(torch.full_like(nd, 10), MAX_DIGITS - nd)
    v = v[torch.sort(v * pad * (MAX_DIGITS + 1) + nd).indices]
    nd = digits(v).clamp(min=width)
    length = 2 + nd
    most = int(nd.max()) if v.numel() else 0
    mat = torch.empty((v.numel(), 2 + most), dtype=torch.uint8, device=v.device)
    mat[:, 0], mat[:, 1] = ord("i"), ord("d")
    for j in range(most):
        e = (nd - 1 - j).clamp(min=0)
        mat[:, 2 + j] = ((v // torch.pow(torch.full_like(e, 10), e)) % 10 + 48).to(torch.uint8)
    keep = torch.arange(2 + most, device=v.device)[None, :] < length[:, None]
    offsets = torch.zeros(v.numel() + 1, dtype=torch.int64, device=v.device)
    offsets[1:] = torch.cumsum(length, 0)
    return v, Dictionary(mat[keep], offsets)


def category(values: torch.Tensor, width: int = 0):
    """(int32 codes, dictionary) of a category column over ``values``."""
    keys, d = id_dictionary(values, width)
    table = torch.empty(int(keys.max()) + 1, dtype=torch.int32, device=values.device)
    table[keys] = torch.arange(keys.numel(), dtype=torch.int32, device=values.device)
    return table[values.long()], d


def parse_ids(chars: torch.Tensor, offsets: torch.Tensor, chunk: int = 1 << 24) -> torch.Tensor:
    """The number each "id<digits>" key spells, int64; -1 for a key of
    another form.  Works in chunks of keys so that it fits beside a run."""
    n = offsets.numel() - 1
    out = torch.empty(n, dtype=torch.int64, device=chars.device)
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        start, length = offsets[lo:hi], offsets[lo + 1:hi + 1] - offsets[lo:hi]
        nd = length - 2
        ok = (nd >= 1) & (nd <= 18)                     # 18 digits fit int64
        width = int(nd.max().clamp(1, 18)) if hi > lo else 1
        pos = torch.arange(width, device=chars.device)[None, :]
        inside = pos < nd[:, None]
        at = (start[:, None] + 2 + pos).clamp(max=max(chars.numel() - 1, 0))
        c = chars[at].long() if chars.numel() else torch.zeros_like(at)
        ok &= ~(inside & ((c < 48) | (c > 57))).any(1)
        head = start.clamp(max=max(chars.numel() - 2, 0))
        if chars.numel() >= 2:
            ok &= (chars[head] == ord("i")) & (chars[head + 1] == ord("d"))
        value = torch.zeros(hi - lo, dtype=torch.int64, device=chars.device)
        for j in range(width):
            value = torch.where(inside[:, j], value * 10 + (c[:, j] - 48), value)
        out[lo:hi] = torch.where(ok, value, -1)
    return out
