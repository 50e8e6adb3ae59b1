"""What a traced window leaves for the per-layer readers: the queries'
ranges (one ``record_function`` range a query, opened by the harness
around the question, from outside the port), the device operations
``torch.profiler`` recorded (kernels, copies, fills), and the host syncs of one pass of the mix.  Times are the profiler's, in
microseconds.
"""

from __future__ import annotations

from bisect import bisect_left
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

QUERY_PREFIX = "portbench.query."

Interval = Tuple[float, float]


@dataclass
class Query:
    question: str
    start: float
    end: float
    least_bytes: int


@dataclass
class Trace:
    queries: List[Query] = field(default_factory=list)
    device_ops: List[Tuple[str, float, float]] = field(default_factory=list)
    syncs: Dict[str, int] = field(default_factory=dict)     # one pass: question -> syncs

    def window(self) -> List[Interval]:
        """From the first query's start to the last one's end."""
        return [(self.queries[0].start, self.queries[-1].end)] if self.queries else []

    def busy(self) -> List[Interval]:
        """The union of the device operations' intervals inside the window."""
        return intersect(union([(s, e) for _, s, e in self.device_ops]), self.window())

    def device_seconds(self) -> List[float]:
        """Each query's device time: of the operations that started inside
        its range."""
        ops = sorted((s, e - s) for _, s, e in self.device_ops)
        starts = [s for s, _ in ops]
        total = [0.0]
        for _, d in ops:
            total.append(total[-1] + d)
        return [(total[bisect_left(starts, q.end)] - total[bisect_left(starts, q.start)]) / 1e6
                for q in self.queries]


def union(intervals: List[Interval]) -> List[Interval]:
    out: List[Interval] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def intersect(a: List[Interval], b: List[Interval]) -> List[Interval]:
    """Of two sorted, disjoint interval lists."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < e:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(a: List[Interval], b: List[Interval]) -> List[Interval]:
    """a without b (a sorted and disjoint), in one sweep."""
    out, b, j = [], union(b), 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > s:
                out.append((s, b[k][0]))
            s = max(s, b[k][1])
            k += 1
        if s < e:
            out.append((s, e))
    return out


def length(intervals: List[Interval]) -> float:
    return sum(e - s for s, e in intervals)


def from_profile(prof) -> Trace:
    """The queries' ranges and the device operations of a
    finished ``torch.profiler.profile``."""
    t = Trace()
    for ev in prof.events():
        name = ev.name
        on_device = "CUDA" in str(ev.device_type)
        start, end = ev.time_range.start, ev.time_range.end
        if name.startswith("portbench."):
            if on_device:                    # the range's mirror on the device's timeline
                continue
            if name.startswith(QUERY_PREFIX):
                t.queries.append(Query(name[len(QUERY_PREFIX):], start, end, 0))
        elif on_device and end > start:
            t.device_ops.append((name, start, end))
    t.queries.sort(key=lambda q: q.start)
    return t


def breakdown(t: Trace, top: int = 10) -> dict:
    """The device operations that took most time, by name, and the longest
    idle gaps, each named by the question whose range it fell in."""
    by_name: Dict[str, float] = {}
    for name, s, e in t.device_ops:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(subtract(t.window(), t.busy()), key=lambda g: g[0] - g[1])[:top]
    named = []
    for s, e in gaps:
        mid = (s + e) / 2
        q = next((q.question for q in t.queries if q.start <= mid < q.end), "between queries")
        named.append([q, (e - s) / 1e6])
    return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": named}
