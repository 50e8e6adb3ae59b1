"""The port's own spans (``cudf_tpu_torch.utils.tracing``) on a traced
window's timeline, for the readers of the frame, ops, sync and kernel
metrics.

The recorder keeps the spans of the last profiler session, on the
host's ``perf_counter_ns`` read as Unix ns; ``trace.from_profile`` keeps
the profiler's times in microseconds from the trace's start, which it
does not keep.
The constant between the two is recovered from the queries' ranges: the
harness opens a query's range just before it calls the question, and
the question's first root span opens microseconds later.  So one of the
first root spans is placed at the start of one of the first queries
(of those pairs, the one that puts most root spans inside the ranges:
the profiler's clock can jump in its first query), the root spans are
grouped by the ranges that then hold them, and each query but the
first (whose range may open before that jump) gives the gap between its
first root span's start and its range's start.  The gaps' medians over
the first and the second half of the window place every span: a straight
line through the two is what reconciles the host's clock with the
profiler's, whose converted times drift against it by a few parts in a
million on the card (a few parts in a hundred on some virtual CPUs).
Where a root span then lies outside every range by more than ``SLACK_US``, or
the program records no spans (a program without the recorder), there is
nothing to read: ``place`` gives None, never a guess.
"""

from __future__ import annotations

import statistics
from bisect import bisect_right
from dataclasses import dataclass
from typing import Dict, List, Optional

from portbench.trace import Interval, Trace, length, subtract, union

SLACK_US = 50.0
CANDIDATES = 8
NAMESPACE = "cudf_tpu_torch::"


@dataclass
class Placed:
    """A span on the trace's clock (microseconds)."""
    id: int
    parent: Optional[int]
    root: int
    name: str
    kind: str
    start: float
    end: float
    reason: Optional[str]
    syncs: int
    nbytes: int


@dataclass
class Placement:
    spans: List[Placed]
    query_of_root: Dict[int, int]      # root span id -> index of its query
    offsets_us: List[float]            # each query's first root span less its range start
    spread_us: float                   # their quartile spread about the fitted line


def recorded() -> list:
    """The recorder's closed spans, or [] where the program has none."""
    try:
        from cudf_tpu_torch.utils import tracing
        spans = tracing.tracer.spans()
    except (ImportError, AttributeError):
        return []
    return [s for s in spans if s.end]


def place(trace: Trace, spans: Optional[list] = None) -> Optional[Placement]:
    """The window's spans on the trace's clock, or None (see above).
    Cached on the trace."""
    if spans is None and "port_spans" in trace.__dict__:
        return trace.__dict__["port_spans"]
    out = _place(trace, recorded() if spans is None else spans)
    if spans is None:
        trace.__dict__["port_spans"] = out
    return out


def _place(trace: Trace, spans: list) -> Optional[Placement]:
    queries = trace.queries
    roots = sorted((s for s in spans if s.parent is None), key=lambda s: s.start)
    if not queries or not roots:
        return None
    base = roots[-1].end                 # integer ns: microseconds from here keep their digits

    def us(ns: int) -> float:
        return (ns - base) / 1e3

    starts = [q.start for q in queries]

    def inside(offset: float) -> int:
        n = 0
        for r in roots:
            i = bisect_right(starts, us(r.start) - offset + SLACK_US) - 1
            n += i >= 0 and us(r.end) - offset <= queries[i].end + SLACK_US
        return n

    # the first root span of one of the first queries opens just after its
    # range: of those placements, the one that puts most root spans inside
    # the ranges
    offset = max((us(r.start) - q.start for r in roots[:CANDIDATES]
                  for q in queries[:CANDIDATES]), key=inside)
    firsts: Dict[int, float] = {}
    for r in roots:
        i = bisect_right(starts, us(r.start) - offset + SLACK_US) - 1
        if i >= 0 and i not in firsts:
            firsts[i] = us(r.start) - queries[i].start
    xs = sorted(firsts)[1:] if len(firsts) > 2 else sorted(firsts)
    half = len(xs) // 2
    early, late = xs[:max(half, 1)], xs[half:]
    x0 = statistics.median(queries[i].start for i in early)
    x1 = statistics.median(queries[i].start for i in late)
    o0 = statistics.median(firsts[i] for i in early)
    o1 = statistics.median(firsts[i] for i in late)
    slope = (o1 - o0) / (x1 - x0) if x1 > x0 else 0.0

    def at(ns: int) -> float:
        t = us(ns) - o0
        return t - slope * (t - x0)

    residuals = [firsts[i] - o0 - slope * (queries[i].start - x0) for i in xs]
    q1, _, q3 = (statistics.quantiles(residuals, n=4) if len(residuals) > 1
                 else (0.0, 0.0, 0.0))
    placed = [Placed(s.id, s.parent, s.root, s.name, s.kind, at(s.start), at(s.end),
                     s.reason, s.syncs, s.nbytes) for s in spans]
    query_of_root: Dict[int, int] = {}
    for p in placed:
        if p.parent is not None:
            continue
        i = bisect_right(starts, p.start + SLACK_US) - 1
        if i < 0 or p.start < queries[i].start - SLACK_US or p.end > queries[i].end + SLACK_US:
            return None
        query_of_root[p.id] = i
    return Placement(placed, query_of_root, [firsts[i] for i in xs], q3 - q1)


def self_intervals(spans: List[Placed]) -> Dict[int, List[Interval]]:
    """{span id: intervals}: the parts of each span's interval that none
    of its children covers."""
    children: Dict[int, List[Interval]] = {}
    for s in spans:
        if s.parent is not None:
            children.setdefault(s.parent, []).append((s.start, s.end))
    return {s.id: subtract([(s.start, s.end)], children.get(s.id, [])) for s in spans}


def self_us(spans: List[Placed]) -> Dict[int, float]:
    """{span id: microseconds}: each span's duration less the union of
    its children's intervals inside it."""
    return {i: length(ivs) for i, ivs in self_intervals(spans).items()}


def host_ms_per_query(trace: Trace, kind: str) -> Optional[float]:
    """Σ the self time of the ``kind`` spans over the window's queries, in
    ms a query."""
    p = place(trace)
    if p is None:
        return None
    own = self_us(p.spans)
    return sum(own[s.id] for s in p.spans if s.kind == kind) / 1e3 / len(trace.queries)


def root_intervals(p: Placement) -> List[Interval]:
    """The union of the root spans' intervals: the host inside the port."""
    return union([(s.start, s.end) for s in p.spans if s.parent is None])


def kernel_ops(trace: Trace) -> List[tuple]:
    """The device operations the library's entry points enqueue: each
    named in its namespace, and a memset that runs just before one of them
    (an entry's own ``cudaMemsetAsync``; the entries issue no copy)."""
    ops = sorted(trace.device_ops, key=lambda o: o[1])
    out = []
    for i, op in enumerate(ops):
        if NAMESPACE in op[0]:
            out.append(op)
        elif op[0].startswith("Memset") and i + 1 < len(ops) \
                and NAMESPACE in ops[i + 1][0]:
            out.append(op)
    return out
