"""The port's spans and counters (port of ``cudf_tpu/utils/tracing.py``;
the reference's NVTX ranges, CUDF_FUNC_RANGE).

A span is recorded only while a ``torch.profiler`` session records
(``torch.autograd.profiler._is_profiler_enabled``) or inside
``enable_tracing()``.  Otherwise a span is one check of those two flags
and a plain call: no context manager, no ``record_function``, no NVTX,
nothing kept, and never a device sync, on or off.

Each span holds its name, its layer (``kind``: "frame", "ops",
"kernel", "sync" or "range"), its start and end on the profiler's clock,
its parent span's id and the id of its root span, which all the spans of
one request share; a sync span holds its reason and the host's waits in
it, a kernel span the bytes
its launch must move at least (each operand read once, each output
written once).  Spans are made at layer boundaries only:

- ``annotate(name, kind)``: a public method of the frame layer
  ("frame") or an entry point of ``ops/`` ("ops");
- ``kernels/_build.launch``: one "kernel" span a C entry point's call;
- ``synced(reason, where, op, *args)`` and ``tolist``/``item``/
  ``to_int``/``to_bool``/``masked``: every host sync of the port, a "sync" span
  where ``where`` (a tensor or a device) is on a CUDA device;
- ``Tracer.range(name)``: an operator's own "range".

The clock is the host's ``time.perf_counter_ns``, read as Unix
nanoseconds by the offset of ``time.time_ns``.  ``spans()`` gives the
spans recorded since ``clear()`` or since the start of the last
``torch.profiler`` session begun outside ``enable_tracing()``, which
empties them, in Unix ns.
``start_profiler_trace(logdir)`` / ``stop_profiler_trace()`` record a
``torch.profiler`` trace and write it to ``logdir/trace.json`` with the
spans as a track of their own.  NVTX ranges (for Nsight) are pushed only
inside ``enable_tracing()``, never merely because a profiler records.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import threading
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

_clock = time.perf_counter_ns

# at most this many spans are kept; later ones are counted in ``dropped``
MAX_SPANS = 1 << 22


@dataclass(slots=True)
class Span:
    id: int
    parent: Optional[int]
    root: int
    name: str
    kind: str
    start: int
    end: int = 0
    reason: Optional[str] = None
    syncs: int = 0
    nbytes: int = 0


class Tracer:
    """The recorder: the switch of ``enable_tracing()``, the spans kept,
    each thread's open spans."""

    def __init__(self):
        self.enabled = False
        self.dropped = 0
        self._spans: List[Span] = []
        self._ids = itertools.count(1)
        self._open = threading.local()

    def recording(self) -> bool:
        return self.enabled or _autograd_profiler._is_profiler_enabled

    def _begin(self, name: str, kind: str) -> Span:
        stack = getattr(self._open, "stack", None)
        if stack is None:
            stack = self._open.stack = []
        sid = next(self._ids)
        parent = stack[-1] if stack else None
        span = Span(sid, None if parent is None else parent.id,
                    sid if parent is None else parent.root, name, kind, _clock())
        stack.append(span)
        if len(self._spans) < MAX_SPANS:
            self._spans.append(span)
        else:
            self.dropped += 1
        if self.enabled and torch.cuda.is_initialized():
            torch.cuda.nvtx.range_push(name)
        return span

    def _end(self, span: Span) -> None:
        span.end = _clock()
        self._open.stack.pop()
        if self.enabled and torch.cuda.is_initialized():
            torch.cuda.nvtx.range_pop()

    @contextlib.contextmanager
    def range(self, name: str):
        """An operator's named span (kind "range") while recording."""
        if not self.recording():
            yield
            return
        span = self._begin(name, "range")
        try:
            yield
        finally:
            self._end(span)

    def spans(self) -> List[Span]:
        """Copies of the spans recorded since ``clear()``, their times in
        Unix ns; a span still open has ``end`` 0."""
        to_unix = (time.time_ns() - _clock()).__add__
        return [Span(s.id, s.parent, s.root, s.name, s.kind, to_unix(s.start),
                     to_unix(s.end) if s.end else 0, s.reason, s.syncs, s.nbytes)
                for s in list(self._spans)]

    def by_name(self) -> Dict[str, Dict[str, float]]:
        """{name: {"count", "ms"}} over the closed spans: their number and
        their host milliseconds, children included."""
        out: Dict[str, Dict[str, float]] = defaultdict(lambda: dict(count=0, ms=0.0))
        for s in self.spans():
            if s.end:
                row = out[s.name]
                row["count"] += 1
                row["ms"] += (s.end - s.start) / 1e6
        return dict(out)

    def clear(self):
        self._spans = []
        self.dropped = 0


tracer = Tracer()

_profiler_start = getattr(_autograd_profiler, "_run_on_profiler_start", None)


def _on_profiler_start():
    """torch's call at the start of each profiler session, wrapped: a
    session begun outside ``enable_tracing()`` starts with no spans, so a
    process that profiles again and again keeps only the last session's."""
    if not tracer.enabled:
        tracer.clear()
    _profiler_start()


if _profiler_start is not None:
    _autograd_profiler._run_on_profiler_start = _on_profiler_start


@contextlib.contextmanager
def enable_tracing():
    """Record spans, and push NVTX ranges once CUDA is up, inside."""
    prev = tracer.enabled
    tracer.enabled = True
    try:
        yield tracer
    finally:
        tracer.enabled = prev


def annotate(name: str, kind: str = "frame"):
    """Decorator: the function's calls are spans of ``kind`` named
    ``name`` while recording; otherwise a flag check and the call."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*a, **k):
            if not (tracer.enabled or _autograd_profiler._is_profiler_enabled):
                return fn(*a, **k)
            span = tracer._begin(name, kind)
            try:
                return fn(*a, **k)
            finally:
                tracer._end(span)

        return wrapper

    return deco


def on_cuda(where) -> bool:
    """Whether a tensor, or a device (None: the default, the CPU), is a
    CUDA device's."""
    if where is None:
        return False
    device = where.device if isinstance(where, torch.Tensor) else torch.device(where)
    return device.type == "cuda"


def synced(reason: str, where, op, *args, syncs: int = 1, **kwargs):
    """``op(*args, **kwargs)``, a call that makes the host wait for the
    device ``syncs`` times (a copy to or from the host, ``nonzero``, a
    boolean mask, a ``unique``; ``bincount`` waits twice, for the values'
    least and greatest): a "sync" span of ``reason`` while recording where
    ``where``, a tensor or a device, is on a CUDA device."""
    if not (tracer.enabled or _autograd_profiler._is_profiler_enabled) or not on_cuda(where):
        return op(*args, **kwargs)
    span = tracer._begin(reason, "sync")
    span.reason = reason
    span.syncs = syncs
    try:
        return op(*args, **kwargs)
    finally:
        tracer._end(span)


def tolist(t: torch.Tensor, reason: str) -> list:
    """``t.tolist()``, counted as a sync of ``reason``."""
    return synced(reason, t, t.tolist)


def item(t: torch.Tensor, reason: str):
    """``t.item()``, counted as a sync of ``reason``."""
    return synced(reason, t, t.item)


def to_int(t: torch.Tensor, reason: str) -> int:
    """``int(t)``, counted as a sync of ``reason``."""
    return int(synced(reason, t, t.item))


def to_bool(t: torch.Tensor, reason: str) -> bool:
    """``bool(t)``, counted as a sync of ``reason``."""
    return bool(synced(reason, t, t.item))


def masked(t: torch.Tensor, mask: torch.Tensor, reason: str) -> torch.Tensor:
    """``t[mask]`` for a boolean mask (the host waits for its count),
    counted as a sync of ``reason``."""
    return synced(reason, mask, t.__getitem__, mask)


def kernel(name: str, nbytes: int, launch, *args):
    """``launch(*args)``, the call of C entry point ``name``: a "kernel"
    span holding the launch's least bytes while recording."""
    if not (tracer.enabled or _autograd_profiler._is_profiler_enabled):
        return launch(*args)
    span = tracer._begin(name, "kernel")
    span.nbytes = int(nbytes)
    try:
        return launch(*args)
    finally:
        tracer._end(span)


_PROFILE: List[Optional[tuple]] = [None]


def start_profiler_trace(logdir: str):
    """Start a torch.profiler trace, written to ``logdir`` when stopped;
    the spans recorded before are cleared."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    tracer.clear()
    prof.__enter__()
    _PROFILE[0] = (prof, logdir)


def stop_profiler_trace():
    """Stop the trace and write ``<logdir>/trace.json`` (Chrome's format):
    the profiler's events, and the spans as a track of their own (process
    "cudf_tpu_torch spans") on the same clock."""
    prof, logdir = _PROFILE[0]
    _PROFILE[0] = None
    prof.__exit__(None, None, None)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", 0))
    pid = "cudf_tpu_torch spans"
    events = trace.setdefault("traceEvents", [])
    events.append({"ph": "M", "name": "process_name", "pid": pid, "args": {"name": pid}})
    for s in tracer.spans():
        if not s.end:
            continue
        args = {"id": s.id, "parent": s.parent, "root": s.root}
        if s.reason is not None:
            args["reason"] = s.reason
        if s.kind == "kernel":
            args["bytes"] = s.nbytes
        events.append({"ph": "X", "cat": s.kind, "name": s.name, "pid": pid, "tid": s.kind,
                       "ts": (s.start - base) / 1e3, "dur": (s.end - s.start) / 1e3,
                       "args": args})
    with open(path, "w") as f:
        json.dump(trace, f)
    return prof
