"""Tracing and per-range timing (port of ``cudf_tpu/utils/tracing.py``;
the reference's NVTX ranges, CUDF_FUNC_RANGE).

- ``Tracer.range(name)`` opens a ``torch.profiler.record_function`` range
  (seen in a ``torch.profiler`` trace) and, when CUDA is initialised, an
  NVTX range (``torch.cuda.nvtx``, seen by Nsight); with tracing enabled
  it also records the range's host wall time, as the reference does
  (``time.perf_counter``, no device sync: a range that launches work
  records the launch time unless its caller synchronises).
- ``summary()`` sums the recorded seconds by name.
- ``start_profiler_trace(logdir)`` / ``stop_profiler_trace()`` record a
  ``torch.profiler`` trace (CPU, and CUDA where a card is present) and
  write it to ``logdir`` as a Chrome trace.
- ``annotate(name)`` wraps a function in a range.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch


@contextlib.contextmanager
def _device_range(name: str):
    nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


class Tracer:
    def __init__(self):
        self.enabled = False
        self.records: List[tuple] = []

    @contextlib.contextmanager
    def range(self, name: str):
        """A named range in profiler traces; with tracing enabled, its host
        seconds are recorded too."""
        if not self.enabled:
            with _device_range(name):
                yield
            return
        t0 = time.perf_counter()
        with _device_range(name):
            yield
        self.records.append((name, time.perf_counter() - t0))

    def summary(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for name, seconds in self.records:
            out[name] += seconds
        return dict(out)

    def clear(self):
        self.records.clear()


tracer = Tracer()


@contextlib.contextmanager
def enable_tracing():
    prev = tracer.enabled
    tracer.enabled = True
    try:
        yield tracer
    finally:
        tracer.enabled = prev


_PROFILE: List[Optional[tuple]] = [None]


def start_profiler_trace(logdir: str):
    """Start a torch.profiler trace, written to ``logdir`` when stopped."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.__enter__()
    _PROFILE[0] = (prof, logdir)


def stop_profiler_trace():
    """Stop the trace and write ``<logdir>/trace.json`` (Chrome's format)."""
    prof, logdir = _PROFILE[0]
    _PROFILE[0] = None
    prof.__exit__(None, None, None)
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    return prof


def annotate(name: str):
    """Decorator: run the function inside ``tracer.range(name)``."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*a, **k):
            with tracer.range(name):
                return fn(*a, **k)

        return wrapper

    return deco
