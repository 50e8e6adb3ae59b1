"""Readers of the per-layer metrics, one module a metric, found by the
metric's name in BENCHMARK.json.  Each has ``read(trace)`` returning a
number, or None where it finds nothing to read."""
