"""The queries' least time over their device time, in % (layer: kernels).

The least time is each query's least bytes (every input column it names
read once, its answer written once: ``tasks/<task>.py`` ``least_bytes``)
over the device's peak bandwidth; the device time is that of every device
operation that started inside the query's range.  It reads the same work
whatever implements it."""

from portbench.roofline import least_seconds


def read(trace):
    device = sum(trace.device_seconds())
    if device <= 0:
        return None
    return 100.0 * sum(least_seconds(q.least_bytes) for q in trace.queries) / device
