"""The share of the traced window in which the device ran nothing while
the host was inside a root span of the port, in % (layer: ops dispatch).
``device_idle_share`` less this is the device waiting on the client."""

from portbench.spans import place, root_intervals
from portbench.trace import intersect, length, subtract


def read(trace):
    p = place(trace)
    window = length(trace.window())
    if p is None or window <= 0 or not trace.device_ops:
        return None
    idle = subtract(trace.window(), trace.busy())
    return 100.0 * length(intersect(idle, root_intervals(p))) / window
