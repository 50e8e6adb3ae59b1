"""The share of the traced window in which no operation ran on the
device, in % (layer: device): one minus the union of the profiler's
device intervals over the window."""

from portbench.trace import length


def read(trace):
    window = length(trace.window())
    if window <= 0 or not trace.device_ops:
        return None
    return 100.0 * (1.0 - length(trace.busy()) / window)
