"""The port's own CUDA kernels' least time over their device time, in %
(layer: kernels): Σ the "kernel" spans' bytes (each launch's operands
read once, its outputs written once) over the device's peak bandwidth,
over Σ the device time of the operations the library's entry points
enqueue (``portbench/spans.py`` ``kernel_ops``).  None where no kernel
was launched."""

from portbench.roofline import least_seconds
from portbench.spans import kernel_ops, place


def read(trace):
    p = place(trace)
    if p is None:
        return None
    moved = sum(s.nbytes for s in p.spans if s.kind == "kernel")
    device = sum(e - s for _, s, e in kernel_ops(trace)) / 1e6
    if moved <= 0 or device <= 0:
        return None
    return 100.0 * least_seconds(moved) / device
