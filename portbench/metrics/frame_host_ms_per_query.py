"""The host's milliseconds a query in the port's frame layer (layer:
frame): the self time of every "frame" span (a public method of
``DataFrame``, ``Series`` or a groupby; its duration less the part its
child spans cover), over the window's queries (``portbench/spans.py``)."""

from portbench.spans import host_ms_per_query


def read(trace):
    return host_ms_per_query(trace, "frame")
