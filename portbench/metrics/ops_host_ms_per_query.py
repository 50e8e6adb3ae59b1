"""The host's milliseconds a query in the port's ops layer (layer: ops
dispatch): the self time of every "ops" span (an entry point of
``cudf_tpu_torch/ops``), over the window's queries; sync and kernel spans
are its children, so the wait of a sync is not ops time."""

from portbench.spans import host_ms_per_query


def read(trace):
    return host_ms_per_query(trace, "ops")
