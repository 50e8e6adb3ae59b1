"""Host syncs per query, over one pass of the mix before the traced
window (torch's sync debug mode; layer: ops dispatch)."""


def read(trace):
    if not trace.syncs:
        return None
    return sum(trace.syncs.values()) / len(trace.syncs)
