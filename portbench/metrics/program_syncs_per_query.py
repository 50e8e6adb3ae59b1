"""Host syncs a query as the port counts them where they happen (layer:
ops dispatch): the host's waits in the "sync" spans of every query of
the traced window."""

from portbench.spans import place


def read(trace):
    p = place(trace)
    if p is None:
        return None
    return sum(s.syncs for s in p.spans if s.kind == "sync") / len(trace.queries)
