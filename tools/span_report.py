#!/usr/bin/env python3
"""Where one benchmark cell's time goes by the port's own spans, on one CUDA card.

Run from the repository root:  python3 tools/span_report.py <workload> <seed> [seconds [dir]]

1. One pass of the cell's mix under torch's sync debug mode with spans on
   (``enable_tracing``): for each question, the debug mode's sync warnings
   beside the port's sync spans by reason.
2. One traced run of ``portbench`` (``harness.run`` with ``--trace 1``),
   whose trace is kept for what its per-layer metrics do not give:
   - the window's idle time named by the innermost span the host was in
     (each span's self intervals; idle in none of them is the client's), and
     the "between queries" gaps split into the port's tail, the client and
     the port's head;
   - syncs a question by reason;
   - each C entry point's least bytes over the device time of its kernels
     (and of the memset just before one), as a share of 3.35 TB/s;
   - spans a query by kind, and the spans' alignment to the query ranges.
3. The cost of one span: a no-op under ``annotate`` off, under the
   profiler and under ``enable_tracing``.

Writes ``<dir>/span_report_<workload>_<seed>.json`` (``dir`` defaults to the current
directory) and prints it.  Exits with an error where no CUDA device is present.
"""

import collections
import json
import sys
import time
import warnings
from bisect import bisect_left
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from cudf_tpu_torch.utils import tracing  # noqa: E402
from portbench import harness, spans as sp, trace as tr  # noqa: E402
from portbench.roofline import least_seconds  # noqa: E402

# each C entry point's device kernels, by a part of the profiler's name
ENTRY_OF = {"digit_histogram_kernel": "cudf_digit_histogram", "radix_scatter": "cudf_radix_scatter",
            "tile_sort_kernel": "cudf_tile_sort", "merge_scatter_kernel": "cudf_merge_scatter",
            "merge_fill_kernel": "cudf_merge_scatter",
            "bucket_aggregate_kernel": "cudf_bucket_aggregate",
            "zero_windows_kernel": "cudf_bucket_aggregate",
            "window_probe_kernel": "cudf_window_probe", "onehot": "cudf_onehot_aggregate"}


def sync_pass(r):
    """{question: debug warnings, the port's waits and its spans by reason}."""
    torch.cuda.set_sync_debug_mode("warn")          # its one-time notice, out of the count
    torch.cuda.set_sync_debug_mode("default")
    out = {}
    for q in r.questions:
        torch.cuda.synchronize()
        tracing.tracer.clear()
        with warnings.catch_warnings(record=True) as seen, tracing.enable_tracing():
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                len(r.fn(q)(r.frames))
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = [s for s in tracing.tracer.spans() if s.kind == "sync"]
        out[q] = {"debug": sum("synchroniz" in str(w.message)
                               and "prototype" not in str(w.message) for w in seen),
                  "waits": sum(s.syncs for s in syncs),
                  "by_reason": dict(collections.Counter(s.reason for s in syncs))}
    tracing.tracer.clear()
    return out


def idle_split(t, p):
    """The window's idle seconds by innermost span, and the between-query
    gaps' tail / client / head."""
    mine = sp.self_intervals(p.spans)
    own = sorted((a, b, f"{s.kind}:{s.reason if s.kind == 'sync' else s.name}", s.root)
                 for s in p.spans for a, b in mine[s.id])
    starts = [a for a, _, _, _ in own]
    qstarts = [q.start for q in t.queries]
    by = collections.Counter()
    gaps = dict(tail=0.0, client=0.0, head=0.0)
    for a, b in tr.subtract(t.window(), t.busy()):
        covered = []
        i = max(0, bisect_left(starts, a) - 1)
        while i < len(own) and own[i][0] < b:
            x, y = max(a, own[i][0]), min(b, own[i][1])
            if y > x:
                by[own[i][2]] += (y - x) / 1e6
                covered.append((x, y, own[i][3]))
            i += 1
        client = (b - a - sum(y - x for x, y, _ in covered)) / 1e6
        by["client (no span of the port open)"] += client
        mid = (a + b) / 2
        k = bisect_left(qstarts, mid) - 1
        if k < 0 or mid >= t.queries[k].end:           # a gap between two queries
            gaps["client"] += client
            for x, y, root in covered:
                side = "tail" if t.queries[p.query_of_root[root]].start < mid else "head"
                gaps[side] += (y - x) / 1e6
    return dict(by.most_common()), gaps


def kernels(t, p):
    """{entry: launches a query, bytes, device s, share %}."""
    device = collections.Counter()
    ops = sorted(sp.kernel_ops(t), key=lambda o: o[1])
    for i, (name, a, b) in enumerate(ops):
        key = name if sp.NAMESPACE in name else ops[i + 1][0]   # a memset: its kernel's entry
        device[next((e for k, e in ENTRY_OF.items() if k in key), key[:60])] += (b - a) / 1e6
    moved, launches = collections.Counter(), collections.Counter()
    for s in p.spans:
        if s.kind == "kernel":
            moved[s.name] += s.nbytes
            launches[s.name] += 1
    return {e: {"launches_per_query": launches[e] / len(t.queries), "bytes": moved[e],
                "device_s": device[e],
                "share_pct": 100 * least_seconds(moved[e]) / device[e] if device[e] else None}
            for e in moved}


def span_cost_us(calls=50000):
    """Host µs of one call of a no-op: bare, under annotate off, under the
    profiler, under enable_tracing (NVTX once CUDA is up)."""
    from torch.profiler import ProfilerActivity, profile

    def per_call(fn, n):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            fn()
        return (time.perf_counter_ns() - t0) / n / 1e3

    noop = tracing.annotate("probe.noop")(lambda: None)
    out = {"bare": per_call(lambda: None, 4 * calls), "off": per_call(noop, 4 * calls)}
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts):
        out["under_profiler"] = per_call(noop, calls)
    with tracing.enable_tracing():
        out["enable_tracing"] = per_call(noop, calls)
    tracing.tracer.clear()
    return out


def report(cell, seed, seconds, dev, span_calls=50000):
    """The report of one cell on ``dev`` (see above)."""
    out = {"workload": cell.name, "seed": seed,
           "card": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
    r = harness.Run(cell, seed + 1, dev)
    r.setup()
    out["sync_pass"] = sync_pass(r)
    r.frames = r.data = None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    kept = {}
    from_profile = tr.from_profile
    tr.from_profile = lambda prof: kept.setdefault("trace", from_profile(prof))
    result = harness.run(cell, seed, seconds, True, dev, time.perf_counter())
    tr.from_profile = from_profile
    t = kept["trace"]
    out.update({k: result[k] for k in ("correct", "attempted", "metrics", "busy_s", "window_s")})
    p = sp.place(t)
    if p is not None:
        nq = len(t.queries)
        per_q = collections.Counter(q.question for q in t.queries)
        syncs = collections.defaultdict(collections.Counter)
        for s in p.spans:
            if s.kind == "sync":
                syncs[t.queries[p.query_of_root[s.root]].question][s.reason] += s.syncs
        out["alignment"] = {"spread_us": p.spread_us,
                            "offset_range_us": max(p.offsets_us) - min(p.offsets_us)}
        out["spans_per_query"] = {k: v / nq for k, v in
                                  collections.Counter(s.kind for s in p.spans).items()}
        out["waits_by_question"] = {q: {k: v / per_q[q] for k, v in c.items()}
                                    for q, c in syncs.items()}
        out["idle_s"] = tr.length(tr.subtract(t.window(), t.busy())) / 1e6
        out["idle_by_innermost_s"], out["between_queries_s"] = idle_split(t, p)
        out["kernels"] = kernels(t, p)
        names = {s.name for s in p.spans}
        out["device_ops_named_as_spans"] = sorted({n for n, _, _ in t.device_ops
                                                   if n in names})
    out["span_cost_us"] = span_cost_us(span_calls)
    return out


def main(workload, seed, seconds=30.0, out_dir="."):
    if not torch.cuda.is_available():
        sys.exit("span_report: no CUDA device")
    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)
    out = report(harness.load_cell(workload), seed, seconds, dev)
    Path(out_dir).mkdir(parents=True, exist_ok=True)
    Path(out_dir, f"span_report_{workload}_{seed}.json").write_text(json.dumps(out, indent=1))
    print(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), float(sys.argv[3]) if len(sys.argv) > 3 else 30.0,
         sys.argv[4] if len(sys.argv) > 4 else ".")
