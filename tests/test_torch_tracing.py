"""``cudf_tpu_torch/utils/tracing.py``'s spans and counters, and the
benchmark's readers of them (``portbench/spans.py`` and its five metrics).

CPU cases: tracing off records nothing, opens no ``record_function`` and
pushes no NVTX; under a CPU ``torch.profiler`` the frame, ops, sync and
kernel spans carry their parent and request (root) ids; self time; the
sync helper counts only CUDA tensors (the device check stubbed); a
profiler session starts with no spans; each kernel's least bytes equal
``chip_smoke.py``'s bound bytes for A–G, and H's lie at or below it;
``spans.py`` recovers a known offset and refuses spans shifted outside
the queries; the metrics' arithmetic on a synthetic trace;
``tools/span_report.py``'s report at the small size.

Marked ``cuda`` (skipped without a card, decided in the fixture): over one
pass of each cell's mix at a small size the counted syncs equal torch's
sync debug mode count; spans add no device operation under the profiler;
each kernel span's bytes on the card.  On the card, run
``python -m pytest tests/test_torch_tracing.py -q --noconftest``.
"""

import json
import warnings
from contextlib import nullcontext

import pytest
import torch

import chip_smoke
import cudf_tpu_torch as ct
from cudf_tpu_torch.kernels import _build
from cudf_tpu_torch.kernels import hash_aggregate as ha
from cudf_tpu_torch.kernels import radix_partition as rp
from cudf_tpu_torch.kernels import tile_sort as ts
from cudf_tpu_torch.utils import tracing
from portbench import spans as sp
from portbench.metrics import (cuda_kernel_roofline_share, dispatch_idle_share,
                               frame_host_ms_per_query, ops_host_ms_per_query,
                               program_syncs_per_query)
from portbench.roofline import HBM_BYTES_PER_S
from portbench.trace import Query, Trace

READERS = (frame_host_ms_per_query, ops_host_ms_per_query, dispatch_idle_share,
           program_syncs_per_query, cuda_kernel_roofline_share)


@pytest.fixture(autouse=True)
def fresh_tracer():
    tracing.tracer.clear()
    yield
    tracing.tracer.clear()


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@tracing.annotate("outer")
def _outer(x):
    return _inner(x) + _inner(x)


@tracing.annotate("inner", "ops")
def _inner(x):
    return tracing.synced("probe", x, torch.nonzero, x).shape[0]


def _cpu_profile():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU])


def test_off_records_nothing_and_opens_no_range_or_nvtx(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a range was opened with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", refuse)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(tracing, "on_cuda", lambda where: True)
    x = torch.tensor([0, 1, 1])
    assert _outer(x) == 4
    assert tracing.to_int(x.sum(), "r") == 2 and tracing.tolist(x, "r") == [0, 1, 1]
    assert tracing.kernel("cudf_probe", 8, lambda: 0) == 0
    with tracing.tracer.range("operator"):
        pass
    assert tracing.tracer.spans() == []


def test_profiler_spans_have_parents_and_requests_and_no_profiler_event():
    x = torch.tensor([0, 1, 1])
    with _cpu_profile() as prof:
        _outer(x)
        _outer(x)
    spans = tracing.tracer.spans()
    assert [(s.name, s.kind) for s in spans] == [("outer", "frame"), ("inner", "ops"),
                                                 ("inner", "ops")] * 2
    outer = [s for s in spans if s.name == "outer"]
    assert all(s.parent is None and s.root == s.id for s in outer)
    assert outer[0].root != outer[1].root
    for s in spans:
        if s.name == "inner":
            parent = next(o for o in outer if o.id == s.parent)
            assert s.root == parent.root and parent.start <= s.start <= s.end <= parent.end
    assert not any(e.name in ("outer", "inner") for e in prof.events())
    # no sync span: the tensors are on the CPU
    assert all(s.kind != "sync" for s in spans)


def test_nvtx_only_under_enable_tracing(monkeypatch):
    pushed = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", pushed.append)
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop", lambda: pushed.append("pop"))
    x = torch.tensor([1])
    with _cpu_profile():
        _outer(x)
    assert pushed == []
    with tracing.enable_tracing() as t:
        assert t is tracing.tracer and t.enabled
        _outer(x)
    assert not tracing.tracer.enabled
    assert pushed == ["outer", "inner", "pop", "inner", "pop", "pop"]


def test_sync_helper_counts_cuda_tensors_only(monkeypatch):
    assert [tracing.on_cuda(w) for w in (None, "cpu", torch.device("cuda", 0), "cuda")] == [
        False, False, True, True]
    x = torch.tensor([3, 0, 5])
    with tracing.enable_tracing():
        assert tracing.to_int(x.max(), "key_range") == 5
    assert tracing.tracer.spans() == []
    monkeypatch.setattr(tracing, "on_cuda", lambda where: True)
    with tracing.enable_tracing():
        assert tracing.to_int(x.max(), "key_range") == 5
        assert tracing.to_bool(x.any(), "nan_check") is True
        assert tracing.item(x[0], "element") == 3
        assert tracing.tolist(x, "build_stats") == [3, 0, 5]
        got = tracing.synced("dense_check", x, torch.bincount, x, minlength=7, syncs=2)
    assert got.tolist() == [1, 0, 0, 1, 0, 1, 0]
    spans = tracing.tracer.spans()
    assert [(s.kind, s.reason, s.syncs) for s in spans] == [
        ("sync", "key_range", 1), ("sync", "nan_check", 1), ("sync", "element", 1),
        ("sync", "build_stats", 1), ("sync", "dense_check", 2)]
    assert all(s.end >= s.start > 0 for s in spans)


def test_self_times():
    S = sp.Placed
    spans = [S(1, None, 1, "f", "frame", 0, 100, None, 0, 0),
             S(2, 1, 1, "o", "ops", 10, 60, None, 0, 0),
             S(3, 2, 1, "s", "sync", 20, 30, None, 1, 0),
             S(4, 1, 1, "o", "ops", 50, 90, None, 0, 0),
             S(5, None, 5, "f", "frame", 200, 250, None, 0, 0)]
    assert sp.self_us(spans) == {1: 20, 2: 40, 3: 10, 4: 40, 5: 50}
    assert sp.self_intervals(spans)[1] == [(0, 10), (90, 100)]
    with tracing.enable_tracing():
        with tracing.tracer.range("a"):
            with tracing.tracer.range("b"):
                pass
    rows = tracing.tracer.by_name()
    assert rows["a"]["count"] == rows["b"]["count"] == 1
    assert rows["a"]["ms"] >= rows["b"]["ms"] >= 0


def test_a_profiler_session_starts_with_no_spans():
    x = torch.tensor([0, 1, 1])
    for _ in range(3):
        with _cpu_profile():
            _outer(x)
    assert [s.name for s in tracing.tracer.spans()] == ["outer", "inner", "inner"]
    with tracing.enable_tracing():
        _outer(x)
        with _cpu_profile():
            _outer(x)
    assert len(tracing.tracer.spans()) == 9


def test_span_times_are_unix_ns():
    import time

    before = time.time_ns()
    with tracing.enable_tracing():
        with tracing.tracer.range("a"):
            pass
    (s,) = tracing.tracer.spans()
    assert before - 5_000_000 <= s.start <= s.end <= time.time_ns() + 5_000_000


def _g1_codes(n, k, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, k, (n,), generator=g, dtype=torch.int32)


KERNEL_BYTES = {
    # kernel: (the wrapper's least bytes, chip_smoke.py's bound bytes), at a small shape
    "A": lambda c, v, w: (ha.onehot_bytes(c, None, [v], [torch.zeros(8, dtype=torch.float64),
                                                         torch.zeros(8, dtype=torch.int64)]),
                          chip_smoke.nbytes(c, v) + 16 * 8),
    "A3": lambda c, v, w: (ha.onehot_bytes(c, None, [w, w, v], [
        torch.zeros(8, dtype=torch.int64), torch.zeros(8, dtype=torch.int64),
        torch.zeros(8, dtype=torch.float64), torch.zeros(8, dtype=torch.int64)]),
        chip_smoke.nbytes(c, w, w, v) + 32 * 8),
    "B": lambda c, v, w: (_build.nbytes(c, rp.digit_histogram_plain(c, 4, 0, 256)),
                          chip_smoke.nbytes(c, rp.digit_histogram_plain(c, 4, 0, 256))),
    "C": lambda c, v, w: (rp.scatter_bytes(c, [w, v], torch.zeros(64, dtype=torch.int32),
                                           torch.empty_like(c), [torch.empty_like(w),
                                                                 torch.empty_like(v)]),
                          2 * chip_smoke.nbytes(c, w, v)
                          + chip_smoke.nbytes(torch.zeros(64, dtype=torch.int32))),
    "D": lambda c, v, w: (rp.bucket_bytes(c, [w, v], [torch.zeros(4096, dtype=torch.int64),
                                                      torch.zeros(4096, dtype=torch.float64)],
                                          torch.zeros(4096, dtype=torch.int64)),
                          chip_smoke.nbytes(c, w, v, torch.zeros(4096, dtype=torch.int64),
                                            torch.zeros(4096, dtype=torch.float64),
                                            torch.zeros(4096, dtype=torch.int64))),
    "E": lambda c, v, w: (ts.sort_bytes(c, [w]), 2 * chip_smoke.nbytes(c, w)),
    "F": lambda c, v, w: (ts.sort_bytes(c, [w, v]), 2 * chip_smoke.nbytes(c, w, v)),
    "G": lambda c, v, w: (rp.scatter_bytes(c, [w, v], torch.zeros(16, dtype=torch.int32),
                                           torch.empty_like(c), [torch.empty_like(w),
                                                                 torch.empty_like(v)]),
                          2 * chip_smoke.nbytes(c, w, v)
                          + chip_smoke.nbytes(torch.zeros(16, dtype=torch.int32))),
}


@pytest.mark.parametrize("kernel", sorted(KERNEL_BYTES))
def test_kernel_bytes_equal_chip_smoke_bounds(kernel):
    c = _g1_codes(4096, 4096)
    v = torch.rand(4096, dtype=torch.float64)
    w = c.clone()
    ours, bound = KERNEL_BYTES[kernel](c, v, w)
    assert ours == bound > 0


@pytest.mark.parametrize("pay", [None, torch.float64])
@pytest.mark.parametrize("shape", ["every_slot", "some_slots_some_windows"])
def test_window_probe_bytes_equal_chip_smoke_bound(pay, shape):
    """H's span bytes never exceed chip_smoke.py's bound: equal to its
    bids and payload, below it by the keys and entries, where every key
    lies in its window and touches a slot as where only some do."""
    half = rp.SPAN // 2
    if shape == "every_slot":
        pk = torch.arange(4 * rp.SPAN, dtype=torch.int32) % (2 * rp.SPAN)
        base = torch.tensor([0, 2 * rp.SPAN, 4 * rp.SPAN])
        pk = torch.sort(pk).values
    else:
        pk = torch.full((3 * rp.SPAN,), -1, dtype=torch.int32)   # rows past base[-1]
        pk[:half] = torch.arange(half) * 2                      # window 0: even slots
        pk[half:2 * half] = rp.SPAN + torch.arange(half)        # window 1: its first half
        pk[2 * half:2 * half + 100] = torch.arange(100)         # out of their window
        base = torch.tensor([0, half, 2 * half + 100])
    m = 1 if pay is not None else 2
    tables = torch.arange(m * 2 * rp.SPAN, dtype=torch.int64).view(m, -1) % 3
    bits = None if pay is None else torch.arange(2 * rp.SPAN, dtype=torch.int64)
    bids, _ = rp.window_probe(pk, base, tables, bits, pay)
    n = pk.numel()
    bound, touched = chip_smoke.probe_bound(pk, base, tables, pay)
    ours = rp.probe_bytes(n, m, None if pay is None else pay.itemsize)
    assert ours == 4 * m * n + (0 if pay is None else pay.itemsize * n)
    assert 0 < ours <= bound
    assert (touched == 2 * rp.SPAN) == (shape == "every_slot")
    assert bool((bids[:, int(base[-1]):] == -1).all())


def test_launch_counts_and_records_a_kernel_span(monkeypatch):
    class Lib:
        def function(self, name, argtypes):
            return lambda *args: 0

    def wrapper():
        pass

    wrapper.launches = 0
    monkeypatch.setattr(_build, "library", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "device", lambda d: nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: type("S", (), {"cuda_stream": 0})())
    _build.launch("cudf_probe", [], "cpu", counter=wrapper, nbytes=4096)
    assert wrapper.launches == 1 and tracing.tracer.spans() == []
    with tracing.enable_tracing():
        _build.launch("cudf_probe", [], "cpu", counter=wrapper, nbytes=4096)
        _build.launch("cudf_probe_occupancy", [], "cpu")
    assert wrapper.launches == 2
    assert [(s.name, s.kind, s.nbytes) for s in tracing.tracer.spans()] == [
        ("cudf_probe", "kernel", 4096)]


def test_question_spans_nest_frame_over_ops():
    df = ct.DataFrame({"id6": torch.tensor([3, 1, 3, 2], dtype=torch.int32),
                       "v3": torch.tensor([1.0, float("nan"), 4.0, 2.0], dtype=torch.float64)})
    with _cpu_profile():
        out = (df[~df["v3"].isna()][["id6", "v3"]].sort_values("v3", ascending=False)
               .groupby("id6", as_index=False, sort=False).head(2))
        len(out)
    spans = tracing.tracer.spans()
    names = {s.name for s in spans if s.kind == "frame"}
    assert {"DataFrame.__getitem__", "Series.isna", "Series.__invert__",
            "DataFrame.sort_values", "DataFrame.groupby", "GroupBy.head",
            "DataFrame.__len__"} <= names
    by_id = {s.id: s for s in spans}
    ops = [s for s in spans if s.kind == "ops"]
    assert ops and all(by_id[s.parent].kind in ("frame", "ops") for s in ops)


def test_stop_profiler_trace_writes_the_spans_track(tmp_path):
    tracing.start_profiler_trace(str(tmp_path))
    _outer(torch.tensor([1, 0]))
    prof = tracing.stop_profiler_trace()
    trace = json.loads((tmp_path / "trace.json").read_text())
    ours = [e for e in trace["traceEvents"] if e.get("pid") == "cudf_tpu_torch spans"
            and e.get("ph") == "X"]
    assert [e["name"] for e in ours] == ["outer", "inner", "inner"]
    assert ours[1]["args"]["parent"] == ours[0]["args"]["id"]
    assert not any(e.key in ("outer", "inner") for e in prof.key_averages())
    # the spans lie on the profiler's events' clock
    theirs = [e["ts"] for e in trace["traceEvents"] if e.get("ph") == "X"
              and e.get("pid") != "cudf_tpu_torch spans"]
    assert min(theirs) - 1e6 < ours[0]["ts"] < max(theirs) + 1e6


# ----------------------------------------------------------------------
# portbench/spans.py and the metrics on a synthetic trace
# ----------------------------------------------------------------------

OFFSET_NS = 1_790_000_000_000_000_000      # the trace's start on the Unix clock


def _trace():
    t = Trace()
    t.queries = [Query("q1", 1000.0, 5000.0, 0), Query("q2", 6000.0, 9000.0, 0),
                 Query("q3", 10000.0, 14000.0, 0)]
    t.device_ops = [("void at::native::gather_kernel", 1000.0, 3000.0),
                    ("Memset (Device)", 6500.0, 7000.0),
                    ("void cudf_tpu_torch::(anonymous namespace)::tile_sort_kernel()",
                     7000.0, 8000.0),
                    ("void at::native::sort_kernel", 10000.0, 13000.0)]
    return t


def _spans(shift_us=0.0, drift=0.0):
    """Roots at each query's start, q1's with an ops child and a sync
    grandchild, q2's with a kernel span; times on the Unix clock in ns."""
    S = tracing.Span

    def ns(us):
        return OFFSET_NS + int(round((us + drift * us) * 1e3))

    return [S(1, None, 1, "DataFrame.merge", "frame", ns(1000), ns(4500)),
            S(2, 1, 1, "join.join", "ops", ns(1500), ns(3500)),
            S(3, 2, 1, "build_stats", "sync", ns(2000), ns(2500), "build_stats", 2),
            S(4, None, 4, "DataFrame.merge", "frame", ns(6000), ns(8500)),
            S(5, 4, 4, "cudf_tile_sort", "kernel", ns(6100), ns(6200), nbytes=int(3.35e12 * 5e-4)),
            S(6, None, 6, "DataFrame.merge", "frame", ns(10000 + shift_us),
              ns(13500 + shift_us))]


def test_spans_recovers_a_known_offset():
    p = sp.place(_trace(), _spans())
    assert p is not None and p.spread_us < 1.0
    roots = [s for s in p.spans if s.parent is None]
    assert [s.start for s in roots] == pytest.approx([1000, 6000, 10000])
    assert p.query_of_root == {1: 0, 4: 1, 6: 2}
    # a drift between the clocks (here 3 parts in a thousand) is taken out
    p = sp.place(_trace(), _spans(drift=3e-3))
    assert [s.start for s in p.spans if s.parent is None] == pytest.approx([1000, 6000, 10000],
                                                                           abs=0.5)


def test_spans_refuse_roots_outside_the_ranges():
    assert sp.place(_trace(), _spans(shift_us=600.0)) is None
    assert sp.place(_trace(), []) is None


def test_metrics_on_a_synthetic_trace(monkeypatch):
    monkeypatch.setattr(sp, "recorded", lambda: _spans())
    t = _trace()
    # frame self: 3500 - 2000, 2500 - 100, 3500 us; ops self: 2000 - 500 us
    assert frame_host_ms_per_query.read(t) == pytest.approx((1.5 + 2.4 + 3.5) / 3)
    assert ops_host_ms_per_query.read(t) == pytest.approx(1.5 / 3)
    assert program_syncs_per_query.read(t) == pytest.approx(2 / 3)
    # idle 3000-6500, 8000-10000, 13000-14000; roots cover 1500 + 500 + 500 + 500 of it
    assert dispatch_idle_share.read(t) == pytest.approx(100 * 3000 / 13000)
    # 1.675e9 bytes over 3.35e12 B/s = 0.5 ms, over the memset and the kernel (1.5 ms)
    assert HBM_BYTES_PER_S == 3.35e12
    assert cuda_kernel_roofline_share.read(t) == pytest.approx(100 * 0.5 / 1.5)


def test_readers_read_nothing_from_a_program_without_spans(monkeypatch):
    monkeypatch.setattr(sp, "recorded", lambda: [])
    t = _trace()
    assert [r.read(t) for r in READERS] == [None] * 5
    monkeypatch.setattr(sp, "recorded", lambda: [s for s in _spans() if s.kind != "kernel"])
    assert cuda_kernel_roofline_share.read(_trace()) is None


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

def _debug_syncs(fn):
    """(result, torch's sync debug mode warnings during fn())."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) and "prototype" not in str(w.message)
                    for w in seen)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["g1_sort_questions", "j1_join_questions"])
def test_counted_syncs_equal_sync_debug_mode(dev, cell, tmp_path):
    from portbench import harness
    from portbench.tests.conftest import small_spec

    r = harness.Run(harness.load_cell(cell, small_spec(tmp_path)), 2 ** 33 + 3, dev)
    r.setup()
    for q in r.questions:
        tracing.tracer.clear()
        with tracing.enable_tracing():
            res, debug = _debug_syncs(lambda: len(r.fn(q)(r.frames)))
        counted = sum(s.syncs for s in tracing.tracer.spans() if s.kind == "sync")
        assert counted == debug, (q, counted, debug)


@pytest.mark.cuda
def test_spans_add_no_device_operation(dev):
    from torch.profiler import ProfilerActivity, profile

    x = ct.DataFrame({"k": torch.arange(1 << 16, device=dev, dtype=torch.int32) % 1000,
                      "v": torch.rand(1 << 16, device=dev, dtype=torch.float64)})
    dim = ct.DataFrame({"k": torch.arange(1000, device=dev, dtype=torch.int32),
                        "w": torch.rand(1000, device=dev, dtype=torch.float64)})
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        len(x.merge(dim, on="k"))
        len(x.groupby("k", sort=False, as_index=False).agg({"v": "sum"}))
        torch.cuda.synchronize()
    names = {s.name for s in tracing.tracer.spans()}
    assert {"DataFrame.merge", "join.join"} <= names
    device = {e.name for e in prof.events() if "CUDA" in str(e.device_type)}
    assert device and not names & device


@pytest.mark.cuda
def test_kernel_spans_carry_their_least_bytes(dev):
    g = torch.Generator(device=dev).manual_seed(5)
    n = 1 << 20
    keys = torch.randint(0, 1 << 20, (n,), generator=g, device=dev, dtype=torch.int32)
    vals = torch.rand(n, generator=g, device=dev, dtype=torch.float64)
    with tracing.enable_tracing():
        hist = rp.digit_histogram(keys, 7, 13, 4096)
        sk, (sv,) = ts.tile_sort_data(keys, [vals], rp.SORT_TILE, alternate=True)
        ha.onehot_groupby_aggregate(keys % 100, vals, 100, with_minmax=False)
        # some keys null, half the slots touched, half the rows past base[-1]
        pk = torch.where(keys % 5 == 0, -1, keys % (rp.SPAN // 2))
        tables = torch.arange(2 * rp.SPAN, device=dev, dtype=torch.int64).view(2, -1) % 7
        base = torch.tensor([0, n // 2], device=dev)
        rp.window_probe(pk, base, tables)
    got = {s.name: s.nbytes for s in tracing.tracer.spans() if s.kind == "kernel"}
    assert got["cudf_window_probe"] <= chip_smoke.probe_bound(pk, base, tables)[0]
    assert got["cudf_digit_histogram"] == chip_smoke.nbytes(keys, hist)
    assert got["cudf_tile_sort"] == 2 * chip_smoke.nbytes(keys, vals)
    assert got["cudf_onehot_aggregate"] == chip_smoke.nbytes(keys, vals) + 16 * 100


@pytest.mark.parametrize("cell", ["g1_sort_questions", "j1_join_questions"])
def test_span_report_rehearses_on_the_cpu(cell, tmp_path, monkeypatch):
    """``tools/span_report.py``'s report at the small size, every tensor
    counted as a card's: the syncs, the idle split and the kernels read."""
    import importlib.util
    from pathlib import Path

    from portbench import harness
    from portbench.tests.conftest import small_spec

    path = Path(__file__).resolve().parent.parent / "tools" / "span_report.py"
    spec = importlib.util.spec_from_file_location("span_report", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", lambda mode: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(tracing, "on_cuda", lambda where: True)
    out = tool.report(harness.load_cell(cell, small_spec(tmp_path)), 2 ** 33 + 5, 0.5,
                      torch.device("cpu"), span_calls=100)
    assert out["correct"] and out["attempted"] > 0
    assert all(q["waits"] >= sum(q["by_reason"].values()) > 0
               for q in out["sync_pass"].values())
    assert out["alignment"]["spread_us"] >= 0 and out["device_ops_named_as_spans"] == []
    idle = sum(out["idle_by_innermost_s"].values())
    assert abs(idle - out["idle_s"]) <= 1e-6 * max(1.0, out["idle_s"]) + 1e-9
    assert set(out["span_cost_us"]) == {"bare", "off", "under_profiler", "enable_tracing"}
