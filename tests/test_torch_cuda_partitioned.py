"""The spill manager and the partitioned executor on the card.

Marked ``cuda``: without a CUDA device every test here skips (decided in
the fixture, never at import).  On a machine with a card run
``python -m pytest tests/test_torch_cuda_partitioned.py -q --noconftest``.

- Spilling drops ``torch.cuda.memory_allocated`` by the bytes the manager
  reports freed; ``ensure_on_device`` restores every buffer bit for bit;
  the host copies are pinned; an op over a spilled column raises.
- Every call of kernels A, B, F, G, D and H that the streaming groupby and
  join make is recorded and replayed against its plain version on the same
  inputs: bit for bit, but A's and D's float sums (rtol 1e-12, the order of
  atomic adds) and G's rows no run covers.
- ``models/partitioned.py``'s requests at small sizes, TPC-H spilling,
  each equal to the in-memory executor on the card.
"""

import inspect
import sys
import tempfile

import pytest
import torch

import cudf_tpu_torch as ct
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.kernels import hash_aggregate as ha
from cudf_tpu_torch.kernels import radix_partition as rp
from cudf_tpu_torch.kernels import tile_sort as ts
from cudf_tpu_torch.models import partitioned as pm
from cudf_tpu_torch.utils import spill as sp
from cudf_tpu_torch.utils.config import option_context

pytestmark = pytest.mark.cuda

WRAPPERS = {"onehot_groupby_aggregate": (ha.onehot_groupby_aggregate,
                                         ha.onehot_groupby_aggregate_plain),
            "digit_histogram": (rp.digit_histogram, rp.digit_histogram_plain),
            "tile_sort_data": (ts.tile_sort_data, ts.tile_sort_data_plain),
            "merge_scatter": (rp.merge_scatter, rp.merge_scatter_plain),
            "bucket_aggregate": (rp.bucket_aggregate, rp.bucket_aggregate_plain),
            "window_probe": (rp.window_probe, rp.window_probe_plain)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _columns(dev, n=1 << 20, count=4):
    g = torch.Generator(device=dev).manual_seed(3)
    return [Column.from_tensor(torch.rand(n, generator=g, device=dev, dtype=torch.float64))
            for _ in range(count)]


def test_a_spill_drops_memory_allocated_by_the_bytes_it_reports(dev):
    cols = _columns(dev)
    mgr = sp.SpillManager()
    for c in cols:
        mgr.register(c)
    assert mgr.device_bytes() == 4 * 8 << 20
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    freed = mgr.spill_to_budget(16 << 20)
    torch.cuda.synchronize()
    assert freed == 16 << 20 == before - torch.cuda.memory_allocated()
    assert [sp.is_spilled(c) for c in cols] == [True, True, False, False]
    assert all(c.device.type == "cuda" and c.data.host.is_pinned() for c in cols[:2])
    before = torch.cuda.memory_allocated()
    for c in cols[:2]:
        mgr.ensure_on_device(c)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() - before == 16 << 20


def test_a_view_of_a_resident_frame_frees_nothing_on_the_card(dev):
    resident = _columns(dev, count=1)[0]
    from cudf_tpu_torch.ops import copying

    views = [copying.slice(resident, i << 18, (i + 1) << 18) for i in range(4)]
    mgr = sp.SpillManager()
    for v in views:
        mgr.register(v)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    assert mgr.spill_to_budget(0) == 0 and mgr.spill(views[0]) == 0
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == before


def test_ensure_on_device_restores_every_buffer_bit_for_bit(dev):
    x = torch.randn(100_000, device=dev, dtype=torch.float64)
    x[::7] = float("nan")
    x[::11] = -0.0
    df = ct.DataFrame({"x": x, "k": torch.arange(100_000, device=dev) % 13})
    df["s"] = Column.from_strings([None if i % 9 == 0 else "é" * (i % 5)
                                   for i in range(100_000)], device=dev)
    copies = {n: [None if b is None else b.clone() for b in (c.data, c.validity, c.offsets)]
              for n, c in df._table.items()}
    sp.spill(df)
    with pytest.raises(sp.SpilledBufferError):
        df.groupby("k").agg({"x": "sum"})
    sp.unspill(df)
    for n, c in df._table.items():
        for b, ref in zip((c.data, c.validity, c.offsets), copies[n]):
            assert (b is None) == (ref is None)
            if b is not None:
                assert b.device.type == "cuda"
                assert torch.equal(b.view(torch.uint8), ref.view(torch.uint8))


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, (list, tuple)):
        return type(x)(_clone(v) for v in x)
    return x


class _Recorder:
    """Records every call of the kernel wrappers (in every cudf_tpu_torch
    module that bound them) with copies of their arguments."""

    def __init__(self):
        self.calls, self.patched = [], []

    def __enter__(self):
        for name, (fn, _) in WRAPPERS.items():
            def record(*args, fn=fn, name=name, **kwargs):
                bound = inspect.signature(fn).bind(*args, **kwargs)
                bound.apply_defaults()
                self.calls.append((name, {k: _clone(v) for k, v in bound.arguments.items()}))
                return fn(*args, **kwargs)
            record.launches = 0      # the wrapper counts through its module's name
            for mod in [m for k, m in sys.modules.items() if k.startswith("cudf_tpu_torch")]:
                if getattr(mod, name, None) is fn:
                    setattr(mod, name, record)
                    self.patched.append((mod, name, fn))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.patched:
            setattr(mod, name, fn)


def _flat(x):
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _flat(v)]
    return [x]


def _replay(name, args):
    kernel, plain = WRAPPERS[name]
    got = _flat(kernel(**args))
    params = inspect.signature(plain).parameters
    exp = _flat(plain(**{k: v for k, v in args.items() if k in params}))
    assert len(got) == len(exp), name
    rows = None
    if name == "merge_scatter":
        rows = args["out_rows"] or int((args["keys"] >= 0).sum())
    for g, e in zip(got, exp):
        assert (g is None) == (e is None), name
        if g is None:
            continue
        if rows is not None:
            g, e = g[:rows], e[:rows]
        if g.is_floating_point() and name in ("onehot_groupby_aggregate", "bucket_aggregate"):
            assert torch.allclose(g, e, rtol=1e-12, atol=0.0, equal_nan=True), name
        else:
            assert torch.equal(g.view(torch.uint8), e.view(torch.uint8)), name


@pytest.mark.parametrize("name,needs", [
    ("g1_k100", pm.ONEHOT), ("g1_k1e6", pm.RADIX), ("j1_big_broadcast", pm.JOIN),
    ("j1_big_shuffle", pm.JOIN)])
def test_the_streaming_groupby_and_join_kernels_equal_their_plain_versions(dev, name, needs):
    """At 4e6 G1 rows (K = 100 and 4e4) and J1 at 2e6 rows, each request
    equal to the in-memory executor, and every kernel call it made equal to
    the plain version's on the same inputs."""
    frames = {"g1": pm.g1_frame(4_000_000, device=dev)}
    frames["fact"], frames["dim"] = pm.j1_frames(2_000_000, device=dev)
    with _Recorder() as rec:
        res = pm.REQUESTS[name](frames)
        torch.cuda.synchronize()
    assert sorted({n for n, _ in rec.calls}) == sorted(needs)
    pm.PLAIN[name](frames, res)
    for kernel, args in rec.calls:
        _replay(kernel, args)


def test_tpch_streamed_from_files_with_spilling_equals_memory_on_the_card(dev, monkeypatch):
    from cudf_tpu_torch.models import tpch

    monkeypatch.setattr(pm, "SPILL_BUDGET", 64 << 10)

    tables = tpch.generate_device(0.05, seed=4, device=dev)
    frames = {"tpch": tables, "dataset": pm.tpch_dataset(
        pm.write_tpch_dataset(tables, tempfile.mkdtemp(), files=4), dev)}
    stats = sp.get_spill_manager().statistics
    with option_context("executor.target_partition_size", 1 << 22):
        for name in pm.GROUPS["tpch"] + pm.GROUPS["tpch_spill"]:
            before = stats.spills
            pm.PLAIN[name](frames, pm.REQUESTS[name](frames))
            assert name not in pm.SPILLS or stats.spills > before, name
