"""``utils/spill.py`` and the executor's spilling (``engine/streaming.py``)
against the reference's ``cudf_tpu/utils/spill.py`` (the JAX CPU backend)
and pandas, on seeded numpy data.

On the CPU a spill still copies each buffer into its host marker, so the
same code runs as on the card.  Where the reference is wrong (it counts
spilled columns as live and spills fresh ones again, ROADMAP.md §3), the
port is held to what a budget means and the reference's answer is shown
to differ.  Bytes are exact; the q1-shaped answer is held to pandas
(float sums rtol 1e-9, integer sums exact).
"""

import time

import numpy as np
import pandas as pd
import pytest
import torch

import torch_jax_cache  # noqa: F401  (the run's shared JAX compile cache)
from cudf_tpu.core.column import as_column as ref_as_column
from cudf_tpu.engine.expr import col as ref_col
from cudf_tpu.engine.lazy import LazyFrame as RefLazyFrame
from cudf_tpu.frame.dataframe import DataFrame as RefDataFrame
from cudf_tpu.utils import spill as ref_spill
from cudf_tpu.utils.config import option_context as ref_option_context
import cudf_tpu_torch as ct
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.core.table import Table
from cudf_tpu_torch.engine import col, from_dataframe
from cudf_tpu_torch.ops import copying
from cudf_tpu_torch.utils import spill as sp
from cudf_tpu_torch.utils.config import option_context

torch.set_num_threads(1)


def floats(n, seed):
    return np.random.default_rng(seed).random(n)


def frame(seed=0, n=500):
    """int32, float64 with nulls, STRING with nulls, a dictionary and a
    LIST column."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=n)
    v[rng.random(n) < 0.1] = np.nan
    s = rng.choice(["ab", "", "xyz", "q"], n).astype(object)
    s[rng.random(n) < 0.1] = None
    pdf = pd.DataFrame({"k": rng.integers(0, 9, n).astype(np.int32), "v": v, "s": s,
                        "c": pd.Categorical(rng.choice(["u", "w", "z"], n))})
    df = ct.DataFrame.from_pandas(pdf, device="cpu")
    df["l"] = ct.Series([[i, i + 1] if i % 3 else None for i in range(n)], device="cpu")
    return df


def snapshot(col):
    """Copies of every buffer spilling moves, children's included."""
    return [None if b is None else b.clone() for b in (col.data, col.validity, col.offsets)] + \
        ([] if col.dtype.is_dictionary else [snapshot(c) for c in col.children])


def assert_same(col, snap):
    bufs = [col.data, col.validity, col.offsets]
    for b, s in zip(bufs, snap[:3]):
        assert (b is None) == (s is None)
        if b is not None:
            assert isinstance(b, torch.Tensor) and torch.equal(b.view(torch.uint8),
                                                               s.view(torch.uint8))
    for c, s in zip([] if col.dtype.is_dictionary else col.children, snap[3:]):
        assert_same(c, s)


def test_round_trip_restores_every_buffer_bit_for_bit():
    df = frame()
    snaps = {n: snapshot(c) for n, c in df._table.items()}
    keys = df._table["c"].keys
    before = df.to_pandas()
    freed = sp.spill(df)
    assert freed == df._table.nbytes - keys.nbytes
    for n, c in df._table.items():
        assert sp.is_spilled(c) and c.device == torch.device("cpu") and c._cache == {}
    assert isinstance(keys.data, torch.Tensor) and keys.offsets is not None   # keys stay
    sp.unspill(df)
    for n, c in df._table.items():
        assert not sp.is_spilled(c)
        assert_same(c, snaps[n])
    pd.testing.assert_frame_equal(df.to_pandas(), before)


@pytest.mark.parametrize("op", ["add", "sum", "groupby", "merge", "sort", "str_len",
                                "to_pandas", "filter"])
def test_an_op_over_a_spilled_column_raises(op):
    """Nothing computes on the host copy: any op that reaches it raises."""
    df = frame(1)
    sp.spill(df)
    run = {"add": lambda: df["v"] + 1.0, "sum": lambda: df["v"].sum(),
           "groupby": lambda: df.groupby("k").agg({"v": "sum"}),
           "merge": lambda: df.merge(df, on="k"), "sort": lambda: df.sort_values("v"),
           "str_len": lambda: df["s"].str.len(), "to_pandas": lambda: df.to_pandas(),
           "filter": lambda: df[df["k"] > 3]}[op]
    with pytest.raises(sp.SpilledBufferError):
        run()
    sp.unspill(df)
    run()


def test_spilling_drops_the_cache_and_keeps_the_device():
    c = Column.from_strings(["b", "a", None], device="cpu")
    assert c._cache                          # from_strings fills the host strings
    mgr = sp.SpillManager()
    mgr.spill(c)
    assert c._cache == {} and c.device == torch.device("cpu") and len(c) == 3
    mgr.ensure_on_device(c)
    assert c.host_strings() == ["b", "a", None]
    assert mgr.statistics.as_dict() == dict(spills=1, unspills=1, bytes_spilled=2 + 3 + 32,
                                            bytes_unspilled=2 + 3 + 32, bytes_freed=37)


def _four_then_two(make, register, spill_to_budget, on_device):
    """Four 8000 B columns registered coldest first and spilled to 16000 B;
    two fresh ones registered; a second spill to 16000 B.  Returns the two
    calls' freed bytes and whether the fresh columns stayed on the device."""
    cols = [make(i) for i in range(4)]
    for c in cols:
        register(c)
        time.sleep(0.002)                    # the reference orders by time.monotonic
    first = spill_to_budget(16000)
    fresh = [make(10 + i) for i in range(2)]
    for c in fresh:
        register(c)
        time.sleep(0.002)
    second = spill_to_budget(16000)
    return first, second, [on_device(c) for c in fresh], cols + fresh


def test_a_second_spill_frees_the_device_columns_and_keeps_the_fresh_ones():
    mgr = sp.SpillManager()
    first, second, kept, cols = _four_then_two(
        lambda i: Column.from_numpy(floats(1000, i), device="cpu"), mgr.register,
        mgr.spill_to_budget, lambda c: isinstance(c.data, torch.Tensor))
    assert (first, second, kept) == (16000, 16000, [True, True])
    assert [sp.is_spilled(c) for c in cols] == [True] * 4 + [False] * 2
    assert mgr.device_bytes() == 16000
    assert mgr.statistics.spills == 4 and mgr.statistics.bytes_freed == 32000


def test_the_reference_counts_spilled_columns_as_live():
    """The reference's second call frees 32000 B: it counts the host bytes
    of the columns already spilled as live, and so spills the two fresh
    (hottest) columns too (``cudf_tpu/utils/spill.py:99-110``)."""
    mgr = ref_spill.SpillManager()
    first, second, kept, _ = _four_then_two(
        lambda i: ref_as_column(floats(1000, i)), mgr.register, mgr.spill_to_budget,
        lambda c: not isinstance(c.data, ref_spill._HostSpilled))
    assert (first, second, kept) == (16000, 32000, [False, False])


def test_a_view_of_a_held_storage_is_neither_counted_nor_freed():
    """Partitions that view a resident frame release nothing when spilled:
    the budget does not count them, and a spill of one reports 0 bytes
    freed while it moves its bytes."""
    resident = Column.from_numpy(floats(4000, 3), device="cpu")
    views = [copying.slice(resident, i * 1000, (i + 1) * 1000) for i in range(4)]
    mgr = sp.SpillManager()
    for v in views:
        mgr.register(v)
    assert mgr.device_bytes() == 0
    assert mgr.spill_to_budget(0) == 0 and not any(sp.is_spilled(v) for v in views)
    assert mgr.spill(views[0]) == 0
    assert mgr.statistics.bytes_spilled == 8000 and mgr.statistics.bytes_freed == 0
    mgr.ensure_on_device(views[0])
    assert torch.equal(views[0].data, resident.data[:1000])


def test_the_last_view_spilled_releases_the_storage():
    """Views of a storage nothing else holds: the manager counts the
    storage once, and the spill that drops its last view frees all of it."""
    base = torch.from_numpy(floats(3000, 4))
    views = [Column.from_tensor(base[i * 1000:(i + 1) * 1000]) for i in range(3)]
    del base
    mgr = sp.SpillManager()
    for v in views:
        mgr.register(v)
    freed = [mgr.spill(v) for v in views]
    assert freed == [0, 0, 24000]


def test_nbytes_counts_each_storage_byte_once():
    df = frame(5)
    t = df._table
    dense = t.select(["k", "v", "s"])
    ref = RefDataFrame.from_pandas(df.to_pandas()[["k", "v", "s"]])._table
    assert dense.nbytes == ref.nbytes
    fixed = t.select(["k", "v"])             # views: a STRING slice is a copy
    parts = [Table.from_pairs(fixed.names, [copying.slice(c, i * 100, (i + 1) * 100)
                                            for c in fixed.columns]) for i in range(5)]
    assert sum(p.nbytes for p in parts[:2]) == Table.from_pairs(
        fixed.names, [copying.slice(c, 0, 200) for c in fixed.columns]).nbytes == 200 * 13
    twice = Table({"a": t["v"], "b": t["v"], "c": t["c"], "d": t["c"]})
    assert twice.nbytes == t["v"].nbytes + t["c"].nbytes


def test_the_executor_spills_and_still_answers_q1():
    """The reference's ``test_streaming_auto_spill_answers_q1``: a q1-shaped
    aggregation under a 64 KiB budget spills and answers as pandas and the
    reference do."""
    rng = np.random.default_rng(42)
    n = 20_000
    pdf = pd.DataFrame({"flag": rng.integers(0, 3, n), "qty": rng.integers(1, 50, n)
                        .astype(np.float64), "price": rng.normal(1000, 100, n)})

    def plan(lf, c):
        return lf.with_columns((c("qty") * c("price")).alias("rev")).group_by("flag").agg(
            c("rev").sum().alias("rev"), c("qty").sum().alias("qty"))

    stats = sp.get_spill_manager().statistics
    before = stats.as_dict()
    with option_context("spill", True, "spill.device_limit_bytes", 64 * 1024):
        got = plan(from_dataframe(ct.DataFrame.from_pandas(pdf, device="cpu")), col) \
            .collect(streaming=True, mesh=8).to_pandas()
    after = stats.as_dict()
    assert after["spills"] > before["spills"] and after["unspills"] > before["unspills"]
    assert after["bytes_freed"] - before["bytes_freed"] == \
        after["bytes_spilled"] - before["bytes_spilled"]          # every spilled byte freed
    assert sp.get_spill_manager().live_columns() == []
    exp = (pdf.assign(rev=pdf.qty * pdf.price).groupby("flag")
           .agg(rev=("rev", "sum"), qty=("qty", "sum")).reset_index())
    got = got.sort_values("flag").reset_index(drop=True)
    np.testing.assert_array_equal(got["flag"], exp["flag"])
    np.testing.assert_allclose(got["rev"], exp["rev"], rtol=1e-9)
    np.testing.assert_array_equal(got["qty"], exp["qty"])
    with ref_option_context("spill", True), \
            ref_option_context("spill.device_limit_bytes", 64 * 1024):
        ref = plan(RefLazyFrame.from_dataframe(RefDataFrame.from_pandas(pdf)), ref_col) \
            .collect(streaming=True, mesh=8).to_pandas().sort_values("flag")
    np.testing.assert_allclose(got["rev"], ref["rev"].to_numpy(), rtol=1e-9)


def test_the_result_of_a_spilling_run_is_the_callers():
    """No later spill reaches a collected result: its columns leave the
    registry, and a second run under the budget leaves the first result
    on its device."""
    df = ct.DataFrame({"k": torch.arange(6000) % 7, "v": torch.arange(6000.0)})
    lf = from_dataframe(df).with_columns((col("v") * 2.0).alias("w"))
    with option_context("spill", True, "spill.device_limit_bytes", 1024):
        first = lf.collect(mesh=6)
        lf.collect(mesh=6)
    assert not any(sp.is_spilled(c) for c in first._table.columns)
    assert torch.equal(first._table["w"].data, torch.arange(6000.0) * 2.0)


def test_the_budget_on_the_cpu_is_unbounded_unless_set():
    from cudf_tpu_torch.engine.streaming import _spill_budget

    assert _spill_budget(torch.device("cpu")) == 1 << 62
    with option_context("spill.device_limit_bytes", 123):
        assert _spill_budget(torch.device("cpu")) == 123


@pytest.mark.parametrize("how", ["broadcast", "shuffle", "cross"])
def test_a_table_spilled_while_the_executor_holds_it_comes_back(how):
    """Under a budget of a few hundred bytes every partition the executor
    produces spills at once: the broadcast side, a shuffle's key columns
    and a gathered child of a cross join are spilled while other work
    runs, and each is brought back before it is read."""
    left = ct.DataFrame({"k": torch.arange(4000) % 50, "v": torch.arange(4000.0)})
    right = ct.DataFrame({"k": torch.arange(400) % 50, "w": torch.arange(400.0)})
    lf = from_dataframe(left).filter(col("v") > 10.0).with_columns((col("v") + 1.0).alias("v1"))
    rf = from_dataframe(right).filter(col("w") < 90.0).with_columns((col("w") * 2.0).alias("w2"))
    plan = lf.filter(col("v") < 400.0).join(rf, how="cross") if how == "cross" else \
        lf.join(rf, on="k")
    exp = plan.collect().to_pandas()
    stats = sp.get_spill_manager().statistics
    before = stats.unspills
    with option_context("spill", True, "spill.device_limit_bytes", 256,
                        "executor.broadcast_limit", 0 if how == "shuffle" else 1 << 20):
        got = plan.collect(mesh=4).to_pandas()
    assert stats.unspills > before
    key = list(exp.columns)
    pd.testing.assert_frame_equal(got.sort_values(key).reset_index(drop=True),
                                  exp.sort_values(key).reset_index(drop=True))
