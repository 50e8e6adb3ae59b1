"""The frame API on the card: ``Series.apply`` and a row ``apply`` on the
vmap route, ``map`` of a dict, the ``pivot_table`` / ``crosstab`` /
``unstack`` grid, ``melt``, ``concat``, ``cut`` and ``interpolate`` on
CUDA tensors against the same calls on CPU tensors, and ``join(on=...)``
launching the kernels the same ``merge`` launches.

Marked ``cuda``: without a CUDA device every test here skips (decided in
the fixture, never at import).  On a machine with a card run
``python -m pytest tests/test_torch_cuda_frame_api.py -q --noconftest``.
Keys, counts, codes and validity exact; float sums and means rtol 1e-9
(atomic adds on the card add in a varying order).  Every output must stay
on the card.
"""

import pytest
import torch

import cudf_tpu_torch as ct
from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.frame.series import UDF_ROUTES
from cudf_tpu_torch.kernels import hash_aggregate as ha
from cudf_tpu_torch.kernels import radix_partition as rp
from cudf_tpu_torch.kernels import tile_sort as ts
from cudf_tpu_torch.utils.config import option_context

pytestmark = pytest.mark.cuda

CPU = torch.device("cpu")
RTOL = 1e-9
N = 200_000
WRAPPERS = [ha.onehot_groupby_aggregate, rp.digit_histogram, rp.radix_scatter,
            ts.tile_sort_data, rp.merge_scatter, rp.bucket_aggregate, rp.window_probe]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _frame(device):
    g = torch.Generator().manual_seed(3)
    n = N
    v = torch.rand(n, generator=g, dtype=torch.float64) * 100
    valid = torch.rand(n, generator=g) >= 0.05
    data = {"k": torch.randint(1, 41, (n,), generator=g, dtype=torch.int32),
            "c": torch.randint(1, 31, (n,), generator=g, dtype=torch.int32),
            "w": torch.randint(-50, 50, (n,), generator=g, dtype=torch.int32),
            "v": Column(dt.FLOAT64, n, v, valid)}
    return ct.DataFrame({k: (x.to(device) if isinstance(x, torch.Tensor) else
                             Column(x.dtype, n, x.data.to(device), x.validity.to(device)))
                         for k, x in data.items()})


def _same(got, exp, what, rtol=0.0):
    """Two port results (frames, Series or columns) equal: names, index,
    values and validity; floats at rtol."""
    if isinstance(exp, ct.DataFrame):
        assert list(got._table.names) == list(exp._table.names), what
        _same_index(got.index, exp.index, what)
        for name in exp._table.names:
            _same_col(got._table[name], exp._table[name], f"{what} {name}", rtol)
    else:
        _same_index(got.index, exp.index, what)
        _same_col(got._column, exp._column, what, rtol)


def _same_index(got, exp, what):
    levels = (lambda i: i._columns if hasattr(i, "_columns") else (i.column(CPU),))
    for a, b in zip(levels(got), levels(exp)):
        _same_col(a, b, f"{what} index", 0.0, on_card=False)


def _same_col(got, exp, what, rtol, on_card=True):
    if on_card:
        assert got.device.type == "cuda", what
    assert got.dtype == exp.dtype, what
    gv = got.validity.cpu() if got.validity is not None else None
    ev = exp.validity
    if gv is not None or ev is not None:
        ones = torch.ones(exp.length, dtype=torch.bool)
        gv, ev = (ones if gv is None else gv), (ones if ev is None else ev)
        assert torch.equal(gv, ev), what
    g, e = got.data.cpu(), exp.data
    if gv is not None:
        g, e = g[gv], e[ev]
    if g.is_floating_point():
        assert torch.allclose(g, e, rtol=rtol, atol=0.0, equal_nan=True), what
    else:
        assert torch.equal(g, e), what


def _routes(fn):
    before = dict(UDF_ROUTES)
    out = fn()
    return out, {k: UDF_ROUTES[k] - before[k] for k in before}


def test_udfs_take_the_vmap_route_on_the_card(dev):
    gpu, cpu = _frame(dev), _frame(CPU)
    for fn in (lambda x: x * 2.0 + 1.0, lambda x: x - 3, lambda x: 7.0):
        for col in ("w", "v"):
            got, took = _routes(lambda: gpu[col].apply(fn))
            assert took == {"vmap": 1, "host": 0}
            _same(got, cpu[col].apply(fn), f"apply {col}")
    masked = lambda m: (m * 2.0 + 1.0).fillna(-1.0)        # noqa: E731
    _same(gpu["v"].apply(masked, masked=True), cpu["v"].apply(masked, masked=True), "masked")
    row = lambda r: r["k"] * r["v"] + r["w"]               # noqa: E731
    got, took = _routes(lambda: gpu.apply(row, axis=1, engine="torch"))
    assert took == {"vmap": 1, "host": 0}
    _same(got, cpu.apply(row, axis=1, engine="torch"), "row apply")
    mapper = {k: 1000 + k for k in range(1, 41, 2)}
    _same(gpu["k"].map(mapper), cpu["k"].map(mapper), "map")


def test_grids_and_reshapes_match_the_cpu(dev):
    gpu, cpu = _frame(dev), _frame(CPU)
    cases = {
        "pivot_mean": lambda d: ct.pivot_table(d, values="v", index="k", columns="c",
                                               aggfunc="mean"),
        "pivot_sums": lambda d: ct.pivot_table(d, values=["w", "v"], index="k", aggfunc="sum"),
        "crosstab": lambda d: ct.crosstab(d["k"], d["c"]),
        "unstack": lambda d: d.groupby(["k", "c"])["w"].sum().unstack(fill_value=0),
        "melt": lambda d: ct.melt(d, id_vars="k", value_vars=["w", "v"]),
        "concat": lambda d: ct.concat([d.iloc[:N // 3], d.iloc[N // 3:]]),
        "cut": lambda d: ct.cut(d["v"], 7),
        "qcut": lambda d: ct.qcut(d["v"], 4, labels=False),
        "interpolate": lambda d: d["v"].interpolate(),
        "combine_first": lambda d: d["v"].combine_first(d["w"]),
        "row_max": lambda d: d.max(axis=1),
        "quantiles": lambda d: d.quantile([0.1, 0.5, 0.9]),
    }
    for name, fn in cases.items():
        got, exp = fn(gpu), fn(cpu)
        _same(got, exp, name, RTOL)
        if name == "pivot_mean":
            assert got._columns_names == exp._columns_names == ("c",)


def test_join_on_launches_what_merge_launches(dev):
    """``join(on=...)`` and an index join take the same gather maps as
    ``merge`` on the kernel tiers (radix partition, build, probe), with the
    caller's index labels."""
    g = torch.Generator().manual_seed(11)
    n, m = 1 << 20, 1 << 17
    fact = ct.DataFrame({"id": torch.randint(1, m + m // 10, (n,), generator=g,
                                             dtype=torch.int32).to(dev),
                         "v1": torch.rand(n, generator=g, dtype=torch.float64).to(dev)})
    dim = ct.DataFrame({"id": (torch.randperm(m, generator=g, dtype=torch.int32) + 1).to(dev),
                        "v2": torch.rand(m, generator=g, dtype=torch.float64).to(dev)})

    def launched(fn):
        for w in WRAPPERS:
            w.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {w.__name__: w.launches for w in WRAPPERS if w.launches}

    with option_context("join.fast_path_min_rows", 0):
        merged, by_merge = launched(lambda: fact.merge(dim, on="id"))
        joined, by_join = launched(lambda: fact.join(dim.set_index("id"), on="id", how="inner"))
        indexed, by_index = launched(lambda: fact.set_index("id").join(dim.set_index("id"),
                                                                       how="inner"))
    assert by_merge and by_join == by_merge == by_index, (by_merge, by_join, by_index)
    for name in ("id", "v1", "v2"):
        assert torch.equal(joined._table[name].data, merged._table[name].data), name
    assert torch.equal(indexed.index.column().data, merged._table["id"].data)
    cpu = fact._table["id"].data.cpu()
    rows = joined.index.column().data.cpu()
    assert torch.equal(cpu[rows], joined._table["id"].data.cpu())
