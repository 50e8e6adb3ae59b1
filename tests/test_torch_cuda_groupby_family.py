"""The rest of the groupby family on the card: sum_of_squares, m2, the
bitwise aggregations, cov, corr and ewma, the kernel-tier transform, the
frame layer's methods (SeriesGroupBy, rank, describe, cov/corr, ngroup,
filter, apply, transform, ewm, iteration) and the ten G1 questions, on
CUDA tensors against the same calls on CPU tensors.

Marked ``cuda``: without a CUDA device every test here skips (decided in
the fixture, never at import).  On a machine with a card run
``python -m pytest tests/test_torch_cuda_groupby_family.py -q --noconftest``.
Group ids, keys, counts, ranks and integer and bitwise results are exact;
float sums, cov, corr, std and ewm rtol 1e-9 (atomic adds on the card
add in a varying order), and results of a float32 column rtol 1e-6 (one
float32 ulp of a value rounded from float64).  Every output must stay on
the card.
"""

import numpy as np
import pytest
import torch

import cudf_tpu_torch as ct
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.frame.index import MultiIndex, RangeIndex
from cudf_tpu_torch.kernels import hash_aggregate as ha
from cudf_tpu_torch.kernels import radix_partition as rp
from cudf_tpu_torch.models import g1
from cudf_tpu_torch.ops import groupby as gb
from cudf_tpu_torch.utils.config import option_context

pytestmark = pytest.mark.cuda

CPU = torch.device("cpu")
RTOL = 1e-9
# the statistics of the float32 column g are float32, rounded once from
# float64 sums whose last bits differ between devices: one float32 ulp
F32_RTOL = 1e-6
F32_CALLS = ("transform_mean", "describe")
INTS = [np.int8, np.int16, np.int32, np.int64, np.uint8, np.uint16, np.uint32, np.uint64,
        np.bool_]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _col(x, valid, device):
    return ct.from_buffers(x.dtype, x.shape[0], x, valid, device=device)


def _same_col(got, exp, what, rtol=RTOL):
    assert got.device.type == "cuda", what
    assert got.dtype == exp.dtype, what
    g, e = got.data.cpu(), exp.data
    if got.validity is not None or exp.validity is not None:
        gv = got.validity.cpu() if got.validity is not None else torch.ones(got.length,
                                                                             dtype=torch.bool)
        ev = exp.validity if exp.validity is not None else torch.ones(exp.length,
                                                                      dtype=torch.bool)
        assert torch.equal(gv, ev), what
        g, e = g[ev], e[ev]
    if g.is_floating_point():
        assert torch.allclose(g.double(), e.double(), rtol=rtol, atol=1e-12,
                              equal_nan=True), what
    else:
        assert torch.equal(g.view(torch.uint8), e.view(torch.uint8)), what


def _same_index(got, exp, what):
    if isinstance(exp, RangeIndex):
        assert isinstance(got, RangeIndex) and got.to_pylist() == exp.to_pylist(), what
    elif isinstance(exp, MultiIndex):
        for a, b in zip(got._columns, exp._columns):
            _same_col(a, b, what)
    elif hasattr(exp, "_column"):
        _same_col(got.column(), exp.column(), what)
    else:
        assert got.to_pylist() == exp.to_pylist(), what


def _same(got, exp, what, rtol=RTOL):
    """Two frames, Series or scalars: the card's against the CPU's."""
    if isinstance(exp, ct.DataFrame):
        assert got.columns == exp.columns, what
        for n in exp.columns:
            _same_col(got._table[n], exp._table[n], f"{what} {n}", rtol)
        _same_index(got.index, exp.index, what)
    elif isinstance(exp, ct.Series):
        _same_col(got._column, exp._column, what, rtol)
        _same_index(got.index, exp.index, what)
    else:
        assert np.isclose(got, exp, rtol=rtol, equal_nan=True), what


def _frame(rng, n, device, keys=50):
    k = rng.integers(0, keys, n).astype(np.int32)
    f = rng.normal(size=n) + 1e8
    return ct.DataFrame({
        "k": _col(k, rng.random(n) > 0.02, device),
        "j": _col(rng.integers(0, 3, n).astype(np.int64), None, device),
        "v": _col(rng.integers(1, 6, n).astype(np.int32), None, device),
        "f": _col(f, rng.random(n) > 0.1, device),
        "g": _col(rng.normal(size=n).astype(np.float32), None, device),
    })


@pytest.mark.parametrize("dtype", INTS + [np.float32, np.float64],
                         ids=lambda d: np.dtype(d).name)
def test_new_aggregations_equal_cpu(dev, dtype):
    rng = np.random.default_rng(1)
    n = 200_000
    key = (rng.integers(0, 1000, n).astype(np.int64), rng.random(n) > 0.02)
    x = (rng.random(n) > 0.5) if dtype == np.bool_ else \
        rng.integers(0, 100, n).astype(dtype)
    v = rng.random(n) > 0.1
    g_dev, g_cpu = gb.make_grouper([_col(*key, dev)]), gb.make_grouper([_col(*key, CPU)])
    aggs = ["sum_of_squares", "m2"] if np.dtype(dtype).kind != "b" else []
    if np.dtype(dtype).kind in "iub":
        aggs += ["bitwise_and", "bitwise_or", "bitwise_xor"]
    for agg in aggs:
        _same_col(gb.aggregate(_col(x, v, dev), g_dev, agg),
                  gb.aggregate(_col(x, v, CPU), g_cpu, agg), agg)


def test_cov_corr_ewma_equal_cpu(dev):
    rng = np.random.default_rng(2)
    n = 300_000
    key = rng.integers(0, 500, n).astype(np.int32)
    x, y = rng.normal(size=n) + 1e8, rng.normal(size=n)
    vx, vy = rng.random(n) > 0.1, rng.random(n) > 0.05
    g_dev, g_cpu = gb.make_grouper([_col(key, None, dev)]), gb.make_grouper([_col(key, None, CPU)])
    for ddof in (0, 1):
        _same_col(gb.group_cov(_col(x, vx, dev), _col(y, vy, dev), g_dev, ddof),
                  gb.group_cov(_col(x, vx, CPU), _col(y, vy, CPU), g_cpu, ddof), "cov")
    _same_col(gb.group_corr(_col(x, vx, dev), _col(y, vy, dev), g_dev),
              gb.group_corr(_col(x, vx, CPU), _col(y, vy, CPU), g_cpu), "corr")
    for adjust in (True, False):
        for ignore_na in (True, False):
            _same_col(gb.group_ewma(_col(y, vx, dev), g_dev, 0.2, adjust, ignore_na),
                      gb.group_ewma(_col(y, vx, CPU), g_cpu, 0.2, adjust, ignore_na),
                      f"ewma {adjust} {ignore_na}")


@pytest.mark.parametrize("K", [100, 5000, 1 << 20])
@pytest.mark.parametrize("agg", ["sum", "count", "mean", "min", "max", "size"])
def test_kernel_tier_transform_equals_sort_tier(dev, K, agg):
    """transform_kernel_tier launches the kernel tiers (A at K <= 4096, B,
    F, G and D above) and equals the sort tier's broadcast on the card."""
    rng = np.random.default_rng(3)
    n = 1 << 21
    key = _col(rng.integers(0, K, n).astype(np.int32), rng.random(n) > 0.01, dev)
    vals = _col(rng.integers(-50, 50, n).astype(np.int32), rng.random(n) > 0.1, dev)
    ha.onehot_groupby_aggregate.launches = rp.bucket_aggregate.launches = 0
    got = gb.transform_kernel_tier(key, [("x", vals, agg)])["x"]
    launched = ha.onehot_groupby_aggregate.launches if K <= 4096 else rp.bucket_aggregate.launches
    assert launched > 0
    g = gb.make_grouper([key])
    spread = gb.copying.gather(gb.aggregate(vals, g, agg), g.group_ids, bounds_check=False)
    rows = g.frame_rows(torch.arange(g.group_ids.shape[0], device=dev))
    data = torch.zeros(n, dtype=spread.data.dtype, device=dev)
    data[rows] = spread.data
    valid = torch.zeros(n, dtype=torch.bool, device=dev)
    valid[rows] = spread.validity if spread.validity is not None else True
    _same_col(got, Column(spread.dtype, n, data.cpu(), valid.cpu()), agg)


def _both(rng_seed, n):
    a = _frame(np.random.default_rng(rng_seed), n, CPU)
    b = _frame(np.random.default_rng(rng_seed), n, torch.device("cuda"))
    return a, b


@pytest.mark.parametrize("sort", [True, False])
def test_frame_methods_equal_cpu(dev, sort):
    cpu, card = _both(4, 100_000)
    calls = {
        "series_sum": lambda d: d.groupby("k", sort=sort)["f"].sum(),
        "series_agg_list": lambda d: d.groupby("k", sort=sort)["f"].agg(["sum", "std"]),
        "transform_mean": lambda d: d.groupby("k", sort=sort)[["f", "g"]].transform("mean"),
        "transform_std": lambda d: d.groupby(["k", "j"], sort=sort)["f"].transform("std"),
        "rank_average": lambda d: d.groupby("k", sort=sort)["v"].rank(),
        "rank_dense_pct": lambda d: d.groupby("k", sort=sort)["f"].rank("dense", pct=True),
        "rank_min_desc": lambda d: d.groupby("k", sort=sort)["v"].rank("min",
                                                                        ascending=False),
        "describe": lambda d: d.groupby("k", sort=sort)[["f", "g"]].describe(),
        "corr": lambda d: d.groupby("k", sort=sort)[["f", "g", "v"]].corr(),
        "cov": lambda d: d.groupby("j", sort=sort)[["f", "g"]].cov(ddof=0),
        "ngroup": lambda d: d.groupby(["k", "j"], sort=sort, dropna=False).ngroup(),
        "filter": lambda d: d.groupby("j", sort=sort).filter(lambda g: len(g) > 33_300),
        "apply_scalar": lambda d: d.groupby("j", sort=sort).apply(lambda g: g["f"].sum()),
        "apply_frame": lambda d: d.groupby("j", sort=sort).apply(lambda g: g.head(3)),
        "transform_callable": lambda d: d.groupby("j", sort=sort)["f"].transform(
            lambda s: s.cumsum()),
        "ewm": lambda d: d.groupby("k", sort=sort)["f"].ewm(span=5).mean(),
        "get_group": lambda d: d.groupby("k", sort=sort).get_group(7),
        "cumsum": lambda d: d.groupby("k", sort=sort)["v"].cumsum(),
        "series_corr": lambda d: d["f"].corr(d["g"]),
        "series_cov": lambda d: d["f"].cov(d["g"], ddof=0),
        "autocorr": lambda d: d["g"].autocorr(3),
        "frame_corr": lambda d: d[["f", "g", "v"]].corr(),
        "frame_describe": lambda d: d[["f", "g", "v"]].describe(),
        "series_groupby": lambda d: d["f"].groupby(d["k"], sort=sort).mean(),
    }
    for name, fn in calls.items():
        _same(fn(card), fn(cpu), name, F32_RTOL if name in F32_CALLS else RTOL)
    keys_cpu = [k for k, _ in cpu.groupby("j", sort=sort)]
    keys_card = [k for k, _ in card.groupby("j", sort=sort)]
    assert keys_cpu == keys_card


def _g1(n, device, seed=5):
    rng = np.random.default_rng(seed)
    k = 100

    def cat(codes, keys):
        return Column.from_dictionary(torch.from_numpy(codes.astype(np.int32)).to(device),
                                      Column.from_strings(keys, device=device))

    ids = [f"id{i:03d}" for i in range(1, k + 1)]
    return ct.DataFrame({
        "id1": cat(rng.integers(0, k, n), ids), "id2": cat(rng.integers(0, k, n), ids),
        "id3": cat(rng.integers(0, n // k, n), [f"id{i:010d}" for i in range(1, n // k + 1)]),
        "id4": torch.from_numpy(rng.integers(1, k + 1, n).astype(np.int32)).to(device),
        "id5": torch.from_numpy(rng.integers(1, k + 1, n).astype(np.int32)).to(device),
        "id6": torch.from_numpy(rng.integers(1, n // k + 1, n).astype(np.int32)).to(device),
        "v1": torch.from_numpy(rng.integers(1, 6, n).astype(np.int32)).to(device),
        "v2": torch.from_numpy(rng.integers(1, 16, n).astype(np.int32)).to(device),
        "v3": torch.from_numpy(rng.uniform(0, 100, n)).to(device),
    })


@pytest.mark.parametrize("q", list(g1.QUESTIONS))
def test_g1_questions_equal_cpu(dev, q):
    n = 2_000_000
    with option_context("groupby.fast_path_min_rows", 0):
        _same(g1.QUESTIONS[q](_g1(n, dev)), g1.QUESTIONS[q](_g1(n, CPU)), q)
