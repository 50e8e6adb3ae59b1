"""The sort tier on the card: row operators, the grouper, every sort-tier
aggregation, ``sort_values`` and G1 q6's and q8's call forms on CUDA
tensors against the same calls on CPU tensors.

Marked ``cuda``: without a CUDA device every test here skips (decided in
the fixture, never at import).  On a machine with a card run
``python -m pytest tests/test_torch_cuda_sort.py -q --noconftest``.
Permutations, group ids, integer, bool and row results are exact; float
sums, means, variances and standard deviations rtol 1e-12, since atomic
adds on the card add in a varying order.  Every output must stay on the
card.
"""

import numpy as np
import pytest
import torch

import cudf_tpu_torch as ct
from cudf_tpu_torch.ops import groupby as gb
from cudf_tpu_torch.ops import row_ops

pytestmark = pytest.mark.cuda

CPU = torch.device("cpu")
AGGS = ["sum", "count", "size", "mean", "min", "max", "var", "std", "prod", "any", "all",
        "first", "last", "nunique", "median", "quantile", "idxmin", "idxmax"]
DTYPES = [np.int8, np.int16, np.int32, np.int64, np.uint8, np.uint16, np.uint32, np.uint64,
          np.float32, np.float64, np.bool_]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _col(x, valid, device):
    return ct.from_buffers(x.dtype, x.shape[0], x, valid, device=device)


def _values(rng, dtype, n, distinct=50):
    dtype = np.dtype(dtype)
    if dtype == np.bool_:
        return rng.random(n) > 0.5
    x = rng.integers(0, distinct, n).astype(dtype)
    if dtype.kind == "f":
        x[::97] = np.nan
        x[1::89] = -0.0
    return x


def _same_col(got, exp, what, float_rtol=1e-12):
    assert got.device.type == "cuda", what
    assert got.dtype == exp.dtype, what
    g, e = got.data.cpu(), exp.data
    if got.validity is not None or exp.validity is not None:
        gv = got.validity.cpu() if got.validity is not None else torch.ones_like(e, dtype=torch.bool)
        ev = exp.validity if exp.validity is not None else torch.ones_like(e, dtype=torch.bool)
        assert torch.equal(gv, ev), what
        g, e = g[ev], e[ev]
    if g.is_floating_point():
        assert torch.allclose(g.double(), e.double(), rtol=float_rtol, atol=0,
                              equal_nan=True), what
    else:
        assert torch.equal(g.view(torch.uint8), e.view(torch.uint8)), what


@pytest.mark.parametrize("na_position", ["first", "last"])
def test_lex_sort_indices_equal_cpu(dev, na_position):
    rng = np.random.default_rng(1)
    n = 1 << 20
    cols = [(_values(rng, np.int32, n, 7), rng.random(n) > 0.1),
            (_values(rng, np.float64, n, 100), None),
            (_values(rng, np.uint64, n, 5), rng.random(n) > 0.3)]
    for asc in ([True, True, True], [False, True, False]):
        got = row_ops.lex_sort_indices([_col(x, v, dev) for x, v in cols], asc, na_position)
        exp = row_ops.lex_sort_indices([_col(x, v, CPU) for x, v in cols], asc, na_position)
        assert got.device.type == "cuda" and torch.equal(got.cpu(), exp)
    for x, v in cols:
        got = row_ops.row_hash([_col(x, v, dev)])
        assert torch.equal(got.cpu(), row_ops.row_hash([_col(x, v, CPU)]))


@pytest.mark.parametrize("dropna", [True, False])
def test_make_grouper_equals_cpu(dev, dropna):
    rng = np.random.default_rng(2)
    n = 1 << 20
    keys = [(_values(rng, np.int32, n, 100), rng.random(n) > 0.05),
            (_values(rng, np.float32, n, 10), None)]
    got = gb.make_grouper([_col(x, v, dev) for x, v in keys], dropna=dropna)
    exp = gb.make_grouper([_col(x, v, CPU) for x, v in keys], dropna=dropna)
    assert got.num_groups == exp.num_groups
    for field in ("group_ids", "key_rows", "sorted_order", "group_offsets", "kept_rows",
                  "row_mask", "sorted_group_ids"):
        g, e = getattr(got, field), getattr(exp, field)
        assert (g is None) == (e is None), field
        if g is not None:
            assert g.device.type == "cuda" and torch.equal(g.cpu(), e), field


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_every_agg_equals_cpu(dev, dtype):
    """Each sort-tier agg of each value dtype: the card's scatter_reduce_,
    index_add_ and sorts give the CPU's results."""
    rng = np.random.default_rng(3)
    n = 200_000
    key = (rng.integers(0, 1000, n).astype(np.int64), rng.random(n) > 0.02)
    x, v = _values(rng, dtype, n), rng.random(n) > 0.1
    g_dev = gb.make_grouper([_col(*key, dev)])
    g_cpu = gb.make_grouper([_col(*key, CPU)])
    for agg in AGGS:
        if agg == "quantile" and dtype == np.bool_:
            continue
        got = gb.aggregate(_col(x, v, dev), g_dev, agg)
        exp = gb.aggregate(_col(x, v, CPU), g_cpu, agg)
        _same_col(got, exp, f"{agg} {np.dtype(dtype).name}",
                  float_rtol=1e-12 if dtype != np.float32 else 1e-6)
    for fn in (gb.group_cumsum, lambda c, g: gb.group_shift(c, g, 2)):
        _same_col(fn(_col(x, v, dev), g_dev), fn(_col(x, v, CPU), g_cpu),
                  f"scan {np.dtype(dtype).name}")
    _same_col(gb.group_cumcount(g_dev), gb.group_cumcount(g_cpu), "cumcount")


def _g1(dev, n, seed):
    rng = np.random.default_rng(seed)
    cols = {"id4": rng.integers(1, 101, n).astype(np.int32),
            "id5": rng.integers(1, 101, n).astype(np.int32),
            "id6": rng.integers(1, n // 100 + 1, n).astype(np.int32),
            "v3": rng.uniform(0, 100, n)}
    return ct.DataFrame({k: torch.from_numpy(v).to(dev) for k, v in cols.items()})


def _frames_equal(got, exp, float_rtol=1e-12):
    assert list(got._table.names) == list(exp._table.names)
    for name in exp._table.names:
        _same_col(got._table[name], exp._table[name], name, float_rtol)


def test_g1_q6_q8_and_sort_values_equal_cpu(dev):
    """q6 and q8 in db-benchmark's pandas forms at 1e6 rows, and
    sort_values, on the card and on the CPU: the same frames (q8's rows
    and index labels exactly)."""
    n = 1_000_000
    df_dev, df_cpu = _g1(dev, n, 4), _g1(CPU, n, 4)
    q6 = dict(as_index=False, sort=False, observed=True, dropna=False)
    spec = {"v3": ["median", "std"]}
    _frames_equal(df_dev.groupby(["id4", "id5"], **q6).agg(spec),
                  df_cpu.groupby(["id4", "id5"], **q6).agg(spec))

    def q8(df):
        return df[["id6", "v3"]].sort_values("v3", ascending=False).groupby(
            "id6", sort=False, dropna=False).head(2)

    got, exp = q8(df_dev), q8(df_cpu)
    _frames_equal(got, exp, float_rtol=0)
    assert torch.equal(got.index.column().data.cpu(), exp.index.column().data)
    for by, asc in (("v3", True), (["id4", "v3"], [False, True])):
        got, exp = df_dev.sort_values(by, ascending=asc), df_cpu.sort_values(by, ascending=asc)
        _frames_equal(got, exp, float_rtol=0)
        assert torch.equal(got.index.column().data.cpu(), exp.index.column().data)
