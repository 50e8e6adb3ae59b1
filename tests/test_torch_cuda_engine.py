"""The LazyFrame engine and the new layouts on the card: TPC-H q1, q6,
q12 and q14, dictionary ``gather``, ``binaryop`` and ``row_ops`` on CUDA
tensors against the same calls on CPU tensors.

Marked ``cuda``: without a CUDA device every test here skips (decided in
the fixture, never at import).  On a machine with a card run
``python -m pytest tests/test_torch_cuda_engine.py -q --noconftest``.
Keys, counts, masks and permutations are exact; float aggregates rtol
1e-9 (atomic adds on the card add in a varying order).  Every output
stays on the card.
"""

import numpy as np
import pytest
import torch

from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.kernels import hash_aggregate as ha
from cudf_tpu_torch.kernels import radix_partition as rp
from cudf_tpu_torch.kernels import tile_sort as ts
from cudf_tpu_torch.models import tpch
from cudf_tpu_torch.ops import binaryop, copying, row_ops
from cudf_tpu_torch.utils.config import option_context

pytestmark = pytest.mark.cuda

CPU = torch.device("cpu")
RTOL = 1e-9
KEYS = ["MAIL", "SHIP", "AIR", "TRUCK", "RAIL", "AIR"]     # out of byte order, one repeated


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _same(got, exp):
    """Two query answers (frames, or q14's float), got from the card."""
    if isinstance(exp, float):
        np.testing.assert_allclose(got, exp, rtol=RTOL)
        return
    assert got._table.names == exp._table.names and len(got) == len(exp)
    for name in exp._table.names:
        g, e = got._table[name], exp._table[name]
        assert g.device.type == "cuda" and g.dtype == e.dtype, name
        if e.dtype.is_float:
            np.testing.assert_allclose(g.data.cpu().numpy(), e.data.numpy(), rtol=RTOL)
        else:
            assert g.to_numpy().tolist() == e.to_numpy().tolist(), name


@pytest.mark.parametrize("min_rows", [None, 1])
@pytest.mark.parametrize("query", ["q1", "q6", "q12", "q14"])
def test_queries_on_the_card_match_cpu(dev, query, min_rows):
    """The same numpy tables on the card and on the CPU; with min_rows 1
    the joins take the radix tier (kernels B, F, G, D and H) on the card."""
    on_card = tpch.generate(0.01, seed=5, device=dev)
    on_cpu = tpch.generate(0.01, seed=5, device=CPU)
    with option_context("join.fast_path_min_rows", min_rows or 1 << 16):
        _same(tpch.QUERIES[query](on_card), tpch.QUERIES[query](on_cpu))


def test_q12_and_q14_launch_their_kernels(dev):
    t = tpch.generate_device(0.1, seed=3, device=dev)
    for fn in (ha.onehot_groupby_aggregate, rp.digit_histogram, ts.tile_sort_data,
               rp.merge_scatter, rp.bucket_aggregate, rp.window_probe):
        fn.launches = 0
    keys, high, low = tpch.plain_q12(t)
    with option_context("join.fast_path_min_rows", 1):
        got = tpch.q12(t)._table
    assert got["l_shipmode"].to_numpy().tolist() == keys
    assert torch.equal(got["high_line_count"].data, high)
    assert torch.equal(got["low_line_count"].data, low)
    assert ha.onehot_groupby_aggregate.launches >= 1 and rp.window_probe.launches >= 1
    with option_context("join.fast_path_min_rows", 1):
        np.testing.assert_allclose(tpch.q14(t), tpch.plain_q14(t), rtol=RTOL)


def _dictionary(device, n=5000, seed=0):
    rng = np.random.default_rng(seed)
    codes = torch.from_numpy(rng.integers(0, len(KEYS), n).astype(np.int32))
    valid = torch.from_numpy(rng.random(n) > 0.1)
    keys = Column.from_strings(KEYS, device=device)
    return Column.from_dictionary(codes.to(device), keys, valid.to(device))


def test_dictionary_gather_binaryop_and_row_ops_match_cpu(dev):
    card, cpu = _dictionary(dev), _dictionary(CPU)
    idx = torch.from_numpy(np.random.default_rng(1).integers(-5, 5005, 3000))
    g_card = copying.gather(card, idx.to(dev))
    g_cpu = copying.gather(cpu, idx)
    assert torch.equal(g_card.data.cpu(), g_cpu.data)
    assert torch.equal(g_card.validity.cpu(), g_cpu.validity)
    assert g_card.decode_dictionary().to_numpy().tolist() == g_cpu.decode_dictionary(
        ).to_numpy().tolist()
    for op in ("eq", "ne", "lt", "ge"):
        for value in ("AIR", "BOAT"):
            a, b = binaryop.binary_operation(card, value, op), binaryop.binary_operation(
                cpu, value, op)
            assert torch.equal(a.data.cpu(), b.data) and torch.equal(a.validity.cpu(), b.validity)
    assert torch.equal(row_ops.dictionary_ranks(card.keys).cpu(),
                       row_ops.dictionary_ranks(cpu.keys))
    for cols in ([card], [card, card.decode_dictionary()]):
        cpu_cols = [cpu, cpu.decode_dictionary()][:len(cols)]
        assert torch.equal(row_ops.lex_sort_indices(cols).cpu(),
                           row_ops.lex_sort_indices(cpu_cols))
    days = np.random.default_rng(2).integers(8000, 10500, 5000).astype("datetime64[D]")
    t_card = Column.from_numpy(days.astype("datetime64[ns]"), device=dev)
    t_cpu = Column.from_numpy(days.astype("datetime64[ns]"), device=CPU)
    lit = np.datetime64("1995-01-01")
    assert torch.equal(binaryop.binary_operation(t_card, lit, "lt").data.cpu(),
                       binaryop.binary_operation(t_cpu, lit, "lt").data)
    assert torch.equal(row_ops.lex_sort_indices([t_card, card]).cpu(),
                       row_ops.lex_sort_indices([t_cpu, cpu]))


UNSIGNED_BINARY = ["add", "sub", "mul", "floordiv", "mod", "pow", "bitand", "bitxor",
                   "shiftleft", "shiftright", "lt", "ge", "eq", "min", "max", "null_max"]


@pytest.mark.parametrize("dtype", ["uint16", "uint32", "uint64"])
def test_unsigned_scalar_ops_match_cpu(dev, dtype):
    """Port faults 1, 2, 5 and 6 on the card: every unsigned binary op
    (values over the whole range, small right operands where they shift,
    raise or divide, zero divisors among them), abs, negate, sign,
    bit_invert and round(-1), and the reductions; sign of NaN and abs and
    cbrt of bool."""
    from cudf_tpu_torch.ops import reductions, unary

    rng = np.random.default_rng(3)
    info = np.iinfo(dtype)
    big = rng.integers(0, int(info.max), 4000, dtype=np.uint64, endpoint=True).astype(dtype)
    small = rng.integers(0, 6, 4000).astype(dtype)
    mask = torch.from_numpy(rng.random(4000) > 0.1)

    def cols(device):
        return (Column.from_numpy(big, device=device).with_validity(mask.to(device)),
                Column.from_numpy(small, device=device))

    (a, s), (ac, sc) = cols(dev), cols(CPU)
    for op in UNSIGNED_BINARY:
        got, exp = binaryop.binary_operation(a, s, op), binaryop.binary_operation(ac, sc, op)
        assert got.dtype == exp.dtype, op
        gv = torch.ones(4000, dtype=torch.bool) if got.validity is None else got.validity.cpu()
        ev = torch.ones(4000, dtype=torch.bool) if exp.validity is None else exp.validity
        assert torch.equal(gv, ev), op
        torch.testing.assert_close(got.data.cpu()[ev], exp.data[ev], rtol=0, atol=0,
                                   equal_nan=True, msg=op)
    for op in ("abs", "negate", "sign", "bit_invert"):
        assert torch.equal(unary.unary_operation(a, op).data.cpu(),
                           unary.unary_operation(ac, op).data), op
    assert torch.equal(unary.round(a, -1).data.cpu(), unary.round(ac, -1).data)
    for fn in ("min", "max", "sum", "argmin", "argmax", "product"):
        assert getattr(reductions, fn)(a) == getattr(reductions, fn)(ac), fn
    for fn in ("mean", "var", "skew"):
        np.testing.assert_allclose(getattr(reductions, fn)(a), getattr(reductions, fn)(ac),
                                   rtol=RTOL)
    f = np.array([np.nan, -2.5, 0.0, 3.0])
    assert np.array_equal(unary.unary_operation(Column.from_numpy(f, device=dev), "sign")
                          .data.cpu().numpy(), np.sign(f), equal_nan=True)
    b = Column.from_numpy(np.array([True, False, True]), device=dev)
    for op in ("abs", "cbrt"):
        assert unary.unary_operation(b, op) is b


def test_temporal_group_aggregations_match_cpu(dev):
    """Port fault 4 on the card: group mean / median / std of timestamps
    as timestamps and a duration, as on the CPU (mean and std to rtol
    1e-12: their float64 sums add in another order on the card)."""
    import cudf_tpu_torch as ct

    rng = np.random.default_rng(4)
    ticks = rng.integers(0, 10**17, 5000).astype("datetime64[ns]")
    keys = rng.integers(0, 40, 5000)
    for agg in ("mean", "median", "std", "min", "max"):
        got = ct.DataFrame({"k": keys, "t": ticks}, device=dev).groupby("k").agg({"t": agg})
        exp = ct.DataFrame({"k": keys, "t": ticks}, device=CPU).groupby("k").agg({"t": agg})
        g, e = got._table["t"], exp._table["t"]
        assert g.dtype == e.dtype, agg
        if agg in ("mean", "std"):     # float64 sums of ~1e17 ticks, atomic order on the card
            np.testing.assert_allclose(g.data.cpu().double().numpy(), e.data.double().numpy(),
                                       rtol=1e-12, err_msg=agg)
        else:
            assert torch.equal(g.data.cpu(), e.data), agg
