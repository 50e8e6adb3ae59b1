"""The LazyFrame engine and the new layouts on the card: TPC-H q1, q6,
q12 and q14, dictionary ``gather``, ``binaryop`` and ``row_ops`` on CUDA
tensors against the same calls on CPU tensors; and the pandas API slice:
the nine TPC-H queries in pandas' API, the scan, copying, replace and
dictionary primitives, Series and DataFrame methods and ``Over``.

Marked ``cuda``: without a CUDA device every test here skips (decided in
the fixture, never at import).  On a machine with a card run
``python -m pytest tests/test_torch_cuda_engine.py -q --noconftest``.
Keys, counts, masks and permutations are exact; float aggregates rtol
1e-9 (atomic adds on the card add in a varying order).  Every output
stays on the card.
"""

import datetime

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


# ----------------------------------------------------------------------
# the pandas API slice: TPC-H's pandas form, the column primitives,
# Series and DataFrame methods and Over, on the card against the CPU
# ----------------------------------------------------------------------

def _values(col: Column):
    """A column's rows as host values (nulls NaN or None), no pandas: the
    card's machine has none."""
    return col.to_numpy().tolist()


def _host_of(x):
    """A result (Column, Series, DataFrame, Index, tensor, tuple, scalar) as
    host values."""
    import cudf_tpu_torch as ct

    if isinstance(x, Column):
        return ("column", str(x.dtype), _values(x))
    if isinstance(x, ct.Series):
        return ("series", x.name, x.index.to_pylist(), _values(x._column))
    if isinstance(x, ct.DataFrame):
        return ("frame", list(x._table.names), x.index.to_pylist(),
                tuple(_values(c) for c in x._table.columns))
    if isinstance(x, ct.Index):
        return ("index", x.to_pylist())
    if isinstance(x, torch.Tensor):
        return ("tensor", x.cpu().numpy().tolist())
    if isinstance(x, (tuple, list)):
        return tuple(_host_of(v) for v in x)
    if isinstance(x, np.ndarray):
        return ("array", x.tolist())
    return x


def _assert_host_equal(got, exp):
    """Equal host values: floats rtol 1e-9 (NaN equal to NaN), the rest exact."""
    if isinstance(exp, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(exp), (got, exp)
        flat = all(v is None or isinstance(v, (int, float)) for v in exp)
        if flat and any(isinstance(v, float) for v in exp):
            np.testing.assert_allclose(np.asarray(got, dtype=float),
                                       np.asarray(exp, dtype=float), rtol=RTOL)
            return
        for g, e in zip(got, exp):
            _assert_host_equal(g, e)
    elif isinstance(exp, float):
        np.testing.assert_allclose(got, exp, rtol=RTOL)
    else:
        assert got == exp or (got != got and exp != exp), (got, exp)


def _columns(device):
    """The same seeded columns on ``device``: int32 and float64 with nulls
    (5000 rows: more than one 4096-row scan block), strings, a dictionary."""
    rng = np.random.default_rng(9)
    n = 5000
    valid = torch.from_numpy(rng.random(n) > 0.1).to(device)
    from cudf_tpu_torch.core import dtypes as dt

    return {
        "i32": Column(dt.INT32, n, torch.from_numpy(rng.integers(-9, 9, n).astype(np.int32))
                      .to(device), valid),
        "f64": Column(dt.FLOAT64, n, torch.from_numpy(rng.normal(1, 0.1, n)).to(device), valid),
        "str": Column.from_strings([str(v) for v in rng.choice(["a", "bb", "ccc"], 300)],
                                   device=device),
        "dict": tpch._encoded(rng.choice(["MAIL", "SHIP", "AIR"], 300), device),
    }


def _primitive_cases():
    from cudf_tpu_torch.ops import dictionary, replace, scan
    from cudf_tpu_torch.ops import stream_compaction as sc

    def idx(c, *rows):
        return torch.tensor(rows, device=c.device)

    other = {"dict": lambda d: tpch._encoded(["ZIP", "AIR"] * 10, d)}
    return {
        "cumsum": lambda c: scan.cumsum(c["f64"]),
        "cumprod": lambda c: scan.cumprod(copying.slice(c["f64"], 0, 50)),
        "cummin": lambda c: scan.cummin(c["i32"]),
        "cummax": lambda c: scan.cummax(c["f64"]),
        "cumcount": lambda c: scan.cumcount(c["i32"]),
        "ewm_mean": lambda c: (scan.ewm_mean(c["f64"], 0.2), scan.ewm_mean(c["f64"], 0.2, False)),
        "shift": lambda c: (copying.shift(c["i32"], 3), copying.shift(c["f64"], -2, 0.5),
                            copying.shift(c["str"], 1)),
        "repeat_tile_interleave": lambda c: (
            copying.repeat(c["str"], 2), copying.repeat(c["i32"], torch.arange(
                5000, device=c["i32"].device) % 3), copying.tile(c["dict"], 2),
            copying.interleave_columns([c["i32"], c["i32"]]),
            copying.get_element(c["f64"], 7), copying.get_element(c["dict"], 3)),
        "scatter_scalar": lambda c: (copying.scatter_scalar(4, idx(c["i32"], 0, 9), c["i32"]),
                                     copying.scatter_scalar("ZIP", idx(c["dict"], 1),
                                                            c["dict"])),
        "ffill_bfill": lambda c: (replace.ffill(c["f64"]), replace.bfill(c["i32"], 1)),
        "replace": lambda c: (
            replace.replace_values(c["i32"], Column.from_pylist([1, 2], device=c["i32"].device),
                                   Column.from_pylist([10, 20], device=c["i32"].device)),
            replace.replace_where(c["f64"], c["f64"].data > 1.0, 0.0),
            replace.clamp(c["f64"], 0.9, 1.1)),
        "dictionary": lambda c: (
            dictionary.encode(c["str"]), dictionary.factorize(c["i32"], sort=False),
            dictionary.match_dictionaries(c["dict"], other["dict"](c["dict"].device)),
            dictionary.set_keys(c["dict"], Column.from_strings(["AIR", "ZIP"],
                                                               device=c["dict"].device)),
            copying.concatenate([c["dict"], other["dict"](c["dict"].device)])),
        "approx_distinct_count": lambda c: (sc.approx_distinct_count(c["i32"]),
                                            sc.approx_distinct_count(c["str"])),
    }


@pytest.mark.parametrize("name", sorted(_primitive_cases()))
def test_column_primitives_on_the_card_match_cpu(dev, name):
    fn = _primitive_cases()[name]
    _assert_host_equal(_host_of(fn(_columns(dev))), _host_of(fn(_columns(CPU))))


def _method_cases():
    return {
        "arith_align": lambda s, g, df: (1 - s) * g + s.sort_values(),
        "compare_logic": lambda s, g, df: ((s > 1.0) & (g < 0.5)) | ~(s < 0.9),
        "missing": lambda s, g, df: (s.isna(), s.fillna(0.0), s.ffill(), s.bfill(), s.dropna()),
        "scans": lambda s, g, df: (s.cumsum(), s.cummax(), s.shift(2), s.diff()),
        "reductions": lambda s, g, df: (s.sum(), s.mean(), s.min(), s.max(), s.std(), s.count(),
                                        s.nunique(), s.quantile(0.3), s.idxmax()),
        "order_sets": lambda s, g, df: (s.rank(), s.nlargest(3), s.value_counts().head(5),
                                        s.isin([1.0]), s.drop_duplicates().head(5),
                                        s.astype("category").astype("float64")),
        "indexing": lambda s, g, df: (s.iloc[3:9], s.loc[[4, 2]], s[s > 1.0].head(),
                                      s.iloc[5], s.where(s > 1.0, 0.0), s.clip(0.9, 1.1)),
        "frame_ops": lambda s, g, df: (
            df.assign(h=df.a * (1 - df.b)), df[df.a > 0].reset_index(), df.dropna(),
            df.fillna({"b": 0.0}), df.sort_values(["a", "b"]), df.sum(),
            df.groupby("a").agg(m=("b", "mean"), n=("b", "count")), df.loc[3:6],
            df.nlargest(4, "b")),
    }


def _method_inputs(device):
    import cudf_tpu_torch as ct

    cols = _columns(device)
    s = ct.Series._from(cols["f64"], ct.RangeIndex(5000), "s")
    g = ct.Series(torch.from_numpy(np.random.default_rng(2).normal(size=5000)).to(device),
                  name="g")
    df = ct.DataFrame({"a": cols["i32"], "b": cols["f64"]})
    return s, g, df


@pytest.mark.parametrize("name", sorted(_method_cases()))
def test_series_and_frame_methods_on_the_card_match_cpu(dev, name):
    fn = _method_cases()[name]
    _assert_host_equal(_host_of(fn(*_method_inputs(dev))), _host_of(fn(*_method_inputs(CPU))))


def test_temporal_isin_and_replace_on_the_card_match_cpu(dev):
    """numpy's and the standard library's timestamps and durations, a few
    (one equality pass each) and 40 (the search)."""
    import cudf_tpu_torch as ct

    start = np.datetime64("2020-01-01", "ns")
    stamps = start + (np.arange(5000) % 50).astype("timedelta64[D]")
    spans = (np.arange(5000) % 30).astype("timedelta64[s]").astype("timedelta64[ns]")
    few = [datetime.datetime(2020, 1, 3), np.datetime64("2020-01-09")]
    many = [datetime.datetime(2019, 12, 20) + datetime.timedelta(days=d) for d in range(40)]
    gaps = [datetime.timedelta(seconds=4), np.timedelta64(7, "s")]

    def run(device):
        s = ct.Series(stamps, name="t", device=device)
        d = ct.Series(spans, name="d", device=device)
        return (s.isin(few), s.isin(many), d.isin(gaps),
                s.replace(few[0], datetime.datetime(2021, 1, 1)), d.replace(gaps[0], gaps[1]))

    _assert_host_equal(_host_of(run(dev)), _host_of(run(CPU)))


@pytest.mark.parametrize("query", sorted(tpch.FRAME_QUERIES))
def test_frame_queries_on_the_card_match_cpu(dev, query):
    on_card = tpch.generate(0.01, seed=5, device=dev)
    on_cpu = tpch.generate(0.01, seed=5, device=CPU)
    _same(tpch.FRAME_QUERIES[query](on_card), tpch.FRAME_QUERIES[query](on_cpu))


def test_over_on_the_card_matches_cpu(dev):
    from cudf_tpu_torch.engine import col, from_dataframe

    def run(device):
        t = tpch.generate(0.01, seed=5, device=device)
        return from_dataframe(t["lineitem"]).with_columns(
            col("l_quantity").mean().over("l_partkey").alias("q"),
            col("l_extendedprice").sum().over("l_returnflag", "l_linestatus").alias("p")
        ).collect()

    _same(run(dev), run(CPU))
