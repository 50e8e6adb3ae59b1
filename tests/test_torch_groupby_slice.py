"""The G1 groupby slice end to end: ``DataFrame.groupby(k).agg(...)`` in
cudf_tpu_torch against cudf_tpu and pandas on the same seeded frames.

The reference runs its kernel tier in Pallas interpret mode
(``groupby.kernel_interpret``) above a lowered ``fast_path_min_rows``,
as tests/test_groupby_exact.py does.  At K = 50 000 its radix tier in
interpret mode takes minutes to compile on a CPU, so there the reference
runs its sort tier (its CPU default); tests/test_torch_radix_partition.py
holds the port's radix kernels to the reference's radix kernels.

Tolerances: counts, sizes, integer and bool results exact.  Float inputs
are f32-representable and, like G1's v3, non-negative: the reference
rounds float values to f32 (ops/groupby.py:943) and sums each grid step
in f32 before its double-float carry, an error relative to the sum of
|v| that stays within rtol 1e-7 of a sum without cancellation; the port
sums in float64 and agrees with pandas to rtol 1e-12.  Float32 sums and
means come back in float32 on both sides, but pandas sums float32 in
float32 and the port in float64 before it rounds once: they agree within
a few float32 ulps of the terms (F32_RTOL, F32_ATOL; the terms of the
float32 column g are below 6 in magnitude).  Where the reference is known
to be wrong (all-null groups, the float32 mean's width: ROADMAP.md queue
3), the port is held to pandas only.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import cudf_tpu
from cudf_tpu.utils.config import get_option as ref_get_option
from cudf_tpu.utils.config import set_option as ref_set_option
import cudf_tpu_torch as ct
from cudf_tpu_torch.models import g1_groupby
from cudf_tpu_torch.utils.config import option_context

torch.set_num_threads(1)

CPU = torch.device("cpu")
N = 20_000
SPEC = {"f": ["sum", "mean", "count", "size"], "g": ["sum", "mean", "min", "max", "count"],
        "i": ["sum", "mean", "count", "min", "max", "size"],
        "b": ["sum", "mean", "min", "max"]}
# the reference's float32 mean comes back float64, and its float32 sums
# of g's signed terms cancel in f32: g's sum and mean are held to pandas
REF_SPEC = dict(SPEC, g=["min", "max", "count"])
F32_RTOL, F32_ATOL = 1e-5, 1e-6


@pytest.fixture
def reference_kernel_tier():
    old = [ref_get_option("groupby.kernel_interpret"),
           ref_get_option("groupby.fast_path_min_rows")]
    ref_set_option("groupby.kernel_interpret", True)
    ref_set_option("groupby.fast_path_min_rows", 1000)
    yield
    ref_set_option("groupby.kernel_interpret", old[0])
    ref_set_option("groupby.fast_path_min_rows", old[1])


def _frame(seed, K, null_frac=0.2, all_null_groups=False):
    """k int64 keys (offset 7); f float64 in [0, 100) like G1's v3 and g
    float32, both with nulls; i int64 below 2^23 in magnitude; b bool.
    Unless all_null_groups, every group keeps one valid f and g (nulls
    only on repeated keys)."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, K, N) + 7
    pdf = pd.DataFrame({
        "k": k,
        "f": rng.uniform(0, 100, N).astype(np.float32).astype(np.float64),
        "g": rng.normal(size=N).astype(np.float32),
        "i": rng.integers(-2**23, 2**23, N),
        "b": rng.random(N) > 0.5,
    })
    nulls = rng.random(N) < null_frac
    if not all_null_groups:
        nulls &= pdf.k.duplicated().to_numpy()
    pdf.loc[nulls, "f"] = np.nan
    pdf.loc[nulls, "g"] = np.nan
    return pdf


def _port(pdf, spec, **kw):
    return ct.from_pandas(pdf, device=CPU).groupby("k", **kw).agg(spec).to_pandas()


def _assert_frames(got, exp, rtol):
    """Index and integer/bool columns exact; float columns of the same
    width, to rtol (float32 ones to F32_RTOL and F32_ATOL at least), NaN
    in the same places."""
    np.testing.assert_array_equal(got.index.to_numpy(), exp.index.to_numpy())
    assert list(got.columns) == list(exp.columns)
    for col in exp.columns:
        g, e = got[col].to_numpy(), exp[col].to_numpy()
        if e.dtype.kind == "f":
            assert g.dtype == e.dtype, col
            rt, at = (max(rtol, F32_RTOL), F32_ATOL) if e.dtype == np.float32 else (rtol, 0)
            np.testing.assert_allclose(g, e, rtol=rt, atol=at, equal_nan=True,
                                       err_msg=str(col))
        else:
            assert g.dtype == e.dtype, col
            np.testing.assert_array_equal(g, e, err_msg=str(col))


def test_low_k_matches_reference_kernel_tier(reference_kernel_tier):
    pdf = _frame(1, 100)
    ref = cudf_tpu.DataFrame.from_pandas(pdf).groupby("k").agg(REF_SPEC).to_pandas()
    _assert_frames(_port(pdf, REF_SPEC), ref, rtol=1e-7)
    _assert_frames(_port(pdf, SPEC), pdf.groupby("k").agg(SPEC), rtol=1e-12)


@pytest.mark.parametrize("spec,columns", [
    ({"i": "mean", "b": "sum", "k2": "mean"}, [3]),       # G1 q4's shape: no nulls, one mask
    (SPEC, [1, 1, 3]),       # f's and g's own masks; i, b and f's size under the key's
])
def test_onehot_tier_calls_kernel_once_per_mask(monkeypatch, spec, columns):
    """The one-hot tier hands every run under one mask to one kernel A
    call (wrapper calls and their columns counted: on the CPU no kernel
    launches), and the result still equals pandas'."""
    from cudf_tpu_torch.ops import groupby as ops_groupby

    seen = []
    real = ops_groupby.onehot_groupby_aggregate

    def counting(keys, vals, *args, **kw):
        seen.append(len(vals))
        return real(keys, vals, *args, **kw)

    monkeypatch.setattr(ops_groupby, "onehot_groupby_aggregate", counting)
    pdf = _frame(3, 100).assign(k2=lambda d: d.i * 3)
    _assert_frames(_port(pdf, spec), pdf.groupby("k").agg(spec), rtol=1e-12)
    assert sorted(seen) == columns


def test_high_k_matches_reference_and_pandas():
    """min/max are held to pandas only: the reference's sort tier takes
    ~25 s to compile them on a CPU, and its kernel tier's high-K min/max
    carry the queue-3 faults."""
    pdf = _frame(2, 50_000)
    spec = {"f": ["sum", "mean", "count", "size"], "i": ["sum", "mean", "count"],
            "b": ["sum", "mean"]}
    ref = cudf_tpu.DataFrame.from_pandas(pdf).groupby("k").agg(spec).to_pandas()
    _assert_frames(_port(pdf, spec), ref, rtol=1e-7)
    _assert_frames(_port(pdf, SPEC), pdf.groupby("k").agg(SPEC), rtol=1e-12)


@pytest.mark.parametrize("dropna", [True, False])
def test_dropna_null_keys_via_reference_buffers(reference_kernel_tier, dropna):
    """Null keys (pandas Int64 <NA>) are dropped, or under dropna=False
    form a group of their own, last (the sort tier; held to pandas).  The
    port's frame is built from the reference frame's column buffers with
    from_buffers."""
    pdf = _frame(3, 100)
    pdf["k"] = pd.array(pdf["k"], dtype="Int64")
    pdf.loc[pdf.index[::11], "k"] = pd.NA
    ref_df = cudf_tpu.DataFrame.from_pandas(pdf)
    cols = {}
    for name in pdf.columns:
        rc = ref_df._table[name]
        validity = None if rc.validity is None else np.asarray(rc.validity)
        dtype = np.asarray(rc.data).dtype
        cols[name] = ct.from_buffers(dtype, rc.length, np.asarray(rc.data),
                                     validity, device=CPU)
    port_df = ct.DataFrame(cols)
    spec = {"f": ["sum", "mean", "count"], "i": ["sum", "min", "max", "size"]}
    got = port_df.groupby("k", dropna=dropna).agg(spec).to_pandas()
    exp = pdf.groupby("k", dropna=dropna).agg(spec)
    if dropna:
        ref = ref_df.groupby("k").agg(spec).to_pandas()
        _assert_frames(got, ref, rtol=1e-7)
        _assert_frames(got, exp, rtol=1e-12)
        return
    assert got.index[-1] != got.index[-1] and exp.index[-1] is pd.NA   # the null group, last
    np.testing.assert_array_equal(got.index.to_numpy()[:-1], exp.index.to_numpy()[:-1])
    _assert_frames(got.reset_index(drop=True), exp.reset_index(drop=True), rtol=1e-12)


@pytest.mark.parametrize("K", [100, 50_000])
def test_all_null_groups_match_pandas(K):
    """ROADMAP.md queue 3: the reference's high-K min/max give the dtype's
    extreme for an all-null group, and its mean gives 0; pandas (and the
    port) give NaN, with sum 0 and count 0."""
    pdf = _frame(4, K, all_null_groups=True)
    pdf.loc[pdf.k % 10 == 0, ["f", "g"]] = np.nan
    spec = {"f": ["sum", "mean", "count", "min", "max", "size"],
            "g": ["sum", "mean", "min", "max", "count"]}
    got = _port(pdf, spec)
    exp = pdf.groupby("k").agg(spec)
    assert exp[("f", "count")].eq(0).any()
    _assert_frames(got, exp, rtol=1e-12)


@pytest.mark.parametrize("K", [100, 50_000])
def test_nan_values_min_max_skip_nan_like_pandas(K):
    """A frame built from tensors keeps NaN as a value (not a null).  On
    both tiers min/max skip it as pandas does, and a group of only NaN
    gives NaN (ROADMAP.md queue 3: the reference propagates NaN)."""
    pdf = _frame(10, K, null_frac=0.3, all_null_groups=True)
    pdf.loc[pdf.k % 10 == 0, ["f", "g"]] = np.nan
    df = ct.DataFrame({c: torch.tensor(pdf[c].to_numpy()) for c in ("k", "f", "g")})
    spec = {"f": ["min", "max"], "g": ["min", "max"]}
    got = df.groupby("k").agg(spec).to_pandas()
    exp = pdf.groupby("k").agg(spec)
    assert exp[("f", "min")].isna().any()
    _assert_frames(got, exp, rtol=0)


@pytest.mark.parametrize("K", [100, 50_000])
def test_float32_sum_and_mean_stay_float32(K):
    """A float32 column's sum and mean come back in float32, as pandas
    gives them (ROADMAP.md queue 3: the port gave float64, and the
    reference gives float64 for the mean); the sum is taken in float64."""
    pdf = _frame(13, K)[["k", "g"]]
    spec = {"g": ["sum", "mean", "count"]}
    got = _port(pdf, spec)
    assert got[("g", "sum")].dtype == got[("g", "mean")].dtype == np.float32
    _assert_frames(got, pdf.groupby("k").agg(spec), rtol=0)


@pytest.mark.parametrize("K", [100, 10_000])          # the one-hot tier, the radix tier
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.uint32])
def test_unsigned_values_min_max_match_pandas(K, dtype):
    """min/max of unsigned value columns in their own dtype on both tiers
    (ROADMAP.md queue 3: uint16 and uint32 raised on the one-hot tier),
    values up to the dtype's largest, and a group that only has nulls."""
    rng = np.random.default_rng(14)
    info = np.iinfo(dtype)
    k = rng.integers(0, K, N)
    u = rng.integers(0, int(info.max) + 1, N, dtype=np.uint64).astype(dtype)
    u[:3] = info.max
    valid = k != 5
    df = ct.DataFrame({"k": ct.from_buffers(np.int64, N, k, None, device=CPU),
                       "u": ct.from_buffers(dtype, N, u, valid, device=CPU)})
    spec = {"u": ["min", "max", "count"]}
    res = df.groupby("k").agg(spec)
    got = res.to_pandas()
    exp = pd.DataFrame({"k": k, "u": pd.array(u, dtype=f"UInt{info.bits}")})
    exp.loc[~valid, "u"] = pd.NA
    exp = exp.groupby("k").agg(spec)
    np.testing.assert_array_equal(got.index.to_numpy(), exp.index.to_numpy())
    np.testing.assert_array_equal(got[("u", "count")].to_numpy(),
                                  exp[("u", "count")].to_numpy())
    for agg in ("min", "max"):
        # the port keeps uint data under a validity mask; to_pandas gives
        # float64 with NaN for a column with nulls, pandas UInt with <NA>
        assert res._table[("u", agg)].data.dtype == torch.from_numpy(u).dtype
        g, e = got[("u", agg)], exp[("u", agg)]
        assert g.isna().tolist() == e.isna().tolist() and e.isna().any()
        assert g.dropna().astype(dtype).tolist() == e.dropna().astype(dtype).tolist()


@pytest.mark.parametrize("K", [100, 50_000])
def test_many_value_columns_match_pandas(K):
    """Nine value columns share one partition of the keys on the radix
    tier, more than one partition launch carries: row ids carry the
    rest (tests/test_torch_radix_partition.py holds both routes to it)."""
    rng = np.random.default_rng(11)
    pdf = pd.DataFrame({"k": rng.integers(0, K, N)})
    for j in range(9):
        pdf[f"v{j}"] = rng.integers(-1000, 1000, N) * (j + 1)
    _assert_frames(_port(pdf, "sum"), pdf.groupby("k").agg("sum"), rtol=0)


@pytest.mark.parametrize("K", [100, 50_000])
@pytest.mark.parametrize("spec", ["sum", ["min", "max"], {"i": "sum", "b": "max"},
                                  {"f": ["mean"], "i": "count"}])
def test_spec_forms_match_pandas(K, spec):
    pdf = _frame(5, K).drop(columns="g")
    _assert_frames(_port(pdf, spec), pdf.groupby("k").agg(spec), rtol=1e-12)


@pytest.mark.parametrize("K", [100, 50_000])
def test_as_index_false_and_wide_values(K):
    rng = np.random.default_rng(6)
    pdf = pd.DataFrame({"k": rng.integers(-K, 0, N).astype(np.int32),
                        "w": rng.integers(-2**62, 2**62, N),
                        "u": rng.integers(0, 200, N).astype(np.uint8)})
    spec = {"w": ["sum", "min", "max"], "u": ["sum", "max"]}
    got = _port(pdf, spec, as_index=False)
    exp = pdf.groupby("k", as_index=False).agg(spec)
    assert list(got.columns) == list(exp.columns)
    for col in exp.columns:
        np.testing.assert_array_equal(got[col].to_numpy(), exp[col].to_numpy())


@pytest.mark.parametrize("tier", ["kernel", "sort"])
def test_ops_groupby_agg_matches_reference(reference_kernel_tier, tier):
    """ops.groupby.groupby_agg on Tables, below the frame layer: a request
    the kernel tiers serve, and one with a median, std and nunique that
    both packages send to their sort tier."""
    from cudf_tpu.core.column import Column as RefColumn
    from cudf_tpu.core.table import Table as RefTable
    from cudf_tpu.ops.groupby import groupby_agg as ref_groupby_agg
    from cudf_tpu_torch.core.table import Table
    from cudf_tpu_torch.ops.groupby import groupby_agg

    pdf = _frame(9, 100)
    requests = [("s", "i", "sum"), ("m", "f", "mean"), ("c", "f", "count"),
                ("x", "g", "max"), ("n", "b", "size")]
    if tier == "sort":
        requests = [("q", "i", "median"), ("d", "f", "std"), ("u", "i", "nunique"),
                    ("s", "i", "sum"), ("c", "f", "count")]
    ref_cols = {c: RefColumn.from_numpy(pdf[c].to_numpy(), mask=pdf[c].notna().to_numpy())
                for c in pdf.columns}
    port_cols = {c: ct.from_buffers(pdf[c].dtype, N, pdf[c].to_numpy(),
                                    pdf[c].notna().to_numpy(), device=CPU)
                 for c in pdf.columns}
    rk, ra = ref_groupby_agg(RefTable({"k": ref_cols["k"]}),
                             [(o, ref_cols[c], a) for o, c, a in requests])
    gk, ga = groupby_agg(Table({"k": port_cols["k"]}),
                         [(o, port_cols[c], a) for o, c, a in requests])
    np.testing.assert_array_equal(gk["k"].to_numpy(), np.asarray(rk["k"].to_numpy()))
    for o, _, a in requests:
        got, exp = ga[o].to_numpy(), np.asarray(ra[o].to_numpy())
        if a == "mean":
            np.testing.assert_allclose(got, exp, rtol=1e-7, atol=0)
        elif a in ("median", "std"):
            np.testing.assert_allclose(got, exp, rtol=1e-12, atol=0)
        else:
            np.testing.assert_array_equal(got, exp)
    if tier == "sort":
        exp = pdf.groupby("k").agg(q=("i", "median"), d=("f", "std"), u=("i", "nunique"))
        for o in ("q", "d", "u"):
            np.testing.assert_allclose(ga[o].to_numpy(), exp[o].to_numpy(), rtol=1e-12)


@pytest.mark.parametrize("case", ["two_keys", "float_key", "median", "uint64_values",
                                  "kernel_tiers_off", "below_min_rows", "unported_agg"])
def test_requests_outside_the_kernel_tiers_raise(case):
    """Requests outside the kernel tiers: the sort tier serves each, held
    to pandas; an agg outside this slice still raises NotImplementedError
    naming its ROADMAP item."""
    pdf = _frame(7, 100)
    df = ct.from_pandas(pdf, device=CPU)
    by, spec, options = "k", {"i": "sum"}, ()
    if case == "two_keys":
        by, spec = ["k", "i"], "sum"
    elif case == "float_key":
        by = "f"
    elif case == "median":
        spec = {"i": "median"}
    elif case == "uint64_values":
        pdf = pd.DataFrame({"k": np.arange(4), "u": np.arange(4, dtype=np.uint64)})
        df = ct.DataFrame({"k": torch.arange(4), "u": torch.arange(4).to(torch.uint64)})
        spec = {"u": "count"}
    elif case == "kernel_tiers_off":
        options = ("groupby.onehot_fast_path", False)
    elif case == "below_min_rows":
        options = ("groupby.fast_path_min_rows", N + 1)
    elif case == "unported_agg":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            df.groupby("k").agg({"i": "ohlc"})      # "collect" and "tdigest" are ported
        return
    with option_context(*options):
        got = df.groupby(by).agg(spec).to_pandas()
    exp = pdf.groupby(by).agg(spec)
    if isinstance(by, list):
        assert got.index.tolist() == exp.index.tolist()
        got, exp = got.reset_index(drop=True), exp.reset_index(drop=True)
    _assert_frames(got, exp, rtol=1e-12)


def test_two_pass_domain_matches_pandas(monkeypatch):
    """Keys over more than 2^20 slots: the radix tier's sorted route takes
    two passes, the second ordered by the low 20 bits."""
    from cudf_tpu_torch.kernels import radix_partition as rp

    masks = []
    merge_scatter = rp.merge_scatter

    def recording(*args, **kw):
        masks.append(args[7] if len(args) > 7 else kw.get("mask_bits"))
        return merge_scatter(*args, **kw)

    monkeypatch.setattr(rp, "merge_scatter", recording)
    pdf = _frame(12, 1_500_000).drop(columns="g")
    spec = {"f": ["sum", "mean", "count", "size"], "i": ["sum", "min", "max"],
            "b": ["sum", "mean"]}
    _assert_frames(_port(pdf, spec), pdf.groupby("k").agg(spec), rtol=1e-12)
    # f's rows, then all rows; each first pass under the 21-bit domain's mask
    assert masks == [rp.domain_bits(1_500_000), rp.WINDOW_BITS + rp.PASS_BITS] * 2


@pytest.mark.parametrize("K", [100, 4096, 4097, 300_000])
def test_g1_groupby_model(K):
    rng = np.random.default_rng(8)
    keys = rng.integers(0, K, N).astype(np.int32)
    vals = rng.normal(size=N)
    s, c = g1_groupby(torch.from_numpy(keys), torch.from_numpy(vals), K)
    np.testing.assert_array_equal(c.numpy(), np.bincount(keys, minlength=K))
    np.testing.assert_allclose(s.numpy(), np.bincount(keys, weights=vals, minlength=K),
                               rtol=1e-12, atol=1e-12)
