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
sums in float64 and agrees with pandas to rtol 1e-12.  Where the
reference is known to be wrong (all-null groups: ROADMAP.md queue 3), the
port is held to pandas only.
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
SPEC = {"f": ["sum", "mean", "count", "size"], "g": ["min", "max", "count"],
        "i": ["sum", "mean", "count", "min", "max", "size"],
        "b": ["sum", "mean", "min", "max"]}


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
    """Index and integer/bool columns exact; float columns to rtol (NaN in
    the same places).  The float32 column g is only asked for min, max
    and count: pandas sums float32 in float32, the port in float64."""
    np.testing.assert_array_equal(got.index.to_numpy(), exp.index.to_numpy())
    assert list(got.columns) == list(exp.columns)
    for col in exp.columns:
        g, e = got[col].to_numpy(), exp[col].to_numpy()
        if e.dtype.kind == "f":
            assert g.dtype.kind == "f", col
            np.testing.assert_allclose(g, e, rtol=rtol, atol=0, equal_nan=True,
                                       err_msg=str(col))
        else:
            assert g.dtype == e.dtype, col
            np.testing.assert_array_equal(g, e, err_msg=str(col))


def test_low_k_matches_reference_kernel_tier(reference_kernel_tier):
    pdf = _frame(1, 100)
    got = _port(pdf, SPEC)
    ref = cudf_tpu.DataFrame.from_pandas(pdf).groupby("k").agg(SPEC).to_pandas()
    _assert_frames(got, ref, rtol=1e-7)
    _assert_frames(got, pdf.groupby("k").agg(SPEC), rtol=1e-12)


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


def test_dropna_null_keys_via_reference_buffers(reference_kernel_tier):
    """Null keys (pandas Int64 <NA>) are dropped.  The port's frame is
    built from the reference frame's column buffers with from_buffers."""
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
    got = port_df.groupby("k").agg(spec).to_pandas()
    ref = ref_df.groupby("k").agg(spec).to_pandas()
    _assert_frames(got, ref, rtol=1e-7)
    _assert_frames(got, pdf.groupby("k").agg(spec), rtol=1e-12)
    with pytest.raises(NotImplementedError, match="sort tier"):
        port_df.groupby("k", dropna=False).agg(spec)


@pytest.mark.parametrize("K", [100, 50_000])
def test_all_null_groups_match_pandas(K):
    """ROADMAP.md queue 3: the reference's high-K min/max give the dtype's
    extreme for an all-null group, and its mean gives 0; pandas (and the
    port) give NaN, with sum 0 and count 0."""
    pdf = _frame(4, K, all_null_groups=True)
    pdf.loc[pdf.k % 10 == 0, ["f", "g"]] = np.nan
    spec = {"f": ["sum", "mean", "count", "min", "max", "size"],
            "g": ["min", "max", "count"]}
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


def test_ops_groupby_agg_matches_reference(reference_kernel_tier):
    """ops.groupby.groupby_agg on Tables, below the frame layer."""
    from cudf_tpu.core.column import Column as RefColumn
    from cudf_tpu.core.table import Table as RefTable
    from cudf_tpu.ops.groupby import groupby_agg as ref_groupby_agg
    from cudf_tpu_torch.core.table import Table
    from cudf_tpu_torch.ops.groupby import groupby_agg

    pdf = _frame(9, 100)
    requests = [("s", "i", "sum"), ("m", "f", "mean"), ("c", "f", "count"),
                ("x", "g", "max"), ("n", "b", "size")]
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
        else:
            np.testing.assert_array_equal(got, exp)
    with pytest.raises(NotImplementedError, match="sort tier"):
        groupby_agg(Table({"k": port_cols["k"]}), [("q", port_cols["i"], "median")])


def test_requests_outside_the_kernel_tiers_raise():
    pdf = _frame(7, 100)
    df = ct.from_pandas(pdf, device=CPU)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        df.groupby(["k", "i"]).agg("sum")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        df.groupby("f").agg({"i": "sum"})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        df.groupby("k").agg({"i": "median"})
    wide = ct.DataFrame({"k": torch.arange(4), "u": torch.arange(4).to(torch.uint64)})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        wide.groupby("k").agg({"u": "count"})
    with option_context("groupby.onehot_fast_path", False):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            df.groupby("k").agg({"i": "sum"})
    with option_context("groupby.fast_path_min_rows", N + 1):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            df.groupby("k").agg({"i": "sum"})


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
