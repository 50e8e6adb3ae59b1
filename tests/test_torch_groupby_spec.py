"""The G1 groupby slice against pandas alone: ``DataFrame.groupby(k).agg``
in each spec form pandas takes, unsigned values' min and max, the
requests outside the kernel tiers (each raising or taking the sort tier
as pandas answers), and ``models.g1_groupby``, over the seeded frames of
``tests/test_torch_groupby_slice.py`` (whose reference comparisons stay
there), with its tolerances."""

import numpy as np
import pandas as pd
import pytest
import torch

import cudf_tpu_torch as ct
from cudf_tpu_torch.models import g1_groupby
from cudf_tpu_torch.utils.config import option_context
from torch_groupby_slice_helpers import CPU, N, _assert_frames, _frame, _port


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
@pytest.mark.parametrize("spec", ["sum", ["min", "max"], {"i": "sum", "b": "max"},
                                  {"f": ["mean"], "i": "count"}])
def test_spec_forms_match_pandas(K, spec):
    pdf = _frame(5, K).drop(columns="g")
    _assert_frames(_port(pdf, spec), pdf.groupby("k").agg(spec), rtol=1e-12)


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


@pytest.mark.parametrize("K", [100, 4096, 4097, 300_000])
def test_g1_groupby_model(K):
    rng = np.random.default_rng(8)
    keys = rng.integers(0, K, N).astype(np.int32)
    vals = rng.normal(size=N)
    s, c = g1_groupby(torch.from_numpy(keys), torch.from_numpy(vals), K)
    np.testing.assert_array_equal(c.numpy(), np.bincount(keys, minlength=K))
    np.testing.assert_allclose(s.numpy(), np.bincount(keys, weights=vals, minlength=K),
                               rtol=1e-12, atol=1e-12)
