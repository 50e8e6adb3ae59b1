"""The J1 join slice end to end: ``DataFrame.merge(on=...)`` in
cudf_tpu_torch against cudf_tpu and pandas on the same seeded frames.

The reference runs its radix tier in Pallas interpret mode
(``join.kernel_interpret``) above a lowered ``join.fast_path_min_rows``,
restored afterwards, as tests/test_join.py does; the port takes the same
row bound.  Single-window cases (dim keys within one 8192-key window) are
held to both the reference and pandas; partitioned cases to pandas only,
since the reference's radix tier at its default tiles takes minutes to
compile in interpret mode (tests/test_torch_join_kernels.py holds the
port's join kernels to the reference's at small tiles).  Port frames are
built from the reference frames' column buffers with ``from_buffers``.
Every comparison is exact.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import cudf_tpu
from cudf_tpu.utils.config import get_option as ref_get_option
from cudf_tpu.utils.config import set_option as ref_set_option
import cudf_tpu_torch as ct
from cudf_tpu_torch.models import j1_join
from cudf_tpu_torch.utils.config import option_context

torch.set_num_threads(1)

CPU = torch.device("cpu")
MIN_ROWS = 1000
NF, ND = 5000, 100                 # fact and dim rows of the single-window cases


@pytest.fixture
def kernel_tiers():
    """Both packages' radix tier from MIN_ROWS probe rows; the reference's
    in interpret mode."""
    names = ("join.kernel_interpret", "join.fast_path_min_rows")
    old = [ref_get_option(n) for n in names]
    ref_set_option("join.kernel_interpret", True)
    ref_set_option("join.fast_path_min_rows", MIN_ROWS)
    try:
        with option_context("join.fast_path_min_rows", MIN_ROWS):
            yield
    finally:
        for n, v in zip(names, old):
            ref_set_option(n, v)


def _j1(seed, n_fact=NF, n_dim=ND, key_dtype=np.int64, fanout=1):
    """db-benchmark J1 shape: dim ids a permutation of 1..n_dim (each
    repeated 1..fanout times, shuffled), fact ids uniform over
    1..ceil(1.1 n_dim), so about 9% of fact rows find no match."""
    rng = np.random.default_rng(seed)
    ids = rng.permutation(n_dim) + 1
    if fanout > 1:
        ids = np.repeat(ids, rng.integers(1, fanout + 1, n_dim))
        rng.shuffle(ids)
    fact = pd.DataFrame({"id": rng.integers(1, -(-11 * n_dim // 10) + 1, n_fact).astype(key_dtype),
                         "v1": rng.normal(size=n_fact)})
    dim = pd.DataFrame({"id": ids.astype(np.int64), "v2": rng.normal(size=ids.size)})
    return fact, dim


def _port(ref_df):
    """The port's frame over the reference frame's column buffers."""
    cols = {}
    for name in ref_df._table.names:
        c = ref_df._table[name]
        validity = None if c.validity is None else np.asarray(c.validity)
        data = np.asarray(c.data)
        cols[name] = ct.from_buffers(data.dtype, c.length, data, validity, device=CPU)
    return ct.DataFrame(cols)


def _check(got, *expected):
    for exp in expected:
        pd.testing.assert_frame_equal(got.reset_index(drop=True), exp.reset_index(drop=True),
                                      check_exact=True)


def _merge_both(left, right, **kw):
    """(port result, reference result) of left.merge(right, **kw)."""
    rl, rr = cudf_tpu.DataFrame.from_pandas(left), cudf_tpu.DataFrame.from_pandas(right)
    got = _port(rl).merge(_port(rr), **kw).to_pandas()
    return got, rl.merge(rr, **kw).to_pandas()


@pytest.mark.parametrize("case", ["unique", "swapped", "fanout", "int32_keys"])
def test_single_window_matches_reference_and_pandas(kernel_tiers, case):
    """The radix tier in one window: a unique dim build side, the
    dim.merge(fact) orientation (build on the left), a build side with
    up to three rows per key (stacked tables), and int32 fact keys
    against int64 dim keys (the output key is the left's)."""
    fact, dim = _j1(1, fanout=3 if case == "fanout" else 1,
                    key_dtype=np.int32 if case == "int32_keys" else np.int64)
    left, right = (dim, fact) if case == "swapped" else (fact, dim)
    got, ref = _merge_both(left, right, on="id")
    assert len(got) > 0.8 * NF
    _check(got, ref, left.merge(right, on="id"))


@pytest.mark.parametrize("case", ["unique", "swapped", "fanout"])
def test_partitioned_matches_pandas(case):
    """Multi-window key domains: one partition pass on both sides."""
    fact, dim = _j1(2, n_fact=20_000, n_dim=30_000, fanout=4 if case == "fanout" else 1)
    left, right = (dim, fact) if case == "swapped" else (fact, dim)
    with option_context("join.fast_path_min_rows", MIN_ROWS):
        got = ct.from_pandas(left, device=CPU).merge(ct.from_pandas(right, device=CPU),
                                                     on="id").to_pandas()
    _check(got, left.merge(right, on="id"))


def test_two_pass_domain_matches_pandas(monkeypatch):
    """A dim whose ids span more than 2^20 values: both sides take the
    sorted route's two passes, the second ordered by the low 20 bits."""
    from cudf_tpu_torch.kernels import radix_partition as rp

    masks = []
    merge_scatter = rp.merge_scatter

    def recording(*args, **kw):
        masks.append(args[7] if len(args) > 7 else kw.get("mask_bits"))
        return merge_scatter(*args, **kw)

    monkeypatch.setattr(rp, "merge_scatter", recording)
    rng = np.random.default_rng(9)
    ids = rng.choice(1_500_000, 30_000, replace=False) + 1
    dim = pd.DataFrame({"id": ids, "v2": rng.normal(size=ids.size)})
    fact = pd.DataFrame({"id": np.where(rng.random(20_000) < 0.9, rng.choice(ids, 20_000),
                                        rng.integers(1, 1_500_001, 20_000)),
                         "v1": rng.normal(size=20_000)})
    for left, right in ((fact, dim), (dim, fact)):
        with option_context("join.fast_path_min_rows", MIN_ROWS):
            got = ct.from_pandas(left, device=CPU).merge(ct.from_pandas(right, device=CPU),
                                                         on="id").to_pandas()
        _check(got, left.merge(right, on="id"))
    # second passes under the low 20 bits, first passes under the domain's
    assert masks.count(rp.WINDOW_BITS + rp.PASS_BITS) >= 2
    assert masks.count(rp.domain_bits(1_500_001)) >= 2


def test_dense_tier_matches_reference_and_pandas():
    """Radix tier off on both packages: the direct-address dense tier."""
    fact, dim = _j1(3)
    old = ref_get_option("join.radix_fast_path")
    ref_set_option("join.radix_fast_path", False)
    try:
        with option_context("join.radix_fast_path", False):
            got, ref = _merge_both(fact, dim, on="id")
    finally:
        ref_set_option("join.radix_fast_path", old)
    _check(got, ref, fact.merge(dim, on="id"))


@pytest.mark.parametrize("side", ["left", "right"])
def test_null_keys_on_one_side(kernel_tiers, side):
    """Null keys (pandas Int64 <NA>) on one side never match."""
    fact, dim = _j1(4)
    nulls = fact if side == "left" else dim
    nulls["id"] = pd.array(nulls["id"], dtype="Int64")
    nulls.loc[nulls.index[::7], "id"] = pd.NA
    got, ref = _merge_both(fact, dim, on="id")
    exp = fact.dropna(subset=["id"]).astype({"id": np.int64}).merge(
        dim.dropna(subset=["id"]).astype({"id": np.int64}), on="id")
    # the reference keeps pandas' nullable Int64 for the key it emits; the
    # port has no nullable extension dtypes yet (ROADMAP.md queue 1) and
    # gives the int64 storage, all valid
    _check(got, ref.astype({"id": np.int64}), exp)


def test_left_on_right_on_and_suffixes(kernel_tiers):
    fact, dim = _j1(5)
    left = fact.rename(columns={"id": "a"}).assign(w=np.arange(NF))
    right = dim.rename(columns={"id": "b"}).assign(w=np.arange(ND) * 3, v1=-np.arange(ND))
    kw = dict(left_on="a", right_on="b", suffixes=("_l", "_r"))
    got, ref = _merge_both(left, right, **kw)
    assert list(got.columns) == ["a", "v1_l", "w_l", "b", "v2", "w_r", "v1_r"]
    _check(got, ref, left.merge(right, **kw))


@pytest.mark.parametrize("keys", ["id", ["id"]])
def test_left_on_right_on_same_column_emits_it_once(keys):
    """left_on and right_on naming the same column: the key comes out
    once, from the left, as pandas gives it (ROADMAP.md queue 3: the port
    and the reference emit id_x and id_y).  The probe has at least
    join.fast_path_min_rows rows, the radix tier's default bound."""
    fact, dim = _j1(10, n_fact=70_000)
    dim = dim.assign(v1=-np.arange(ND))
    kw = dict(left_on=keys, right_on=keys)
    got = ct.from_pandas(fact, device=CPU).merge(ct.from_pandas(dim, device=CPU),
                                                 **kw).to_pandas()
    assert list(got.columns) == ["id", "v1_x", "v2", "v1_y"]
    _check(got, fact.merge(dim, **kw))


@pytest.mark.parametrize("tier", ["radix", "dense"])
def test_no_matches(kernel_tiers, tier):
    fact, dim = _j1(6)
    dim["id"] += 10 * ND
    with option_context("join.radix_fast_path", tier == "radix"):
        got = ct.from_pandas(fact, device=CPU).merge(ct.from_pandas(dim, device=CPU),
                                                     on="id").to_pandas()
    assert len(got) == 0
    _check(got, fact.merge(dim, on="id"))


def test_requests_outside_the_tiers_raise():
    """The requests the kernel and dense tiers do not serve (a left join,
    two keys, sort=True, fan-out 9 on both sides, null keys on both sides)
    raised while the sort-merge tier was missing; they now take it, and
    each equals pandas."""
    fact, dim = _j1(7)
    f, d = ct.from_pandas(fact, device=CPU), ct.from_pandas(dim, device=CPU)
    _check(f.merge(d, on="id", how="left").to_pandas(), fact.merge(dim, on="id", how="left"))
    _check(f.merge(f, on=["id", "v1"]).to_pandas(), fact.merge(fact, on=["id", "v1"]))
    _check(f.merge(d, on="id", sort=True).to_pandas(), fact.merge(dim, on="id", sort=True))
    many = pd.DataFrame({"id": np.repeat(np.arange(1, 11), 9), "v2": np.arange(90.0)})
    _check(f.merge(ct.from_pandas(many, device=CPU), on="id").to_pandas(),
           fact.merge(many, on="id"))
    both = pd.DataFrame({"id": pd.array([1, None, 3] * 30, dtype="Int64"), "v2": np.arange(90.0)})
    fact["id"] = pd.array(fact["id"], dtype="Int64")
    fact.loc[::5, "id"] = pd.NA
    got = _port(cudf_tpu.DataFrame.from_pandas(fact)).merge(
        _port(cudf_tpu.DataFrame.from_pandas(both)), on="id").to_pandas()
    exp = fact.merge(both, on="id")                  # pandas pairs the null keys
    assert exp["id"].isna().any()
    _check(got, exp.astype({"id": "float64"}))


@pytest.mark.parametrize("n_dim", [ND, 30_000])
def test_j1_join_model(n_dim):
    """models.j1_join: gather maps of the unique-build J1 kernel tier."""
    fact, dim = _j1(8, n_fact=20_000, n_dim=n_dim)
    lk = torch.from_numpy((fact["id"].to_numpy() - 1).astype(np.int32))
    rk = torch.from_numpy((dim["id"].to_numpy() - 1).astype(np.int32))
    lk[lk >= n_dim] = -1
    pk, pv, bid, unique = j1_join(lk, torch.arange(lk.shape[0], dtype=torch.int32), rk, n_dim)
    assert unique is True
    f = bid >= 0
    got = sorted(zip(pv[f].tolist(), bid[f].tolist()))
    exp = fact.reset_index().merge(dim.reset_index(), on="id")
    assert got == list(zip(exp["index_x"], exp["index_y"]))
    assert torch.equal(pk[f], rk[bid[f].long()])
