"""``cudf_tpu_torch.parallel`` over 2 and 4 gloo ranks on the CPU (one
module-wide ``RankPool`` of each size) against the reference's same
functions on its 8-device CPU mesh (``tests/conftest.py``), on the same
seeded numpy inputs of a few hundred rows.

Each rank passes its row range and gets its share back; the shares are
put together here.  Keys, counts and joined rows exact; float sums rtol
1e-12; quantiles within the t-digest's stated error (2% of the range,
``tests/test_parallel.py``) of numpy's and of the reference's.  The
exchange is lossless: every ``dropped`` is 0 and every ``valid`` all true.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

import cudf_tpu as rct
from cudf_tpu import parallel as rpar
from cudf_tpu.parallel import dist as rdist
from cudf_tpu_torch.parallel.dryrun import RankPool

import torch_rank_tasks as tasks

torch.set_num_threads(1)
RANKS = [2, 4]
RNG = np.random.default_rng(42)
N = 512
GK = RNG.integers(0, 37, N)
GV = RNG.integers(0, 1000, N)
GW = RNG.normal(size=N)
LK, RK = RNG.integers(0, 40, 256), RNG.integers(0, 40, 128)
LV, RV = np.arange(256), np.arange(128) * 10
BK = np.arange(8).repeat(8)
SK = RNG.integers(-1000, 1000, 600)
SV = RNG.normal(size=600)
D1, D2 = RNG.integers(0, 25, 900), RNG.integers(0, 4, 900)
QX = RNG.normal(size=800) * 100.0
QVALID = RNG.random(800) < 0.7
PCTS = [0.01, 0.25, 0.5, 0.75, 0.99]
STRINGS = pd.DataFrame({"k": [["alpha", "beta", "gamma"][i] for i in RNG.integers(0, 3, 400)],
                        "v": RNG.normal(size=400)})


@pytest.fixture(scope="module")
def pools():
    started = {n: RankPool(n) for n in RANKS}      # both start while the reference compiles
    yield started
    for p in started.values():
        p.close()


def _masked(arrays, mask):
    mask = np.asarray(mask)
    return [np.asarray(a)[mask] for a in arrays]


@pytest.fixture(scope="module")
def reference():
    """The reference's answers on its 8-device mesh, once a module."""
    mesh = rpar.make_mesh(8)
    ones = lambda n: jnp.ones((n,), bool)   # noqa: E731
    out = {}
    k, s, c, v = jax.jit(lambda a, b, w, m: rdist.dist_groupby_sum(mesh, a, [b, w], m))(
        jnp.asarray(GK), jnp.asarray(GV), jnp.asarray(GW), ones(N))
    out["groupby"] = _masked([k, s[0], s[1], c], v)
    frame = rct.DataFrame.from_pandas(pd.DataFrame({"k": GK, "v": GV, "w": GW}))
    out["frame"] = rdist.distributed_groupby_agg(frame, "k", ["v", "w"], mesh,
                                                 aggs=("sum", "count", "mean")).to_pandas()
    out["strings"] = rdist.distributed_groupby_agg(rct.DataFrame.from_pandas(STRINGS), "k",
                                                   ["v"], mesh).to_pandas()
    for name, fn, rk in (("inner", rdist.dist_inner_join, RK), ("broadcast",
                                                                rdist.broadcast_inner_join, BK)):
        nr = len(rk)
        k, lp, rp, v = jax.jit(lambda a, b, m, c, d, w: fn(mesh, a, b, m, c, d, w))(
            jnp.asarray(LK), [jnp.asarray(LV)], ones(256), jnp.asarray(rk),
            [jnp.asarray(np.arange(nr) * 10)], ones(nr))
        out[name] = _masked([k, lp[0], rp[0]], v)
    pad = lambda a: jnp.asarray(np.concatenate([a, np.zeros(-len(a) % 8, a.dtype)]))  # noqa
    valid = jnp.arange(len(pad(SK))) < len(SK)
    for desc in (False, True):
        k, p, m, d = jax.jit(lambda a, b, vm: rdist.dist_sort(mesh, a, [b], vm, 3.0, desc))(
            pad(SK), pad(SV), valid)
        out[("sort", desc)] = _masked([k, p[0]], m)
    k, m, d = jax.jit(lambda a, b, vm: rdist.dist_distinct(mesh, [a, b], vm))(
        pad(D1), pad(D2), jnp.arange(len(pad(D1))) < len(D1))
    out["distinct"] = set(zip(*[x.tolist() for x in _masked(k, m)]))
    out["quantile"] = rdist.dist_quantile(mesh, jnp.asarray(QX), jnp.asarray(QVALID), PCTS,
                                          delta=200)
    return out


def joined(parts):
    """Every rank's share of a result, put together."""
    return [np.concatenate([p[i] for p in parts]) for i in range(len(parts[0]))]


def frame_of(cols, names):
    return pd.DataFrame(dict(zip(names, cols))).sort_values(names).reset_index(drop=True)


@pytest.mark.parametrize("ranks", RANKS)
def test_dist_groupby_sum(pools, reference, ranks):
    parts = pools[ranks].run(tasks.groupby_sum, [GK], [GV, GW])
    assert all(ok and dropped == 0 for *_, ok, dropped in parts)
    got = frame_of(joined([[k[0], s[0], s[1], c] for k, s, c, _, _ in parts]),
                   ["k", "v", "w", "c"])
    exp = frame_of(reference["groupby"], ["k", "v", "w", "c"])
    assert len(set(got["k"])) == len(got)               # each key on one rank
    np.testing.assert_array_equal(got[["k", "v", "c"]], exp[["k", "v", "c"]])
    np.testing.assert_allclose(got["w"], exp["w"], rtol=1e-12)


@pytest.mark.parametrize("ranks", RANKS)
def test_the_moments_merge_exactly(pools, ranks):
    """min, max, mean, var, std by key (``dist_groupby_agg``, var and std by
    Chan's merge) against pandas and numpy's two-pass variance, of values
    near 1e9 where a merge of sums of squares cancels."""
    x = 1e9 + np.random.default_rng(5).random(N)
    parts = pools[ranks].run(tasks.groupby_moments, GK, x)
    k = np.concatenate([p[0] for p in parts])
    aggs = [np.concatenate([p[1][j] for p in parts]) for j in range(5)]
    got = frame_of([k, *aggs], ["k", "min", "max", "mean", "var", "std"])
    by = pd.DataFrame({"k": GK, "x": x}).groupby("k")["x"]
    exp = by.agg(["min", "max", "mean"]).reset_index()
    two_pass = by.apply(lambda s: np.var(s.to_numpy(), ddof=1)).to_numpy()
    np.testing.assert_array_equal(got[["k", "min", "max"]], exp[["k", "min", "max"]])
    np.testing.assert_allclose(got["mean"], exp["mean"], rtol=1e-12)
    np.testing.assert_allclose(got["var"], two_pass, rtol=1e-9)
    np.testing.assert_allclose(got["std"], np.sqrt(two_pass), rtol=1e-9)


@pytest.mark.parametrize("ranks", RANKS)
def test_distributed_groupby_agg(pools, reference, ranks):
    frames = pools[ranks].run(tasks.frame_groupby, pd.DataFrame({"k": GK, "v": GV, "w": GW}),
                              "k", ["v", "w"], ("sum", "count", "mean"))
    exp = reference["frame"]
    for got in frames:                                   # every rank the whole result
        assert list(got.columns) == list(exp.columns)
        np.testing.assert_array_equal(got[["k", "v_sum", "count"]], exp[["k", "v_sum", "count"]])
        np.testing.assert_allclose(got[["w_sum", "v_mean", "w_mean"]],
                                   exp[["w_sum", "v_mean", "w_mean"]], rtol=1e-12)
    strings = pools[ranks].run(tasks.frame_groupby, STRINGS, "k", ["v"], ("sum",))
    for got in strings:
        assert got["k"].tolist() == reference["strings"]["k"].tolist()
        np.testing.assert_allclose(got["v_sum"], reference["strings"]["v_sum"], rtol=1e-12)


@pytest.mark.parametrize("ranks", RANKS)
@pytest.mark.parametrize("broadcast", [False, True])
def test_inner_joins(pools, reference, ranks, broadcast):
    rk = BK if broadcast else RK
    parts = pools[ranks].run(tasks.inner_join, LK, LV, rk, np.arange(len(rk)) * 10, broadcast)
    assert all(p[3] for p in parts)
    got = frame_of(joined([p[:3] for p in parts]), ["k", "l", "r"])
    exp = frame_of(reference["broadcast" if broadcast else "inner"], ["k", "l", "r"])
    pd.testing.assert_frame_equal(got, exp, check_dtype=False)


@pytest.mark.parametrize("ranks", RANKS)
@pytest.mark.parametrize("how", ["left", "semi", "anti", "full"])
def test_join_families(pools, ranks, how):
    """The other joins of ``dist_join`` over two keys, against pandas."""
    rng = np.random.default_rng(6)
    lk1, lk2, rk1, rk2 = (rng.integers(0, 40, 300), rng.integers(0, 3, 300),
                          rng.integers(20, 60, 200), rng.integers(0, 3, 200))
    lv, rv = np.arange(300.0), np.arange(200.0) * 2
    parts = pools[ranks].run(tasks.join, [lk1, lk2], lv, [rk1, rk2], rv, how)
    ldf = pd.DataFrame({"k1": lk1, "k2": lk2, "lv": lv})
    rdf = pd.DataFrame({"k1": rk1, "k2": rk2, "rv": rv})
    keys = np.concatenate([p[0][0] for p in parts])
    lvs = np.concatenate([p[1][0] for p in parts])
    if how in ("semi", "anti"):
        hit = ldf.merge(rdf[["k1", "k2"]].drop_duplicates(), on=["k1", "k2"], how="left",
                        indicator=True)["_merge"] == "both"
        exp = ldf[hit.to_numpy() == (how == "semi")]
        np.testing.assert_array_equal(np.sort(lvs), np.sort(exp["lv"]))
        return
    exp = ldf.merge(rdf, on=["k1", "k2"], how="outer" if how == "full" else how)
    rvs = np.concatenate([p[2][0] for p in parts])
    rpresent = np.concatenate([p[5 if how == "full" else 4] for p in parts])
    got = pd.DataFrame({"k1": keys, "lv": lvs, "rv": np.where(rpresent, rvs, np.nan)})
    if how == "full":
        lpresent = np.concatenate([p[4] for p in parts])
        got["lv"] = np.where(lpresent, lvs, np.nan)
    cols = ["k1", "lv", "rv"]
    pd.testing.assert_frame_equal(got.sort_values(cols).reset_index(drop=True),
                                  exp[cols].sort_values(cols).reset_index(drop=True),
                                  check_dtype=False)


@pytest.mark.parametrize("ranks", RANKS)
@pytest.mark.parametrize("descending", [False, True])
def test_dist_sort(pools, reference, ranks, descending):
    parts = pools[ranks].run(tasks.sort, [SK], SV, descending)
    assert all(p[2] == 0 for p in parts)
    k = np.concatenate([p[0][0] for p in parts])          # rank order is the total order
    v = np.concatenate([p[1] for p in parts])
    exp_k, exp_v = reference[("sort", descending)]
    np.testing.assert_array_equal(k, exp_k)
    got = pd.DataFrame({"k": k, "v": v}).groupby("k")["v"].apply(sorted)
    exp = pd.DataFrame({"k": exp_k, "v": exp_v}).groupby("k")["v"].apply(sorted)
    pd.testing.assert_series_equal(got, exp)


@pytest.mark.parametrize("ranks", RANKS)
def test_dist_distinct(pools, reference, ranks):
    parts = pools[ranks].run(tasks.distinct, [D1, D2])
    rows = [set(zip(p[0].tolist(), p[1].tolist())) for p in parts]
    assert sum(len(r) for r in rows) == len(set.union(*rows))   # each tuple on one rank
    assert set.union(*rows) == reference["distinct"]


@pytest.mark.parametrize("ranks", RANKS)
def test_dist_quantile(pools, reference, ranks):
    parts = pools[ranks].run(tasks.quantile, QX, QVALID, PCTS)
    x = QX[QVALID]
    span = x.max() - x.min()
    for got in parts:
        np.testing.assert_array_equal(got, parts[0])
        assert np.all(np.abs(got - np.quantile(x, PCTS)) < 0.02 * span)
        assert np.all(np.abs(got - reference["quantile"]) < 0.02 * span)


@pytest.mark.parametrize("ranks", RANKS)
def test_a_shuffled_row_lands_where_the_partitioned_executor_sends_it(pools, ranks):
    """``shuffle_by_key`` gives rank r the rows ``engine/streaming.py``'s
    ``_shuffle`` puts in partition r of the same row ranges, in its order."""
    for gk, gv, ek, ev, ok, dropped in pools[ranks].run(tasks.shuffled_rows, GK, GV):
        assert ok and dropped == 0
        np.testing.assert_array_equal(gk, ek)
        np.testing.assert_array_equal(gv, ev)


def test_the_multislice_groupby(pools):
    """2 slices of 2 ranks: the hierarchical shuffle's groupby sum."""
    parts = pools[4].run(tasks.multislice, [GK], GW)
    got = frame_of(joined([[k[0], s, c] for k, s, c in parts]), ["k", "s", "c"])
    exp = pd.DataFrame({"k": GK, "w": GW}).groupby("k")["w"].agg(["sum", "count"]).reset_index()
    np.testing.assert_array_equal(got[["k", "c"]], exp[["k", "count"]])
    np.testing.assert_allclose(got["s"], exp["sum"], rtol=1e-12)


@pytest.mark.parametrize("ranks", RANKS)
def test_frames_and_bootstrap(pools, ranks):
    """``partition_frame`` puts a STRING column over one dictionary on every
    rank; ``collect_frame`` gives the whole frame back to every rank;
    ``process_info`` and ``host_local_slice`` name each rank's place."""
    pdf = pd.DataFrame({"s": ["b", "a", "c", "a", "d", "b", "e"] * 11, "v": np.arange(77)})
    parts = pools[ranks].run(tasks.frames_round_trip, pdf)
    for rank, (whole, keys, rows, info, sl) in enumerate(parts):
        assert keys == ["a", "b", "c", "d", "e"]
        pd.testing.assert_frame_equal(whole.astype({"s": object}), pdf, check_dtype=False)
        assert info["process_index"] == rank and info["process_count"] == ranks
        assert info["backend"] == "gloo"
        assert rows == sl.stop - sl.start
    assert sum(p[2] for p in parts) == len(pdf)


@pytest.mark.parametrize("ranks", RANKS)
def test_every_layout_crosses_the_ranks_unchanged(pools, ranks):
    """Every rank's table of every layout through ``gather_table`` (all of
    them, in rank order) and ``exchange`` (row i of every rank to rank
    i % size, source rank by source rank)."""
    parts = pools[ranks].run(tasks.layouts_round_trip)
    every = [p[2] for p in parts]
    for rank, (whole, mine, _) in enumerate(parts):
        for name in whole:
            assert whole[name] == [v for rows in every for v in rows[name]], name
            assert mine[name] == [v for rows in every for v in rows[name][rank::ranks]], name
