"""``ops/tdigest.py`` and ``ops/groupby.py`` ``group_tdigest`` against the
reference's (JAX on the CPU): centroid means within rtol 1e-12 (sums in
another order), weights, min and max exact, and the estimates of
``percentile_approx`` within rtol 1e-12; nulls and NaN left out; the
merged digest of partitions; ``groupby().agg("tdigest")``.  Follows
``tests/test_tdigest.py``."""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from cudf_tpu.core.column import Column as RC
from cudf_tpu.ops import groupby as rgb
from cudf_tpu.ops import tdigest as rtd

import cudf_tpu_torch as ct
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.ops import groupby as gb
from cudf_tpu_torch.ops import tdigest

torch.set_num_threads(1)

CPU = "cpu"
QS = [0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 1.0]


def _values(n, seed, dist="normal"):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n) if dist == "normal" else rng.exponential(size=n) * 1e6
    x[::13] = np.nan
    valid = np.arange(n) % 17 != 4
    return x, valid


def _pair(x, valid):
    return (RC.from_numpy(x).with_validity(jnp.asarray(valid)),
            Column.from_numpy(x, device=CPU).with_validity(torch.from_numpy(valid)))


def _same_digest(got, exp):
    np.testing.assert_allclose(got.means.numpy(), np.asarray(exp.means), rtol=1e-12, atol=0)
    np.testing.assert_array_equal(got.weights.numpy(), np.asarray(exp.weights))
    np.testing.assert_array_equal([got.min, got.max], [exp.min, exp.max])   # NaN: empty


@pytest.mark.parametrize("n,delta", [(1, 10), (50, 10), (2000, 100), (3000, 25)])
@pytest.mark.parametrize("dist", ["normal", "exponential"])
def test_build_and_estimates_equal_the_reference(n, delta, dist):
    r, p = _pair(*_values(n, n + delta, dist))
    got, exp = tdigest.build_tdigest(p, delta), rtd.build_tdigest(r, delta)
    _same_digest(got, exp)
    np.testing.assert_allclose(tdigest.percentile_approx(got, QS).data.numpy(),
                               np.asarray(rtd.percentile_approx(exp, QS).data), rtol=1e-12)


def test_merge_of_partitions_equals_the_reference():
    x, valid = _values(4000, 9)
    bounds = [0, 700, 2100, 4000]
    parts = [_pair(x[a:b], valid[a:b]) for a, b in zip(bounds, bounds[1:])]
    got = tdigest.merge_tdigests([tdigest.build_tdigest(p, 50) for _, p in parts], 50)
    exp = rtd.merge_tdigests([rtd.build_tdigest(r, 50) for r, _ in parts], 50)
    _same_digest(got, exp)
    whole = tdigest.build_tdigest(_pair(x, valid)[1], 50)
    est = tdigest.percentile_approx(got, [0.5]).data
    assert abs(float(est - tdigest.percentile_approx(whole, [0.5]).data)) < 0.05


@pytest.mark.parametrize("delta", [5, 100])
def test_group_tdigest_equals_the_reference(delta):
    rng = np.random.default_rng(delta)
    x, valid = _values(3000, delta)
    k = rng.integers(0, 9, 3000)
    r, p = _pair(x, valid)
    got = gb.group_tdigest(p, gb.make_grouper([Column.from_numpy(k, device=CPU)]), delta)
    exp = rgb.group_tdigest(r, rgb.make_grouper([RC.from_numpy(k)]), delta)
    g_rows, e_rows = got.to_pylist(), exp.to_pylist()
    assert len(g_rows) == len(e_rows) == 9
    for a, b in zip(g_rows, e_rows):
        assert (a["min"], a["max"]) == (b["min"], b["max"])
        assert [c["weight"] for c in a["centroids"]] == [c["weight"] for c in b["centroids"]]
        np.testing.assert_allclose([c["mean"] for c in a["centroids"]],
                                   [c["mean"] for c in b["centroids"]], rtol=1e-12)


def test_groupby_agg_tdigest_through_the_frame():
    rng = np.random.default_rng(3)
    pdf = pd.DataFrame({"k": rng.integers(0, 4, 500), "v": rng.normal(size=500)})
    df = ct.DataFrame.from_pandas(pdf, device=CPU)
    res = df.groupby("k")["v"].agg("tdigest")
    assert res.index.to_pylist() == [0, 1, 2, 3]
    for key, row in zip(range(4), res.tolist()):
        vals = np.sort(pdf.v[pdf.k == key].to_numpy())
        assert row["min"] == vals[0] and row["max"] == vals[-1]
        assert sum(c["weight"] for c in row["centroids"]) == len(vals)
        digest = tdigest.TDigest(torch.tensor([c["mean"] for c in row["centroids"]]),
                                 torch.tensor([c["weight"] for c in row["centroids"]]),
                                 row["min"], row["max"])
        est = float(tdigest.percentile_approx(digest, [0.5]).data)
        assert abs(est - np.quantile(vals, 0.5)) < 0.1
