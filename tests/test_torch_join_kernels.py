"""The join tier's kernels (cudf_tpu_torch.kernels.radix_partition: kernel
D's id/idpay modes, kernel H window_probe and the joins built on them)
against the reference's Pallas kernels in interpret mode.

On CPU tensors each wrapper takes its plain PyTorch version.  Every
comparison is exact: build tables hold build_row_id + 1 and payload bits
of a unique build side, and a probe copies them.  The reference's tables
are decoded from their 8-bit chunk planes (id + 1) and three bf16 term
planes (an f32 payload, summed exactly in float64).  Reference calls use
the cases and small tiles of tests/test_radix.py (tile_rows=32,
chunk_rows=2, agg_rows=8) and are computed once per module.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from cudf_tpu.kernels import radix_partition as ref
from cudf_tpu_torch.kernels import radix_partition as rp

torch.set_num_threads(1)

REF_TILES = dict(tile_rows=32, chunk_rows=2, agg_rows=8)
PORT = dict(tile=32 * 128, agg_rows=1000)     # several probe steps per window

_UNIQUE = ["multi_window", "single_window", "payload"]


@functools.lru_cache(maxsize=None)
def _inputs(name):
    """(lk, lv, rk, rv or None, dom) of tests/test_radix.py's join cases."""
    rng = np.random.default_rng(_UNIQUE.index(name) if name in _UNIQUE else 9)
    if name == "multi_window":
        nl, nr, dom = 24_000, 18_000, 36_000
        rk = rng.permutation(dom)[:nr].astype(np.int32)
        rv = None
    elif name == "single_window":
        dom, nl = 100, 5000
        rk = rng.permutation(dom).astype(np.int32)[:80]
        rv = None
    elif name == "payload":
        nl, nr, dom = 20_000, 10_000, 40_000
        rk = rng.permutation(dom)[:nr].astype(np.int32)
        rv = rng.normal(size=nr).astype(np.float32)
        rv[0] = -0.0                                 # copied with its sign
    elif name == "nonunique":
        rk, dom, nl, rv = np.array([3, 9, 3, 40], np.int32), 50, 4000, None
    elif name == "fanout3":
        nl, dom = 12_000, 9_000
        base = rng.permutation(dom)[:4000].astype(np.int32)
        rk = np.concatenate([base, base[:1500], base[:500]]).astype(np.int32)
        rng.shuffle(rk)
        rv = None
    else:                                            # "fanout9"
        rk, dom, nl, rv = np.array([5] * 9 + [7, 8], np.int32), 10, 4000, None
    lk = rng.integers(0, dom, nl).astype(np.int32)
    return lk, np.arange(nl, dtype=np.int32), rk, rv, dom


def _ref_kw(name):
    return REF_TILES if name != "single_window" and name != "nonunique" \
        else dict(agg_rows=8)


def _decode(tables, planes):
    """Sum over (scale, plane) of a reference table's [G, P*HI, 128]
    planes, flat over G * SPAN keys."""
    G = tables.shape[0]
    out = 0
    for scale, j in planes:
        out = out + scale * tables[:, j * ref.HI:(j + 1) * ref.HI, :].reshape(
            G * ref.SPAN).astype(np.float64)
    return out


@functools.lru_cache(maxsize=None)
def _ref_tables(name):
    lk, lv, rk, rv, dom = _inputs(name)
    tables, unique, G = ref.build_join_tables(
        jnp.asarray(rk), dom, rv=None if rv is None else jnp.asarray(rv),
        interpret=True, **_ref_kw(name))
    tables = np.asarray(tables)
    ids = _decode(tables, [(256.0 ** j, j) for j in range(4)]).astype(np.int64)
    pay = None if rv is None else _decode(tables, [(1.0, 4), (1.0, 5), (1.0, 6)])
    return ids, pay, unique, G


@functools.lru_cache(maxsize=None)
def _ref_probe(name):
    """(set of (probe row, build row), {probe row: payload} or None, unique)."""
    lk, lv, rk, rv, dom = _inputs(name)
    out = ref.radix_join_inner_unique(
        jnp.asarray(lk), jnp.asarray(lv), jnp.asarray(rk), dom,
        rv=None if rv is None else jnp.asarray(rv), interpret=True, **_ref_kw(name))
    pvl, bid = np.asarray(out[1]).ravel(), np.asarray(out[2]).ravel()
    f = bid >= 0
    pay = None if rv is None else dict(zip(pvl[f].tolist(),
                                           np.asarray(out[3]).ravel()[f].tolist()))
    return set(zip(pvl[f].tolist(), bid[f].tolist())), pay, out[-1]


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("name", _UNIQUE)
def test_window_tables_match_reference(name):
    """D' (kernel D's id/idpay modes): id + 1 per key, payload and the
    unique flag equal the reference's build tables."""
    lk, lv, rk, rv, dom = _inputs(name)
    ids, pay, unique, G = _ref_tables(name)
    got_ids, got_pay, got_unique, got_G = rp.build_join_tables(
        _t(rk), dom, _t(rv), tile=PORT["tile"], agg_rows=PORT["agg_rows"])
    assert got_G == G and got_unique is True and unique is True
    assert got_ids.dtype == torch.int64
    np.testing.assert_array_equal(got_ids.numpy(), ids)
    occupied = np.zeros(G * rp.SPAN, bool)
    occupied[rk] = True
    np.testing.assert_array_equal(ids > 0, occupied)
    if rv is None:
        assert got_pay is None
        return
    as_f32 = got_pay.to(torch.int32).view(torch.float32).numpy()
    np.testing.assert_array_equal(as_f32.astype(np.float64), pay)
    # the bits themselves: -0.0 keeps its sign
    np.testing.assert_array_equal(got_pay.numpy()[rk], rv.view(np.int32).astype(np.int64))


def test_nonunique_build_detected():
    lk, lv, rk, rv, dom = _inputs("nonunique")
    assert _ref_probe("nonunique")[2] is False
    assert rp.build_join_tables(_t(rk), dom)[2] is False
    pk, pv, bid, unique = rp.radix_join_inner_unique(_t(lk), _t(lv), _t(rk), dom)
    assert unique is False and bid is None


@pytest.mark.parametrize("name", _UNIQUE)
def test_probe_matches_reference(name):
    """Kernel H through radix_join_inner_unique: the same (probe row,
    build row) pairs and (probe row, payload) pairs as the reference."""
    lk, lv, rk, rv, dom = _inputs(name)
    pairs, ref_pay, unique = _ref_probe(name)
    out = rp.radix_join_inner_unique(_t(lk), _t(lv), _t(rk), dom, rv=_t(rv), **PORT)
    pk, pv, bid = out[:3]
    assert out[-1] is True and unique is True
    assert bid.dtype == torch.int32 and bid.shape == lk.shape
    f = bid >= 0
    assert set(zip(pv[f].tolist(), bid[f].tolist())) == pairs
    np.testing.assert_array_equal(rk[bid[f].numpy()], pk[f].numpy())
    exp = pd.merge(pd.DataFrame({"k": lk, "i": lv}), pd.DataFrame({"k": rk, "j": np.arange(rk.size)}))
    assert pairs == set(zip(exp["i"], exp["j"]))
    if rv is not None:
        pay = out[3]
        assert pay.dtype == torch.float32
        assert dict(zip(pv[f].tolist(), pay[f].tolist())) == ref_pay
        np.testing.assert_array_equal(pay[f].numpy().view(np.int32),
                                      rv[bid[f].numpy()].view(np.int32))
        assert (pay[~f] == 0).all()


def test_multi_bounded_fanout_matches_reference():
    lk, lv, rk, rv, dom = _inputs("fanout3")
    rpk, rpv, rbids, rmult = ref.radix_join_inner_multi(
        jnp.asarray(lk), jnp.asarray(lv), jnp.asarray(rk), dom, m_max=4,
        interpret=True, **REF_TILES)
    rpv = np.asarray(rpv).ravel()
    exp = set()
    for b in rbids:
        b = np.asarray(b).ravel()
        exp |= set(zip(rpv[b >= 0].tolist(), b[b >= 0].tolist()))
    pk, pv, bids, mult = rp.radix_join_inner_multi(_t(lk), _t(lv), _t(rk), dom, m_max=4,
                                                   **PORT)
    assert mult == rmult == 3 and bids.shape == (3, lk.size)
    got = set()
    for j, b in enumerate(bids):
        f = b >= 0
        got |= set(zip(pv[f].tolist(), b[f].tolist()))
        np.testing.assert_array_equal(rk[b[f].numpy()], pk[f].numpy())
        if j:     # a row's matches fill bids[0..c-1], in build-row order
            assert (bids[j - 1][f] >= 0).all() and (bids[j - 1][f] < b[f]).all()
    assert got == exp


def test_multi_fanout_over_bound_matches_reference():
    lk, lv, rk, rv, dom = _inputs("fanout9")
    _, _, rbids, rmult = ref.radix_join_inner_multi(
        jnp.asarray(lk), jnp.asarray(lv), jnp.asarray(rk), dom, m_max=4,
        agg_rows=8, interpret=True)
    assert rbids is None and rmult == 9
    assert rp.radix_join_inner_multi(_t(lk), _t(lv), _t(rk), dom, m_max=4) == \
        (None, None, None, 9)


@pytest.mark.parametrize("m,pay_dtype", [(1, None), (2, None), (3, None), (4, None),
                                         (1, torch.int32), (1, torch.int64),
                                         (1, torch.float32), (1, torch.float64)])
def test_window_probe_plain_edges(m, pay_dtype):
    """Empty windows, keys out of their window and rows past base[-1]
    read -1 (payload 0); found rows read table - 1 and copy the payload's
    bits, NaN and -0.0 included."""
    G = 4
    rng = np.random.default_rng(m)
    tables = torch.from_numpy(rng.integers(0, 50, (m, G * rp.SPAN)))
    tables[:, rp.SPAN:2 * rp.SPAN] = 0                         # window 1 empty
    sizes = [7, 5, 0, 9]
    keys = np.concatenate([rng.integers(w * rp.SPAN, (w + 1) * rp.SPAN, s)
                           for w, s in enumerate(sizes)] + [rng.integers(0, 9, 6)])
    keys[3] = 3 * rp.SPAN + 1                                  # out of its window
    keys[-6:-3] = -1
    pk = torch.from_numpy(keys.astype(np.int32))
    base = torch.tensor([0] + list(np.cumsum(sizes)), dtype=torch.int64)
    pay = None
    if pay_dtype is not None:
        vals = torch.from_numpy(rng.normal(size=G * rp.SPAN) * 9).to(pay_dtype)
        if pay_dtype.is_floating_point:                       # rows 0-1 match these
            vals[keys[:2]] = torch.tensor([float("nan"), -0.0], dtype=pay_dtype)
            tables[0, keys[:2]] = 7
        pay = rp.payload_bits(vals).long()
    bids, out = rp.window_probe(pk, base, tables, pay, pay_dtype)
    rows = int(base[-1])
    win = np.repeat(np.arange(G), sizes)
    for t in range(m):
        exp = np.full(keys.size, -1)
        ok = (keys[:rows] >= 0) & (keys[:rows] >> rp.WINDOW_BITS == win)
        exp[:rows][ok] = tables[t].numpy()[keys[:rows][ok]] - 1
        np.testing.assert_array_equal(bids[t].numpy(), exp)
    assert (bids[:, 3] == -1).all() and (bids[:, 7:12] == -1).all()
    if pay_dtype is None:
        assert out is None
        return
    found = bids[0] >= 0
    assert out.dtype == pay_dtype and (out[~found] == 0).all()
    if pay_dtype.is_floating_point:
        assert found[:2].all()
    want = pay[pk[found].long()]
    got = rp.payload_bits(out[found])
    assert torch.equal(got.long() if pay_dtype.itemsize == 4 else got, want)


def test_window_probe_rejects_bad_tables():
    pk = torch.zeros(4, dtype=torch.int32)
    base = torch.tensor([0, 4])
    with pytest.raises(ValueError):
        rp.window_probe(pk, base, torch.zeros((5, rp.SPAN), dtype=torch.int64))
    with pytest.raises(ValueError):
        rp.window_probe(pk, base, torch.zeros((1, rp.SPAN), dtype=torch.int32))
    with pytest.raises(ValueError):
        rp.window_probe(pk, base, torch.zeros((2, rp.SPAN), dtype=torch.int64),
                        torch.zeros(rp.SPAN, dtype=torch.int64), torch.float32)
    with pytest.raises(ValueError, match="stage_min_rows"):
        rp.window_probe(pk, base, torch.zeros((1, rp.SPAN), dtype=torch.int64),
                        stage_min_rows=0)
    with pytest.raises(TypeError):
        rp.payload_bits(torch.zeros(3, dtype=torch.int16))
