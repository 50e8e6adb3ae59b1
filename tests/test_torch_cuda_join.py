"""The join family on the card: every join of ``ops/join.py`` (inner,
left, full, semi, anti, cross, the mixed joins, ``merge_sorted``,
``HashJoin`` and ``DistinctHashJoin``), ``DataFrame.merge`` for every
``how``, the engine's joins and TPC-H q3, q4, q5, q9 and q10, on CUDA
tensors against the same calls on CPU tensors.

Key dtypes: every integer width signed and unsigned, float32 and float64
(NaN and -0.0 among the values), bool, timestamps, strings and
dictionaries (two over different, overlapping keys); one and two keys;
nulls on neither side, one side and both, under ``nulls_equal`` True and
False; the kernel tiers are also forced (``join.fast_path_min_rows`` 1).

Marked ``cuda``: without a CUDA device every test here skips (decided in
the fixture, never at import).  On a machine with a card run
``python -m pytest tests/test_torch_cuda_join.py -q --noconftest``.
Gather maps, keys and counts are exact; float aggregates rtol 1e-9.
"""

import numpy as np
import pytest
import torch

import cudf_tpu_torch as ct
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.engine import from_dataframe
from cudf_tpu_torch.models import tpch
from cudf_tpu_torch.ops import join
from cudf_tpu_torch.utils.config import get_option, option_context

pytestmark = pytest.mark.cuda

CPU = torch.device("cpu")
RTOL = 1e-9
NL, NR = 3000, 2000
DTYPES = ["int8", "int16", "int32", "int64", "uint8", "uint16", "uint32", "uint64",
          "float32", "float64", "bool", "datetime64[ns]", "str", "dict"]
STRINGS = ["", "a", "a\x00", "ab", "abcdefghij", "b", "zz", "abcdefghijklmnopq"]
DICT_KEYS = {"l": ["x", "a", "zz", "a\x00", "q"], "r": ["zz", "a", "w", "x"]}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _column(kind, n, rng, side, masked, device):
    if kind == "str":
        col = Column.from_strings(list(rng.choice(STRINGS, n)), device=device)
    elif kind == "dict":
        codes = torch.from_numpy(rng.integers(0, len(DICT_KEYS[side]), n).astype(np.int32))
        col = Column.from_dictionary(codes.to(device),
                                     Column.from_strings(DICT_KEYS[side], device=device))
    elif kind.startswith("float"):
        vals = rng.choice(np.array([0.0, -0.0, 1.5, np.nan, -2.0, 7.25, 3.0]), n)
        col = Column.from_tensor(torch.from_numpy(vals.astype(kind)).to(device))
    elif kind == "bool":
        col = Column.from_tensor(torch.from_numpy(rng.random(n) > 0.5).to(device))
    elif kind.startswith("datetime"):
        vals = rng.integers(0, 40, n).astype("datetime64[D]").astype(kind)
        col = Column.from_numpy(vals, device=device)
    else:
        info = np.iinfo(kind)
        vals = rng.integers(max(int(info.min), -20), 40, n).astype(kind)
        if kind in ("uint32", "uint64", "int64"):     # values at the top of the range too
            vals[::7] = info.max - vals[::7] % np.array(5, kind)
        col = Column.from_numpy(vals, device=device)
    if masked:
        mask = np.ones(n, bool)
        mask[rng.choice(n, n // 5, replace=False)] = False
        col = col.with_validity(torch.from_numpy(mask).to(device))
    return col


def _keys(kinds, nulls, device, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for side, n in (("l", NL), ("r", NR)):
        masked = nulls == "both" or nulls == side
        out.append([_column(k, n, rng, side, masked, device) for k in kinds])
    return out


def _same(got, exp):
    got = got if isinstance(got, tuple) else (got,)
    exp = exp if isinstance(exp, tuple) else (exp,)
    for g, e in zip(got, exp):
        assert g.device.type == "cuda"
        assert torch.equal(g.cpu(), e)


JOINS = ["inner_join", "left_join", "full_join", "semi_join", "anti_join"]


@pytest.mark.parametrize("nulls", ["none", "l", "r", "both"])
@pytest.mark.parametrize("kind", DTYPES)
def test_joins_on_the_card_match_cpu(dev, kind, nulls):
    (lc, rc), (lg, rg) = _keys([kind], nulls, CPU), _keys([kind], nulls, dev)
    for min_rows in (get_option("join.fast_path_min_rows"), 1):
        with option_context("join.fast_path_min_rows", min_rows):
            for fn in JOINS:
                for ne in (True, False):
                    _same(getattr(join, fn)(lg, rg, nulls_equal=ne),
                          getattr(join, fn)(lc, rc, nulls_equal=ne))


@pytest.mark.parametrize("kinds", [["int32", "str"], ["dict", "int64"], ["uint64", "float64"],
                                   ["int8", "bool", "datetime64[ns]"]])
@pytest.mark.parametrize("nulls", ["none", "both"])
def test_multi_key_joins_on_the_card_match_cpu(dev, kinds, nulls):
    (lc, rc), (lg, rg) = _keys(kinds, nulls, CPU, 1), _keys(kinds, nulls, dev, 1)
    for fn in JOINS:
        for ne in (True, False):
            _same(getattr(join, fn)(lg, rg, nulls_equal=ne),
                  getattr(join, fn)(lc, rc, nulls_equal=ne))
    hj, hc = join.HashJoin(rg), join.HashJoin(rc)
    for fn in ("inner_join", "left_join", "semi_join", "anti_join"):
        _same(getattr(hj, fn)(lg), getattr(hc, fn)(lc))


def test_cross_mixed_sorted_and_distinct_joins_on_the_card_match_cpu(dev):
    (lc, rc), (lg, rg) = _keys(["int64"], "l", CPU, 2), _keys(["int64"], "l", dev, 2)
    _same(join.cross_join(50, 40, device=dev), join.cross_join(50, 40, device=CPU))
    rng = np.random.default_rng(2)
    lv, rv = torch.from_numpy(rng.normal(size=NL)), torch.from_numpy(rng.normal(size=NR))
    for fn in ("mixed_inner_join", "mixed_left_join", "mixed_semi_join", "mixed_anti_join"):
        _same(getattr(join, fn)(lg, rg, lambda li, ri: lv.to(dev)[li] < rv.to(dev)[ri]),
              getattr(join, fn)(lc, rc, lambda li, ri: lv[li] < rv[ri]))
    parts = [np.sort(rng.integers(0, 50, n)) for n in (700, 500, 900)]
    _same(join.merge_sorted([[Column.from_numpy(p, device=dev)] for p in parts]),
          join.merge_sorted([[Column.from_numpy(p, device=CPU)] for p in parts]))
    build = rng.permutation(NR).astype(np.int64)
    probe = rng.integers(-3, NR + 3, NL)
    _same(join.DistinctHashJoin([Column.from_numpy(build, device=dev)]).inner_join(
        [Column.from_numpy(probe, device=dev)]),
        join.DistinctHashJoin([Column.from_numpy(build, device=CPU)]).inner_join(
        [Column.from_numpy(probe, device=CPU)]))


def _frames(device, seed=3):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 50, NL).astype(float)
    k[rng.random(NL) < 0.1] = np.nan
    left = ct.DataFrame({"k": k, "s": rng.choice(["p", "q", "rr"], NL),
                         "v": rng.normal(size=NL)}, device=device)
    kr = rng.integers(10, 70, NR).astype(float)
    kr[rng.random(NR) < 0.1] = np.nan
    right = ct.DataFrame({"k": kr, "s": rng.choice(["p", "rr", "t"], NR),
                          "w": rng.normal(size=NR)}, device=device)
    return left, right


def _same_frames(got, exp):
    assert list(got._table.names) == list(exp._table.names) and len(got) == len(exp)
    for name in exp._table.names:
        g, e = got._table[name], exp._table[name]
        assert g.device.type == "cuda" and g.dtype == e.dtype, name
        gv, ev = g.to_numpy(), e.to_numpy()
        if e.dtype.is_float:
            np.testing.assert_array_equal(gv, ev)
        else:
            assert gv.tolist() == ev.tolist(), name


@pytest.mark.parametrize("how", ["inner", "left", "right", "outer", "cross", "semi", "anti"])
def test_merge_on_the_card_matches_cpu(dev, how):
    (lg, rg), (lc, rc) = _frames(dev), _frames(CPU)
    kw = {} if how == "cross" else {"on": ["k", "s"] if how in ("left", "semi") else "k"}
    _same_frames(lg.merge(rg, how=how, **kw), lc.merge(rc, how=how, **kw))
    if how != "cross":
        _same_frames(lg.merge(rg, how=how, sort=True, **kw),
                     lc.merge(rc, how=how, sort=True, **kw))


@pytest.mark.parametrize("how", ["inner", "left", "outer", "cross", "semi", "anti"])
def test_engine_joins_on_the_card_match_cpu(dev, how):
    (lg, rg), (lc, rc) = _frames(dev), _frames(CPU)
    kw = {} if how == "cross" else {"on": "k"}
    _same_frames(from_dataframe(lg).join(from_dataframe(rg), how=how, **kw).collect(),
                 from_dataframe(lc).join(from_dataframe(rc), how=how, **kw).collect())


@pytest.mark.parametrize("min_rows", [None, 1])
@pytest.mark.parametrize("query", ["q3", "q4", "q5", "q9", "q10"])
def test_join_queries_on_the_card_match_cpu(dev, query, min_rows):
    """The same numpy tables on the card and on the CPU; with min_rows 1
    every single-key inner join tries the radix tier first."""
    on_card = tpch.generate(0.01, seed=5, device=dev)
    on_cpu = tpch.generate(0.01, seed=5, device=CPU)
    rows = min_rows or get_option("join.fast_path_min_rows")
    with option_context("join.fast_path_min_rows", rows):
        got, exp = tpch.QUERIES[query](on_card), tpch.QUERIES[query](on_cpu)
    assert list(got._table.names) == list(exp._table.names) and len(got) == len(exp)
    for name in exp._table.names:
        g, e = got._table[name], exp._table[name]
        assert g.device.type == "cuda" and g.dtype == e.dtype, name
        if e.dtype.is_float:
            np.testing.assert_allclose(g.data.cpu().numpy(), e.data.numpy(), rtol=RTOL)
        else:
            assert g.to_numpy().tolist() == e.to_numpy().tolist(), name
