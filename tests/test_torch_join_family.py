"""The join family's ops (``cudf_tpu_torch/ops/join.py``) against the
reference's (``cudf_tpu.ops.join`` on the JAX CPU backend), on the same
seeded numpy inputs: the port's columns are built over the reference
columns' buffers.

Inner, left, full, semi, anti and cross joins, the mixed joins,
``merge_sorted``, ``HashJoin`` and ``DistinctHashJoin``; one and two keys
over int64, int32, float64 (NaN and -0.0 included), string and
dictionary keys (two dictionaries over different, overlapping keys);
nulls on neither side, one side and both, under ``nulls_equal`` True and
False.  Gather maps must be equal, order included.  Where the reference
is wrong, pandas decides (a dictionary key over "a" and "a\x00").

Shapes stay fixed (40 left and 30 right rows, a fifth of a masked side
null) so that the reference's eager ops compile for few shapes; the
file must stay under 60 s alone.  (``tests/test_torch_join_merge.py``
holds ``DataFrame.merge`` and the engine's joins.)
"""

import numpy as np
import pandas as pd
import pytest
import torch

import torch_jax_cache  # noqa: F401  (the run's shared JAX compile cache)
from cudf_tpu.core import dtypes as ref_dt
from cudf_tpu.core.column import Column as RefColumn
from cudf_tpu.ops import join as ref_join
from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.ops import join
from cudf_tpu_torch.utils.config import option_context

torch.set_num_threads(1)

CPU = torch.device("cpu")
NL, NR = 40, 30
STRINGS = ["", "a", "a\x00", "ab", "abcdefghij", "b", "zz", "abcdefghijk"]


def port_of(ref: RefColumn) -> Column:
    """The port's column over a reference column's buffers."""
    d = dt.DType(dt.TypeId[ref.dtype.id.name])
    if ref.dtype.is_dictionary:
        keys = port_of(ref.children[0])
        d = dt.dictionary_dtype(keys.dtype if keys.dtype.is_numeric else dt.STRING)
    validity = None if ref.validity is None else torch.from_numpy(np.asarray(ref.validity).copy())
    offsets = None if ref.offsets is None else torch.from_numpy(np.asarray(ref.offsets).copy())
    return Column(d, ref.length, torch.from_numpy(np.asarray(ref.data).copy()), validity,
                  offsets, tuple(port_of(c) for c in ref.children))


def _values(kind, n, rng, side):
    if kind == "int64":
        return rng.integers(0, 9, n)
    if kind == "int32":
        return rng.integers(-3, 6, n).astype(np.int32)
    if kind == "float64":
        return rng.choice(np.array([0.0, -0.0, 1.5, np.nan, -2.0, 7.25]), n)
    if kind == "str":
        return list(rng.choice(STRINGS, n))
    # dictionary codes over two different, overlapping key sets
    return rng.integers(0, 5 if side == "l" else 4, n).astype(np.int32)


DICT_KEYS = {"l": ["x", "a", "zz", "a\x00", "q"], "r": ["zz", "a", "w", "x"]}


def _ref_column(kind, vals, mask, side):
    if kind == "str":
        strings = [s if m else None for s, m in zip(vals, mask)] if mask is not None else vals
        return RefColumn.from_strings(strings)
    if kind == "dict":
        return RefColumn(ref_dt.dictionary_dtype(ref_dt.STRING), len(vals), data=vals,
                         validity=None if mask is None else np.asarray(mask),
                         children=(RefColumn.from_strings(DICT_KEYS[side]),))
    return RefColumn.from_numpy(vals, mask=mask)


KEY_CASES = {"int64": ["int64"], "int32": ["int32"], "float64": ["float64"], "str": ["str"],
             "dict": ["dict"], "int32_str": ["int32", "str"], "int64_float64": ["int64", "float64"],
             "dict_int64": ["dict", "int64"]}


def _keys(case, nulls, seed):
    """(reference key columns, port key columns) of both sides."""
    rng = np.random.default_rng(seed)
    out = {}
    for side, n in (("l", NL), ("r", NR)):
        masked = nulls == "both" or (nulls == "left" and side == "l") or (
            nulls == "right" and side == "r")
        refs = []
        for kind in KEY_CASES[case]:
            mask = None
            if masked:
                mask = np.ones(n, bool)
                mask[rng.choice(n, n // 5, replace=False)] = False
            refs.append(_ref_column(kind, _values(kind, n, rng, side), mask, side))
        out[side] = (refs, [port_of(c) for c in refs])
    return out["l"], out["r"]


def _same_maps(got, exp):
    got = got if isinstance(got, tuple) else (got,)
    exp = exp if isinstance(exp, tuple) else (exp,)
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e).astype(np.int64))


JOINS = ["inner_join", "left_join", "full_join", "semi_join", "anti_join"]


CASES = [("int64", "none", True), ("int64", "both", False), ("int32", "left", False),
         ("float64", "both", True), ("str", "both", True), ("dict", "none", True),
         ("int32_str", "both", True), ("int64_float64", "left", True),
         ("dict_int64", "both", False)]


@pytest.mark.parametrize("case,nulls,nulls_equal", CASES)
def test_joins_match_reference(case, nulls, nulls_equal):
    (rl, pl), (rr, pr) = _keys(case, nulls, seed=len(case) + len(nulls))
    for fn in JOINS:
        got = getattr(join, fn)(pl, pr, nulls_equal=nulls_equal)
        exp = getattr(ref_join, fn)(rl, rr, nulls_equal=nulls_equal)
        _same_maps(got, exp)


@pytest.mark.parametrize("case", ["dict"])
def test_right_nulls_and_empty_sides_match_reference(case):
    (rl, pl), (rr, pr) = _keys(case, "right", seed=3)
    for fn in JOINS:
        for ne in (True, False):
            _same_maps(getattr(join, fn)(pl, pr, nulls_equal=ne),
                       getattr(ref_join, fn)(rl, rr, nulls_equal=ne))
    empty_p = [Column(c.dtype, 0, c.data[:0], children=c.children, offsets=(
        c.offsets[:1] if c.offsets is not None else None)) for c in pr]
    for fn in ("inner_join", "left_join", "full_join"):
        li, ri = getattr(join, fn)(pl, empty_p)
        assert (li.tolist(), ri.tolist()) == (([], []) if fn == "inner_join" else
                                              (list(range(NL)), [-1] * NL))
        ri, li = getattr(join, fn)(empty_p, pl)
        assert len(li) == (NL if fn == "full_join" else 0)


def test_cross_join_matches_reference():
    _same_maps(join.cross_join(4, 3, device=CPU), ref_join.cross_join(4, 3))
    _same_maps(join.cross_join(0, 3, device=CPU), ref_join.cross_join(0, 3))
    with pytest.raises(TypeError):                   # the device is the caller's to name
        join.cross_join(4, 3)


def test_dictionary_keys_follow_pandas_on_trailing_nul():
    """Dictionaries over "a" and "a\\x00": pandas tells them apart (bytes,
    then length); so does the port's shared code space."""
    lk, rk = ["a", "a\x00", "b"], ["b", "a\x00", "c", "a"]
    lcodes, rcodes = np.array([0, 1, 2, 0, 1], np.int32), np.array([3, 1, 0, 2], np.int32)
    lcol = Column.from_dictionary(torch.from_numpy(lcodes), Column.from_strings(lk, device=CPU))
    rcol = Column.from_dictionary(torch.from_numpy(rcodes), Column.from_strings(rk, device=CPU))
    li, ri = join.inner_join([lcol], [rcol])
    exp = pd.DataFrame({"k": [lk[c] for c in lcodes]}, dtype=object).reset_index().merge(
        pd.DataFrame({"k": [rk[c] for c in rcodes]}, dtype=object).reset_index(), on="k")
    assert len(exp) == 5
    assert li.tolist() == exp["index_x"].tolist() and ri.tolist() == exp["index_y"].tolist()


def test_mixed_joins_match_reference():
    (rl, pl), (rr, pr) = _keys("int64", "none", seed=5)
    rng = np.random.default_rng(5)
    lv, rv = rng.normal(size=NL), rng.normal(size=NR)

    def pred(li, ri):
        return torch.from_numpy(lv)[li] < torch.from_numpy(rv)[ri]

    def ref_pred(li, ri):
        return np.asarray(lv)[np.asarray(li)] < np.asarray(rv)[np.asarray(ri)]

    for fn in ("mixed_inner_join", "mixed_left_join", "mixed_semi_join", "mixed_anti_join"):
        _same_maps(getattr(join, fn)(pl, pr, pred), getattr(ref_join, fn)(rl, rr, ref_pred))


def test_merge_sorted_matches_reference():
    rng = np.random.default_rng(6)
    parts = [np.sort(rng.integers(0, 20, n)) for n in (7, 5, 9)]
    refs = [[RefColumn.from_numpy(p)] for p in parts]
    _same_maps(join.merge_sorted([[port_of(c) for c in r] for r in refs]),
               ref_join.merge_sorted(refs))


@pytest.mark.parametrize("case,nulls_equal", [("int32_str", True), ("str", False)])
def test_hash_joins_match_reference(case, nulls_equal):
    (rl, pl), (rr, pr) = _keys(case, "both", seed=7)
    hj, ref_hj = join.HashJoin(pr, nulls_equal), ref_join.HashJoin(rr, nulls_equal)
    for _ in range(2):                               # the build is reused
        for fn in ("inner_join", "left_join", "semi_join", "anti_join"):
            _same_maps(getattr(hj, fn)(pl), getattr(ref_hj, fn)(rl))
    rng = np.random.default_rng(8)
    build = RefColumn.from_numpy(rng.permutation(NR).astype(np.int64))
    probe = RefColumn.from_numpy(rng.integers(-3, NR + 3, NL))
    _same_maps(join.DistinctHashJoin([port_of(build)]).inner_join([port_of(probe)]),
               ref_join.DistinctHashJoin([build]).inner_join([probe]))


def test_hash_join_reprobed_by_other_dictionaries():
    """One ``HashJoin`` probed in turn by dictionaries of one size over
    the same words in other orders: the smaller build side is recoded
    into each probe's code space anew, never reused from an earlier one."""
    words = ["p", "q", "r", "s", "t", "u"]
    bwords, bcodes = ["s", "q", "u"], [0, 1, 2, 0, 1]
    build = Column.from_dictionary(torch.tensor(bcodes, dtype=torch.int32),
                                   Column.from_strings(bwords, device=CPU))
    hj = join.HashJoin([build])
    rng = np.random.default_rng(9)
    pcodes = rng.integers(0, len(words), 8).astype(np.int32)
    for _ in range(6):
        perm = list(rng.permutation(words))
        probe = Column.from_dictionary(torch.from_numpy(pcodes.copy()),
                                       Column.from_strings(perm, device=CPU))
        li, ri = hj.inner_join([probe])
        exp = [(i, j) for i, c in enumerate(pcodes) for j, b in enumerate(bcodes)
               if perm[c] == bwords[b]]
        assert list(zip(li.tolist(), ri.tolist())) == exp
        del probe, li, ri


@pytest.mark.parametrize("min_rows", [1, 1 << 16])
def test_uint64_key_against_int64_key(min_rows):
    """A uint64 key against an int64 key matches by value on every tier:
    2**64 - 1 and 2**63 match no negative key (the radix tier tries the
    join from 1 probe row up, the dense tier from 2 build rows)."""
    u = np.array([2**64 - 1, 5, 3, 2**63, 0, 5], np.uint64)
    s = np.array([-1, 3, 5, 7], np.int64)
    ucol, scol = Column.from_numpy(u, device=CPU), Column.from_numpy(s, device=CPU)
    with option_context("join.fast_path_min_rows", min_rows):
        for lv, rv, lc, rc in ((u, s, ucol, scol), (s, u, scol, ucol)):
            exp = [(i, j) for i, a in enumerate(lv.tolist()) for j, b in enumerate(rv.tolist())
                   if a == b]
            li, ri = join.inner_join([lc], [rc])
            assert list(zip(li.tolist(), ri.tolist())) == exp
            assert join.semi_join([lc], [rc]).tolist() == sorted({i for i, _ in exp})
