"""The port's row operators, sort, compaction and copying primitives
(``cudf_tpu_torch/ops/row_ops.py``, ``sort.py``, ``stream_compaction.py``,
``copying.py``, ``_utils.py``, ``replace.py``) against cudf_tpu on the
JAX CPU backend (its sort tier reaches no Pallas kernel), on the same
seeded numpy inputs.

Everything here is exact: operands, permutations, hashes and ranks are
compared value for value (ranks are float64 quotients computed the same
way on both sides).  Where the reference is at fault (ROADMAP.md queue
3), the port is held to pandas: a NaN with its sign bit set orders
below -inf in the reference, the data under a null splits a null group
before a later key, and a dense pct rank counts the null run.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from cudf_tpu.core.column import Column as RefColumn
from cudf_tpu.core.table import Table as RefTable
from cudf_tpu.ops import _utils as ref_utils
from cudf_tpu.ops import copying as ref_copying
from cudf_tpu.ops import groupby as ref_groupby
from cudf_tpu.ops import row_ops as ref_row_ops
from cudf_tpu.ops import sort as ref_sort
from cudf_tpu.ops import stream_compaction as ref_sc
import cudf_tpu_torch as ct
from cudf_tpu_torch.core.table import Table
from cudf_tpu_torch.ops import _utils, copying, row_ops
from cudf_tpu_torch.ops import groupby as gb
from cudf_tpu_torch.ops import sort as sort_ops
from cudf_tpu_torch.ops import stream_compaction as sc
from cudf_tpu_torch.ops.replace import nans_to_nulls, normalize_nans_and_zeros

torch.set_num_threads(1)

CPU = torch.device("cpu")
N = 257
INTS = [np.int8, np.int16, np.int32, np.int64, np.uint8, np.uint16, np.uint32, np.uint64]
DTYPES = INTS + [np.float32, np.float64, np.bool_]
SPECIALS = [np.nan, 0.0, -0.0, np.inf, -np.inf]


def _values(rng, dtype, n=N, distinct=None):
    """Seeded values of dtype: ints over their whole range (or a few
    values), floats with NaN, +-0.0 and +-inf, bools."""
    dtype = np.dtype(dtype)
    if dtype == np.bool_:
        return rng.random(n) > 0.5
    if dtype.kind in "iu":
        info = np.iinfo(dtype)
        if distinct:
            return rng.integers(0, distinct, n).astype(dtype)
        return rng.integers(int(info.min), int(info.max), n, dtype=dtype, endpoint=True)
    x = (rng.normal(size=n) * 1e3).astype(dtype)
    if distinct:
        x = rng.integers(0, distinct, n).astype(dtype)
    at = rng.choice(n, 5 * 6, replace=False).reshape(5, 6)
    for spec, rows in zip(SPECIALS, at):
        x[rows] = spec
    return x


def _pair(x, valid=None):
    """(reference column, port column) over the same buffers; the data
    under a null is 0 in both (see order_keys)."""
    if valid is not None:
        x = np.where(valid, x, np.zeros(1, x.dtype))
    ref = RefColumn.from_numpy(x, mask=valid)
    return ref, ct.from_buffers(x.dtype, x.shape[0], x, valid, device=CPU)


def _np(t):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return t


def _same(got, exp, what=""):
    got, exp = _np(got), _np(exp)
    assert got.dtype == exp.dtype, (what, got.dtype, exp.dtype)
    np.testing.assert_array_equal(got, exp, err_msg=str(what))


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("nulls", [False, True])
def test_row_operands_and_hash_match_reference(dtype, nulls):
    """order_keys (both directions, nulls first and last), equality_keys
    and row_hash equal the reference's operand for operand, bit for bit."""
    rng = np.random.default_rng(1)
    x = _values(rng, dtype)
    valid = rng.random(N) > 0.2 if nulls else None
    ref, port = _pair(x, valid)
    for asc in (True, False):
        for na in ("first", "last"):
            got = row_ops.order_keys(port, asc, na)
            exp = ref_row_ops.order_keys(ref, asc, na)
            assert len(got) == len(exp)
            for g, e in zip(got, exp):
                _same(g, e, (asc, na))
    for g, e in zip(row_ops.equality_keys(port), ref_row_ops.equality_keys(ref)):
        e = np.asarray(e)
        _same(g, e.view(np.int64) if e.dtype == np.uint64 else
              e.astype(np.int64) if e.dtype in (np.uint16, np.uint32) else e)
    for seed in (0, 7):
        _same(row_ops.row_hash([port], seed).view(torch.uint64).numpy().astype(np.uint64),
              ref_row_ops.row_hash([ref], seed))
        _same(row_ops.hash_column(port, seed), row_ops.row_hash([port], seed))


def test_negative_nan_orders_as_nan_and_hashes_as_nan():
    """A NaN with its sign bit set (numpy's -np.nan) orders above +inf, as
    pandas sorts NaN, where the reference puts it below -inf; its equality
    operand and hash are the reference's (which canonicalises there)."""
    x = np.array([1.0, -np.nan, np.nan, -np.inf, np.inf, 0.0, -0.0, -2.5])
    assert np.signbit(x[1])
    ref, port = _pair(x)
    canon = RefColumn.from_numpy(np.where(np.isnan(x), np.nan, x))
    for asc in (True, False):
        _same(row_ops.order_keys(port, asc)[0], ref_row_ops.order_keys(canon, asc)[0])
    order = row_ops.lex_sort_indices([port]).numpy()
    assert set(order[-2:]) == {1, 2}
    assert list(np.asarray(ref_row_ops.lex_sort_indices([ref]))[:1]) == [1]   # the fault
    exp = pd.Series(x).sort_values(kind="stable").index.to_numpy()
    np.testing.assert_array_equal(order, exp)
    for g, e in zip(row_ops.equality_keys(port), ref_row_ops.equality_keys(ref)):
        _same(g, e)
    _same(row_ops.row_hash([port]).view(torch.uint64).numpy().astype(np.uint64),
          ref_row_ops.row_hash([ref]))


@pytest.mark.parametrize("ascending", [[True, True, True], [False, True, False]])
@pytest.mark.parametrize("na_position", ["first", "last"])
def test_lex_sort_indices_three_keys_match_reference(ascending, na_position):
    """The LSD chain of stable argsorts equals the reference's single
    stable lax.sort permutation exactly, over three keys with ties."""
    rng = np.random.default_rng(2)
    cols = [(_values(rng, np.int32, distinct=4), rng.random(N) > 0.2),
            (_values(rng, np.float64, distinct=5), rng.random(N) > 0.1),
            (_values(rng, np.uint64, distinct=3), None)]
    pairs = [_pair(x, v) for x, v in cols]
    got = row_ops.lex_sort_indices([p for _, p in pairs], ascending, na_position)
    exp = ref_row_ops.lex_sort_indices([r for r, _ in pairs], ascending, na_position)
    _same(got, exp)
    _same(sort_ops.sorted_order([p for _, p in pairs], ascending, na_position), exp)


def test_rows_equal_at_and_null_groups():
    """rows_equal_at is the reference's; null rows form one group before
    a later key whatever data lies under them (the reference splits it)."""
    rng = np.random.default_rng(3)
    x, v = _values(rng, np.int64, distinct=3), rng.random(N) > 0.3
    y = _values(rng, np.float32, distinct=2)
    (ra, pa), (rb, pb) = _pair(x, v), _pair(y)
    li, ri = rng.integers(0, N, 50), rng.integers(0, N, 50)
    _same(row_ops.rows_equal_at([pa, pb], torch.from_numpy(li), torch.from_numpy(ri)),
          ref_row_ops.rows_equal_at([ra, rb], li, ri))
    data = np.array([5, 7, 9, 1], dtype=np.int64)
    a = ct.from_buffers(np.int64, 4, data, np.array([False, False, False, True]), device=CPU)
    b = ct.from_buffers(np.int64, 4, np.array([1, 0, 1, 0]), None, device=CPU)
    g = gb.make_grouper([a, b], dropna=False)
    exp = pd.DataFrame({"a": pd.array([None, None, None, 1], dtype="Int64"), "b": [1, 0, 1, 0]})
    assert g.num_groups == exp.groupby(["a", "b"], dropna=False).ngroups == 3
    np.testing.assert_array_equal(g.group_ids.numpy(), [2, 1, 2, 0])


@pytest.mark.parametrize("method", ["average", "min", "max", "first", "dense"])
@pytest.mark.parametrize("na_option", ["keep", "top", "bottom"])
@pytest.mark.parametrize("ascending", [True, False])
def test_rank_matches_reference(method, na_option, ascending):
    rng = np.random.default_rng(4)
    x, v = _values(rng, np.float64, distinct=20), rng.random(N) > 0.15
    x[np.isnan(x)] = 3.0                         # NaN is a value here; pandas nulls it
    ref, port = _pair(x, v)
    for pct in (False, True):
        got = sort_ops.rank(port, method, ascending, na_option, pct)
        exp = ref_sort.rank(ref, method, ascending, na_option, pct)
        if method == "dense" and pct and na_option == "keep":
            # the reference counts the null run among the dense ranks
            exp_pd = pd.Series(np.where(v, x, np.nan)).rank(
                method=method, ascending=ascending, na_option=na_option, pct=pct)
            np.testing.assert_allclose(got.to_numpy(), exp_pd.to_numpy(), rtol=1e-15)
            continue
        _same(got.data, exp.data, (method, na_option, pct))
        assert (got.validity is None) == (exp.validity is None)
        if got.validity is not None:
            _same(got.validity, exp.validity)
        exp_pd = pd.Series(np.where(v, x, np.nan)).rank(
            method=method, ascending=ascending, na_option=na_option, pct=pct)
        np.testing.assert_allclose(got.to_numpy(), exp_pd.to_numpy(), rtol=1e-15)


@pytest.mark.parametrize("dtype", [np.int32, np.uint64, np.float64, np.bool_],
                         ids=lambda d: np.dtype(d).name)
def test_top_k_is_sorted_and_segmented_sort_match_reference(dtype):
    rng = np.random.default_rng(5)
    x = _values(rng, dtype, distinct=None if dtype != np.float64 else 40)
    x = np.where(np.isnan(x), 1.5, x) if dtype == np.float64 else x
    for valid in (None, rng.random(N) > 0.2):
        ref, port = _pair(x, valid)
        for largest in (True, False):
            got = sort_ops.top_k(port, 9, largest)
            exp = ref_sort.top_k(ref, 9, largest)
            _same(got.data, exp.data)
            _same(sort_ops.top_k_order(port, 9, largest), ref_sort.top_k_order(ref, 9, largest))
        srt = sort_ops.sort(port)
        assert sort_ops.is_sorted([srt]) and ref_sort.is_sorted([ref_sort.sort(ref)])
        assert sort_ops.is_sorted([port]) == ref_sort.is_sorted([ref])
        assert not sort_ops.is_sorted([srt], [False]) or len(set(x)) == 1
        seg = np.sort(rng.integers(0, 6, N))
        _same(sort_ops.segmented_sort_indices(torch.from_numpy(seg), [port], [False]),
              ref_sort.segmented_sort_indices(seg, [ref], [False]))


@pytest.mark.parametrize("keep", ["first", "last", False])
def test_distinct_family_matches_reference(keep):
    rng = np.random.default_rng(6)
    a, va = _values(rng, np.int16, distinct=4), rng.random(N) > 0.2
    b = _values(rng, np.float32, distinct=3)
    (ra, pa), (rb, pb) = _pair(a, va), _pair(b)
    ref_keep = keep if keep else "none"
    _same(sc.distinct_indices([pa, pb], ref_keep), ref_sc.distinct_indices([ra, rb], ref_keep))
    _same(sc.duplicated_mask([pa, pb], keep), ref_sc.duplicated_mask([ra, rb], keep))
    got = sc.distinct(Table({"a": pa, "b": pb}), ["a"], ref_keep)
    exp = ref_sc.distinct(RefTable({"a": ra, "b": rb}), ["a"], ref_keep)
    _same(got["b"].data, exp["b"].data)
    for dropna in (True, False):
        assert sc.distinct_count(pb, dropna) == ref_sc.distinct_count(rb, dropna)
        assert sc.distinct_count(pa, dropna) == ref_sc.distinct_count(ra, dropna)
    srt = sort_ops.sort(pb)
    _same(sc.unique(srt).data, ref_sc.unique(ref_sort.sort(rb)).data)
    pdf = pd.DataFrame({"a": pd.array(np.where(va, a, 0), dtype="Int16"), "b": b})
    pdf.loc[~va, "a"] = pd.NA
    np.testing.assert_array_equal(sc.duplicated_mask([pa, pb], keep).numpy(),
                                  pdf.duplicated(keep=keep).to_numpy())


def test_compaction_and_copying_match_reference():
    rng = np.random.default_rng(7)
    x, v = _values(rng, np.int64), rng.random(N) > 0.3
    m, mv = rng.random(N) > 0.5, rng.random(N) > 0.1
    (rx, px), (rm, pm) = _pair(x, v), _pair(m, mv)
    _same(sc.apply_boolean_mask(px, pm).data, ref_sc.apply_boolean_mask(rx, rm).data)
    _same(sc.drop_nulls(px).data, ref_sc.drop_nulls(rx).data)
    for how in ("any", "all"):
        got = sc.drop_nulls_table(Table({"x": px, "m": pm}), how=how)
        exp = ref_sc.drop_nulls_table(RefTable({"x": rx, "m": rm}), how=how)
        _same(got["x"].data, exp["x"].data)
    got = sc.apply_boolean_mask_table(Table({"x": px}), pm)
    _same(got["x"].data, ref_sc.apply_boolean_mask_table(RefTable({"x": rx}), rm)["x"].data)
    y, vy = _values(rng, np.int64, 40), rng.random(40) > 0.5
    (ry, py) = _pair(y, vy)
    smap = rng.choice(N, 40, replace=False)
    got = copying.scatter(py, torch.from_numpy(smap), px)
    exp = ref_copying.scatter(ry, smap, rx)
    _same(got.data, exp.data)
    _same(got.validity, exp.validity)
    for a, b in zip(copying.split(px, [10, 100]), ref_copying.split(rx, [10, 100])):
        _same(a.data, b.data)
        _same(a.validity, b.validity)
    _same(copying.slice(px, 250, 400).data, ref_copying.slice(rx, 250, 400).data)
    got = copying.concatenate([px, py, copying.reverse(px)])
    exp = ref_copying.concatenate([rx, ry, ref_copying.reverse(rx)])
    _same(got.data, exp.data)
    _same(got.validity, exp.validity)
    got = copying.concatenate_tables([Table({"x": px}), Table({"x": py})])
    _same(got["x"].data, ref_copying.concatenate_tables([RefTable({"x": rx}),
                                                          RefTable({"x": ry})])["x"].data)
    _same(copying.sequence(7, 3, -2, np.int32, device=CPU).data,
          ref_copying.sequence(7, 3, -2, np.int32).data)
    gm = rng.integers(-3, N + 3, 60)
    got, exp = copying.gather(px, torch.from_numpy(gm)), ref_copying.gather(rx, gm)
    _same(got.data[got.validity], np.asarray(exp.data)[np.asarray(exp.validity)])


def test_utils_and_replace_match_reference():
    rng = np.random.default_rng(8)
    perm = rng.permutation(N)
    _same(_utils.inverse_permutation(torch.from_numpy(perm)),
          ref_utils.inverse_permutation(perm))
    offs = np.concatenate([[0], np.cumsum(rng.integers(0, 5, 30))])
    _same(_utils.segment_expand(torch.from_numpy(offs), int(offs[-1])),
          ref_utils.segment_expand(offs, int(offs[-1])))
    assert _utils.maybe_mask(torch.ones(4, dtype=torch.bool)) is None
    assert _utils.maybe_mask(torch.tensor([True, False])) is not None
    x = np.array([1.0, -0.0, -np.nan, np.nan, 2.0])
    col = ct.from_buffers(np.float64, 5, x, None, device=CPU)
    norm = normalize_nans_and_zeros(col).data.view(torch.int64)
    assert norm[1] == 0 and norm[2] == norm[3] == np.array(np.nan).view(np.int64)
    assert nans_to_nulls(col).validity.tolist() == [True, True, False, False, True]
    ints = ct.from_buffers(np.int64, 2, np.array([1, 2]), None, device=CPU)
    assert nans_to_nulls(ints) is ints


@pytest.mark.parametrize("key_dtypes,dropna", [
    ((np.int32,), False), ((np.int32,), True), ((np.float64, np.int16), False),
    ((np.bool_, np.uint64, np.float32), True)],
    ids=["int32", "int32-dropna", "float64-int16", "bool-uint64-float32-dropna"])
def test_make_grouper_matches_reference(key_dtypes, dropna):
    """group_ids, num_groups, key_rows, sorted_order, group_offsets and
    the row mask equal the reference's, one and three keys, with nulls
    and NaN keys."""
    rng = np.random.default_rng(9)
    pairs = []
    for j, d in enumerate(key_dtypes):
        x = _values(rng, d, distinct=4)
        pairs.append(_pair(x, rng.random(N) > 0.15 if j == 0 else None))
    got = gb.make_grouper([p for _, p in pairs], dropna=dropna)
    exp = ref_groupby.make_grouper([r for r, _ in pairs], dropna=dropna)
    assert got.num_groups == exp.num_groups
    for field in ("group_ids", "key_rows", "sorted_order", "group_offsets"):
        _same(getattr(got, field), getattr(exp, field), field)
    assert (got.row_mask is None) == (exp.row_mask is None)
    if got.row_mask is not None:
        _same(got.row_mask, exp.row_mask)
        _same(got.kept_rows, np.nonzero(np.asarray(exp.row_mask))[0])
