"""LIST and STRUCT columns of the port (``ops/lists.py``, ``ops/structs.py``,
the nested branches of ``core/column.py`` and ``ops/copying.py``, the
``.list`` / ``.struct`` accessors, ``explode``, ``str.split(expand=False)``
and ``str.findall``) against the reference's (``cudf_tpu``, JAX on the
CPU), after the reference's own ``tests/test_lists_structs.py``, and
against pandas for the Series and DataFrame surface.  Inputs are a few
hundred seeded rows with empty lists, null rows and null elements;
everything is exact (integer and string values, offsets, gathers).
"""

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

import cudf_tpu as ref
from cudf_tpu.core.column import Column as RefColumn
from cudf_tpu.ops import lists as ref_lists
from cudf_tpu.ops import structs as ref_structs
import cudf_tpu_torch as ct
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.ops import copying, lists, structs

torch.set_num_threads(1)

CPU = "cpu"
ROWS = 300


def _lists(seed, rows=ROWS, nulls=True, elem_nulls=True, strings=False):
    """Seeded host lists: lengths 0-6, about 8% null rows and 10% null
    elements, ints in [-20, 20) (or short strings)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(rows):
        if nulls and rng.random() < 0.08:
            out.append(None)
            continue
        vals = rng.integers(-20, 20, rng.integers(0, 7)).tolist()
        if strings:
            vals = ["s%d" % v for v in vals]
        out.append([None if elem_nulls and rng.random() < 0.1 else v for v in vals])
    return out


def _pair(data, dtype=None):
    return (ref_lists.from_pylists(data),
            lists.from_pylists(data, dtype, device=CPU))


def _norm(v):
    """NaN as None, in nested values too: the port gives a missing float
    pandas' NaN, the reference None."""
    if isinstance(v, list):
        return [_norm(x) for x in v]
    if isinstance(v, dict):
        return {k: _norm(x) for k, x in v.items()}
    return None if isinstance(v, float) and v != v else v


def _same(got: Column, exp: RefColumn):
    assert _norm(got.to_pylist()) == _norm(exp.to_pylist())


def test_from_to_pylists_and_layout():
    data = _lists(0)
    r, p = _pair(data)
    assert p.to_pylist() == data == r.to_pylist()
    assert p.offsets.tolist() == np.asarray(r.offsets).tolist()
    assert p.dtype.is_list and p.dtype.value_type == p.children[0].dtype
    made = lists.make_list_column(p.offsets, p.children[0], p.validity)
    assert made.to_pylist() == data


def test_count_elements():
    r, p = _pair(_lists(1))
    _same(lists.count_elements(p), ref_lists.count_elements(r))


@pytest.mark.parametrize("index", [0, 1, 3, -1, -2, -7])
def test_extract_list_element(index):
    r, p = _pair(_lists(2))
    _same(lists.extract_list_element(p, index), ref_lists.extract_list_element(r, index))


@pytest.mark.parametrize("outer", [False, True])
def test_explode(outer):
    r, p = _pair(_lists(3))
    child, rows = lists.explode(p, outer)
    rchild, rrows = ref_lists.explode(r, outer)
    _same(child, rchild)
    assert rows.tolist() == np.asarray(rrows).tolist()


@pytest.mark.parametrize("value", [0, 5, -20])
def test_contains_and_index_of(value):
    r, p = _pair(_lists(4))
    _same(lists.contains(p, value), ref_lists.contains(r, value))
    _same(lists.index_of(p, value), ref_lists.index_of(r, value))


def test_contains_strings():
    data = _lists(5, strings=True)
    r, p = _pair(data)
    _same(lists.contains(p, "s3"), ref_lists.contains(r, "s3"))


@pytest.mark.parametrize("k", [2, 3])
def test_concatenate_rows(k):
    pairs = [_pair(_lists(10 + i)) for i in range(k)]
    _same(lists.concatenate_rows([p for _, p in pairs]),
          ref_lists.concatenate_rows([r for r, _ in pairs]))


@pytest.mark.parametrize("ascending", [True, False])
def test_segmented_sort(ascending):
    r, p = _pair(_lists(6))
    _same(lists.segmented_sort(p, ascending), ref_lists.segmented_sort(r, ascending))


def test_unique_per_row():
    """The reference's null element sorts first there (its equality
    operands); the port's null element comes last, as in its sorts, and
    each row's distinct values are the same."""
    data = _lists(7)
    r, p = _pair(data)
    got, exp = lists.unique_per_row(p).to_pylist(), ref_lists.unique_per_row(r).to_pylist()
    for g, e, row in zip(got, exp, data):
        if row is None:
            assert g is None and e is None
            continue
        assert sorted(g, key=lambda v: (v is None, v)) == g
        assert set(g) == set(e) == set(row)
        assert len(g) == len(set(row))


def test_sequences():
    rng = np.random.default_rng(8)
    starts, sizes, steps = (rng.integers(-50, 50, 40), rng.integers(0, 6, 40),
                            rng.integers(-3, 4, 40))
    got = lists.sequences(Column.from_numpy(starts, device=CPU),
                          Column.from_numpy(sizes, device=CPU),
                          Column.from_numpy(steps, device=CPU))
    exp = ref_lists.sequences(RefColumn.from_numpy(starts), RefColumn.from_numpy(sizes),
                              RefColumn.from_numpy(steps))
    _same(got, exp)


def test_copying_of_lists():
    data = _lists(9)
    r, p = _pair(data)
    rng = np.random.default_rng(9)
    idx = rng.integers(-3, ROWS + 3, 200)
    from cudf_tpu.ops import copying as ref_copying

    _same(copying.gather(p, torch.from_numpy(idx)), ref_copying.gather(r, idx))
    _same(copying.slice(p, 17, 211), ref_copying.slice(r, 17, 211))
    _same(copying.concatenate([p, copying.slice(p, 5, 50)]),
          ref_copying.concatenate([r, ref_copying.slice(r, 5, 50)]))
    empty = copying.gather(copying.slice(p, 0, 0), torch.tensor([0, 1]))
    assert empty.to_pylist() == [None, None]
    for dtype in (p.dtype, structs.from_pydicts(_dicts(9), device=CPU).dtype):
        none = Column.empty(dtype, device=CPU)
        assert none.length == 0 and none.dtype == dtype and none.to_pylist() == []
        assert copying.concatenate([none, copying.gather(none, torch.tensor([0]))]).to_pylist() \
            == [None]
    rows = torch.tensor([3, 0])
    got = copying.scatter(copying.slice(p, 10, 12), rows, p).to_pylist()
    exp = list(data)
    exp[3], exp[0] = data[10], data[11]
    assert got == exp


def _dicts(seed, rows=ROWS):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(rows):
        if rng.random() < 0.08:
            out.append(None)
            continue
        d = {"a": int(rng.integers(0, 100)), "b": "x%d" % rng.integers(0, 9)}
        if rng.random() < 0.1:
            d["a"] = None
        if rng.random() < 0.3:
            d["c"] = int(rng.integers(0, 5))
        out.append(d)
    return out


def test_structs_from_to_pydicts_and_field():
    data = _dicts(20)
    r, p = ref_structs.from_pydicts(data), structs.from_pydicts(data, device=CPU)
    assert p.to_pylist() == r.to_pylist()
    assert [n for n, _ in p.dtype.fields] == [n for n, _ in r.dtype.fields]
    for name in ("a", "b", "c", 0):
        _same(structs.field(p, name), ref_structs.field(r, name))
    got, exp = structs.explode_to_table(p), ref_structs.explode_to_table(r)
    for name in ("a", "b", "c"):
        _same(got[name], exp[name])
    made = structs.make_struct_column([("a", p.children[0]), ("b", p.children[1])], p.validity)
    assert made.to_pylist() == [None if d is None else {"a": d["a"], "b": d["b"]}
                                for d in p.to_pylist()]


def test_copying_of_structs():
    from cudf_tpu.ops import copying as ref_copying

    data = _dicts(21)
    r, p = ref_structs.from_pydicts(data), structs.from_pydicts(data, device=CPU)
    idx = np.random.default_rng(21).integers(-2, ROWS + 2, 150)
    _same(copying.gather(p, torch.from_numpy(idx)), ref_copying.gather(r, idx))
    _same(copying.slice(p, 40, 90), ref_copying.slice(r, 40, 90))
    _same(copying.concatenate([p, p]), ref_copying.concatenate([r, r]))


@pytest.mark.parametrize("arr", [
    pa.array([[1.5, 2.5], None, [], [None, 4.0]]),
    pa.array([["a", None], [], None], pa.large_list(pa.string())),
    pa.array([{"x": 1, "y": 2.5}, None, {"x": None, "y": 0.5}]),
    pa.array([[{"v": 1}], [], None, [{"v": None}, {"v": 3}]]),
])
def test_arrow_round_trip(arr):
    col = Column.from_arrow(arr, device=CPU)
    assert col.to_arrow().to_pylist() == arr.to_pylist()
    assert _norm(col.to_pylist()) == _norm(RefColumn.from_arrow(arr).to_pylist())
    sliced = arr.slice(1, 2)
    assert _norm(Column.from_arrow(sliced, device=CPU).to_pylist()) == _norm(sliced.to_pylist())


# ----------------------------------------------------------------------
# the Series and DataFrame surface
# ----------------------------------------------------------------------

def _series(data):
    return ct.Series(data, device=CPU), ref.Series(data)


def test_list_accessor_matches_reference():
    data = _lists(30, elem_nulls=False)
    s, r = _series(data)
    for got, exp in [(s.list.len(), r.list.len()), (s.list.get(0), r.list.get(0)), (s.list.get(-1), r.list.get(-1)),
                     (s.list.contains(3), r.list.contains(3)), (s.list.index(3), r.list.index(3)),
                     (s.list.sort_values(), r.list.sort_values()),
                     (s.list.concat(s), r.list.concat(r))]:
        assert got._column.to_pylist() == exp._column.to_pylist()
    assert s.list.leaves._column.to_pylist() == r.list.leaves._column.to_pylist()


def test_struct_accessor_matches_reference():
    data = _dicts(31)
    s, r = _series(data)
    for name in ("a", "b"):
        assert s.struct.field(name)._column.to_pylist() == \
            r.struct.field(name)._column.to_pylist()
        assert s.struct.field(name).name == name
    assert list(s.struct.explode().columns) == list(r.struct.explode().columns)


def test_series_round_trip_and_to_arrow():
    data = _lists(32)
    s = ct.Series(data, device=CPU)
    assert s.to_pandas().tolist() == pd.Series(data).tolist()
    assert s.to_arrow().to_pylist() == data
    back = ct.Series(pd.Series(data), device=CPU)
    assert back._column.to_pylist() == data


@pytest.mark.parametrize("ignore_index", [False, True])
def test_series_explode_matches_pandas(ignore_index):
    data = _lists(33, elem_nulls=False)
    ps = pd.Series(data, index=np.arange(ROWS) * 3)
    got = ct.Series(ps, device=CPU).explode(ignore_index=ignore_index).to_pandas()
    exp = ps.explode(ignore_index=ignore_index)
    assert got.index.tolist() == exp.index.tolist()
    assert [None if pd.isna(v) else int(v) for v in got] == \
        [None if pd.isna(v) else int(v) for v in exp]


def test_dataframe_explode_matches_pandas():
    data = _lists(34, elem_nulls=False)
    pdf = pd.DataFrame({"k": np.arange(ROWS), "l": data})
    got = ct.DataFrame.from_pandas(pdf, device=CPU).explode("l").to_pandas()
    exp = pdf.explode("l")
    assert got["k"].tolist() == exp["k"].tolist()
    assert got.index.tolist() == exp.index.tolist()
    assert [None if pd.isna(v) else int(v) for v in got["l"]] == \
        [None if pd.isna(v) else int(v) for v in exp["l"]]


TEXT = ["a,b,,c", None, "", ",x", "abc", "q,", "id0012,7", "1,,2,,3"]


@pytest.mark.parametrize("pat,n", [(",", -1), (",", 1), (",,", -1), (None, -1)])
def test_split_lists_match_pandas(pat, n):
    text = TEXT + [" a  b c "]
    got = ct.Series(text, device=CPU).str.split(pat, n=n).to_pandas().tolist()
    exp = pd.Series(text, dtype=object).str.split(pat, n=n).tolist()
    assert got == [None if v is None or v is np.nan else v for v in exp]


def test_split_lists_on_the_device():
    from cudf_tpu_torch.ops.strings import STRING_ROUTES

    before = STRING_ROUTES["host"]
    s = ct.Series(TEXT, device=CPU).str.split(",")
    assert STRING_ROUTES["host"] == before
    assert s.dtype.is_list and s.dtype.value_type.is_string
    assert _norm(s.list.len().to_pandas().tolist()[:3]) == [4, None, 1]


@pytest.mark.parametrize("pat", [r"[1-9]+", r"\d", r"[a-z]+\d?", r"(\d)(\d)"])
def test_findall_matches_reference(pat):
    text = TEXT + ["id0000000123", "99 8 ", None]
    got = ct.Series(text, device=CPU).str.findall(pat).to_pandas().tolist()
    exp = pd.Series(text, dtype=object).str.findall(pat).tolist()
    # several groups: pandas' tuples are the port's lists (a LIST of LISTs)
    assert got == [None if v is None or v is np.nan else
                   [list(t) if isinstance(t, tuple) else t for t in v] for v in exp]
    if "(" not in pat:           # the reference's Arrow lists hold no tuples
        assert ref.Series(text).str.findall(pat)._column.to_pylist() == got
