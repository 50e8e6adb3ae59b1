"""LIST, STRUCT and decimal columns on the card: every op of
``ops/lists.py``, ``ops/structs.py``, ``ops/decimal.py`` and
``ops/decimal128.py``, the list aggregations of ``ops/groupby.py``, the
nested gathers, slices and concatenations of ``ops/copying.py``, explode,
the ``list`` / ``struct`` accessors, ``str.split(expand=False)``,
``str.findall`` and every ``models/nested.py`` request on CUDA tensors,
each against the same call on CPU tensors, with null rows, empty lists,
null elements and all-null structs.

Marked ``cuda``: without a CUDA device every test here skips (decided in
the fixture, never at import).  On a machine with a card run
``python -m pytest tests/test_torch_cuda_nested.py -q --noconftest``.
Everything exact (offsets, values, validity, limbs).  Every output stays
on the card, and no call takes a host route.
"""

import decimal as D

import pytest
import torch

import cudf_tpu_torch as ct
from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.models import nested
from cudf_tpu_torch.models import strings_dt as sd
from cudf_tpu_torch.models import tpch
from cudf_tpu_torch.ops import copying, lists, structs
from cudf_tpu_torch.ops import decimal as dec
from cudf_tpu_torch.ops import decimal128 as d128
from cudf_tpu_torch.ops import groupby as gb
from cudf_tpu_torch.ops._utils import HOST_ROUTES
from cudf_tpu_torch.ops.strings import STRING_ROUTES

pytestmark = pytest.mark.cuda

CPU = torch.device("cpu")
N = 50_000


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _list_parts(rows, device, seed=1):
    """A LIST<INT64> column of ``rows`` rows built from tensors: lengths
    0-6 (a tenth empty), every 13th row null, every 9th element null."""
    g = torch.Generator().manual_seed(seed)
    lens = torch.randint(0, 7, (rows,), generator=g)
    lens[torch.arange(rows) % 10 == 3] = 0
    valid = torch.arange(rows) % 13 != 5
    lens = torch.where(valid, lens, 0)
    offsets = torch.zeros(rows + 1, dtype=torch.int64)
    torch.cumsum(lens, 0, out=offsets[1:])
    total = int(offsets[-1])
    vals = torch.randint(-30, 30, (total,), generator=g)
    child = Column(dt.INT64, total, vals.to(device),
                   (torch.arange(total) % 9 != 4).to(device))
    return lists.make_list_column(offsets.to(device), child, valid.to(device))


def _col(c: Column, device) -> None:
    """Every buffer of a column (children included) lives on ``device``."""
    for t in (c.data, c.validity, c.offsets):
        assert t is None or t.device.type == device.type
    for child in c.children:
        _col(child, device)


def _norm(v):
    """NaN as None, in nested values too (NaN != NaN)."""
    if isinstance(v, list):
        return [_norm(x) for x in v]
    if isinstance(v, dict):
        return {k: _norm(x) for k, x in v.items()}
    return None if isinstance(v, float) and v != v else v


def _same(got: Column, exp: Column, dev) -> None:
    _col(got, dev)
    assert got.dtype == exp.dtype
    assert _norm(got.to_pylist()) == _norm(exp.to_pylist())


LIST_OPS = {
    "count_elements": lists.count_elements,
    "get_0": lambda c: lists.extract_list_element(c, 0),
    "get_last": lambda c: lists.extract_list_element(c, -1),
    "get_5": lambda c: lists.extract_list_element(c, 5),
    "contains": lambda c: lists.contains(c, 3),
    "index_of": lambda c: lists.index_of(c, -7),
    "sort_asc": lists.segmented_sort,
    "sort_desc": lambda c: lists.segmented_sort(c, False),
    "unique": lists.unique_per_row,
    "concat_rows": lambda c: lists.concatenate_rows([c, c, copying.reverse(c)]),
    "gather": lambda c: copying.gather(c, torch.arange(-5, c.length + 5, 3, device=c.device)),
    "slice": lambda c: copying.slice(c, 101, 9000),
    "concatenate": lambda c: copying.concatenate([c, copying.slice(c, 7, 300)]),
    "all_null_gather": lambda c: copying.gather(copying.slice(c, 0, 0),
                                                torch.zeros(4, dtype=torch.int64,
                                                            device=c.device)),
}


@pytest.mark.parametrize("name", list(LIST_OPS))
def test_list_ops_on_the_card(dev, name):
    cpu, cuda = _list_parts(N, CPU), _list_parts(N, dev)
    before = dict(HOST_ROUTES)
    got = LIST_OPS[name](cuda)
    assert HOST_ROUTES == before
    _same(got, LIST_OPS[name](cpu), dev)


@pytest.mark.parametrize("outer", [False, True])
def test_explode_on_the_card(dev, outer):
    cpu, cuda = _list_parts(N, CPU), _list_parts(N, dev)
    (gc, gr), (ec, er) = lists.explode(cuda, outer), lists.explode(cpu, outer)
    _same(gc, ec, dev)
    assert torch.equal(gr.cpu(), er)


def test_sequences_on_the_card(dev):
    g = torch.Generator().manual_seed(2)
    starts, sizes = torch.randint(-9, 9, (N,), generator=g), torch.randint(0, 5, (N,), generator=g)
    steps = torch.randint(-2, 3, (N,), generator=g)

    def run(device):
        return lists.sequences(*(Column.from_tensor(t.to(device)) for t in (starts, sizes, steps)))
    _same(run(dev), run(CPU), dev)


def _structs(device):
    """STRUCT<a: int64, b: LIST<INT64>> with null rows and null fields, and
    an all-null STRUCT."""
    parts = _list_parts(N, device, seed=3)
    a = Column(dt.INT64, N, torch.arange(N, device=device),
               torch.arange(N, device=device) % 7 != 0)
    rows = torch.arange(N, device=device) % 5 != 1
    return structs.make_struct_column([("a", a), ("b", parts)], rows)


STRUCT_OPS = {
    "field_a": lambda c: structs.field(c, "a"),
    "field_b": lambda c: structs.field(c, 1),
    "gather": lambda c: copying.gather(c, torch.arange(c.length - 1, -4, -2, device=c.device)),
    "slice": lambda c: copying.slice(c, 10, 400),
    "concatenate": lambda c: copying.concatenate([c, c]),
    "all_null": lambda c: structs.field(c.with_validity(torch.zeros(
        c.length, dtype=torch.bool, device=c.device)), "a"),
}


@pytest.mark.parametrize("name", list(STRUCT_OPS))
def test_struct_ops_on_the_card(dev, name):
    _same(STRUCT_OPS[name](_structs(dev)), STRUCT_OPS[name](_structs(CPU)), dev)


def _grouped(device):
    g = torch.Generator().manual_seed(4)
    keys = torch.randint(0, 300, (N,), generator=g)
    vals = torch.randint(0, 20, (N,), generator=g).double()
    vals[torch.arange(N) % 17 == 0] = float("nan")
    key_col = Column(dt.INT64, N, keys.to(device), (torch.arange(N) % 23 != 0).to(device))
    return gb.make_grouper([key_col]), Column.from_tensor(vals.to(device))


@pytest.mark.parametrize("agg", ["collect", "unique", "collect_set", "histogram", "topk"])
def test_list_aggregations_on_the_card(dev, agg):
    def run(device):
        g, v = _grouped(device)
        return gb.group_topk(v, g, 3) if agg == "topk" else gb.aggregate(v, g, agg)
    _same(run(dev), run(CPU), dev)


def _decimals(device, bits=64):
    g = torch.Generator().manual_seed(5)
    reps = torch.randint(-10 ** 9, 10 ** 9, (N,), generator=g)
    valid = torch.arange(N) % 11 != 2
    return Column(dt.decimal_dtype(-3, bits), N, reps.to(device), valid.to(device))


DECIMAL_OPS = {
    "rescale_up": lambda c: dec.rescale(c, -1),
    "rescale_down": lambda c: dec.rescale(c, -6),
    "mul": lambda c: dec.decimal_binary_operation(c, c, "mul"),
    "div": lambda c: dec.decimal_binary_operation(c, dec.rescale(c, -1), "truediv"),
    "add_scalar": lambda c: dec.decimal_binary_operation(c, D.Decimal("1.25"), "add"),
    "lt": lambda c: dec.decimal_binary_operation(c, D.Decimal("0.5"), "lt"),
    "round": lambda c: dec.round_decimal(c, 1),
    "to_float": lambda c: dec.cast_from_decimal(c, dt.FLOAT64),
    "to_int": lambda c: dec.cast_from_decimal(c, dt.INT32),
    "from_float": lambda c: dec.cast_to_decimal(dec.cast_from_decimal(c, dt.FLOAT64),
                                                dt.decimal_dtype(-2)),
    "mul128": lambda c: d128.binary128(c, c, "mul"),
    "sub128": lambda c: d128.binary128(d128.binary128(c, c, "mul"), c, "sub"),
    "cmp128": lambda c: d128.binary128(d128.binary128(c, c, "mul"), c, "ge"),
    "rescale128": lambda c: d128.rescale128(d128.binary128(c, c, "mul"), -2),
    "gather128": lambda c: copying.gather(d128.binary128(c, c, "mul"),
                                          torch.arange(N - 1, -3, -7, device=c.device)),
}


@pytest.mark.parametrize("name", list(DECIMAL_OPS))
def test_decimal_ops_on_the_card(dev, name):
    bits = 128 if name.endswith("128") else 64
    got, exp = DECIMAL_OPS[name](_decimals(dev, bits)), DECIMAL_OPS[name](_decimals(CPU, bits))
    _col(got, dev)
    assert got.dtype == exp.dtype
    if got.dtype.is_float:
        assert torch.equal(got.data.cpu(), exp.data)
    else:
        assert got.to_pylist() == exp.to_pylist()


def test_split_and_findall_on_the_card(dev):
    words = ["a,b,,c", None, "", ",x", "id0012,7", "q,", "99 8", "x1y22z333"]
    text = [words[i % len(words)] for i in range(N)]
    for make in (lambda s: s.str.split(","), lambda s: s.str.split(",", n=1),
                 lambda s: s.str.findall(r"[1-9]+"), lambda s: s.str.findall(r"\d")):
        before = STRING_ROUTES["host"]
        got = make(ct.Series(Column.from_strings(text, device=dev)))
        assert STRING_ROUTES["host"] == before
        _same(got._column, make(ct.Series(Column.from_strings(text, device=CPU)))._column, dev)


def test_nested_requests_on_the_card(dev):
    def frames(device):
        g = torch.Generator().manual_seed(6)
        n = 20_000

        def ints(lo, hi):
            return torch.randint(lo, hi + 1, (n,), generator=g, dtype=torch.int32).to(device)
        df = ct.DataFrame({"id4": ints(1, 100), "id6": ints(1, 2000), "v1": ints(1, 5),
                           "v2": ints(1, 15),
                           "v3": (torch.rand(n, generator=g, dtype=torch.float64) * 100).to(
                               device)})
        for name, k, w in (("id1", 100, 3), ("id3", 4000, 10)):
            keys = Column.from_strings([f"id{i:0{w}d}" for i in range(1, k + 1)], device=device)
            df[name] = Column.from_dictionary(
                torch.randint(0, k, (n,), generator=g, dtype=torch.int32).to(device), keys)
        li = tpch.generate(0.001, seed=6, device=device)["lineitem"]   # numpy's draws
        return sd.prepare({"g1": df, "lineitem": li})

    fc, fd = frames(CPU), frames(dev)
    for name, request in nested.REQUESTS.items():
        got = nested.ANSWERS[name](request(fd), fd)
        assert all(t.device.type == dev.type for t in got.values()), name
        exp = nested.PLAIN[name](fd)
        assert sorted(got) == sorted(exp), name
        for key in exp:
            assert torch.equal(got[key], exp[key]), (name, key)
        cpu = nested.ANSWERS[name](request(fc), fc)
        for key in cpu:
            assert torch.equal(got[key].cpu(), cpu[key]), (name, key)
    a, b, prod = nested.decimal128_product(nested.REQUESTS["q1_charge"](fd), 2000)
    assert d128.to_ints128(prod) == [x * y for x, y in zip(d128.to_ints128(a),
                                                            d128.to_ints128(b))]
