"""``ops/partitioning.py``, ``ops/bloom.py`` and ``ops/pack.py`` against the
reference's (JAX on the CPU): partition ids (half the row hashes are
negative as int64: the remainder is the unsigned one), row order and
offsets; the bloom filter's bits and probes; the packed bytes and JSON
equal to the reference's blob, and the round trip over nested,
dictionary and decimal columns.  Follows ``tests/test_asof_pack.py``."""

import decimal

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudf_tpu.core import dtypes as rdt
from cudf_tpu.core.column import Column as RC
from cudf_tpu.core.table import Table as RT
from cudf_tpu.ops import bloom as rbloom
from cudf_tpu.ops import dictionary as rdict
from cudf_tpu.ops import lists as rlists
from cudf_tpu.ops import pack as rpack
from cudf_tpu.ops import partitioning as rpart

from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.core.table import Table
from cudf_tpu_torch.ops import bloom, lists, pack, partitioning, row_ops, structs
from cudf_tpu_torch.ops.decimal128 import from_decimals128
from cudf_tpu_torch.ops.dictionary import encode

torch.set_num_threads(1)

CPU = "cpu"
N = 400


def _frames(seed=0):
    rng = np.random.default_rng(seed)
    a = rng.integers(-10 ** 6, 10 ** 6, N)
    b = rng.normal(size=N)
    s = [f"k{i % 37}" if i % 9 else "" for i in range(N)]
    valid = np.arange(N) % 7 != 2
    ref = RT({"a": RC.from_numpy(a), "b": RC.from_numpy(b).with_validity(jnp.asarray(valid)),
              "s": RC.from_strings(s)})
    port = Table({"a": Column.from_numpy(a, device=CPU),
                  "b": Column.from_numpy(b, device=CPU).with_validity(torch.from_numpy(valid)),
                  "s": Column.from_strings(s, device=CPU)})
    return ref, port


def test_row_hashes_are_negative_half_the_time():
    _, port = _frames()
    h = row_ops.row_hash([port["a"]])
    assert 0.3 < float((h < 0).double().mean()) < 0.7


@pytest.mark.parametrize("parts", [1, 7, 64, 1000])
@pytest.mark.parametrize("keys", [["a"], ["s"], ["a", "s", "b"]])
def test_partition_ids_equal_the_reference(keys, parts):
    ref, port = _frames()
    got = partitioning.partition_ids([port[k] for k in keys], parts, seed=3)
    exp = np.asarray(rpart.partition_ids([ref[k] for k in keys], parts, seed=3))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), exp)


@pytest.mark.parametrize("parts", [2, 64])
def test_hash_and_round_robin_partitions_equal_the_reference(parts):
    ref, port = _frames(1)
    for run_ref, run_port in (
            (lambda: rpart.hash_partition(ref, ["a", "s"], parts),
             lambda: partitioning.hash_partition(port, ["a", "s"], parts)),
            (lambda: rpart.round_robin_partition(ref, parts, 5),
             lambda: partitioning.round_robin_partition(port, parts, 5))):
        (rt, roff), (pt, poff) = run_ref(), run_port()
        np.testing.assert_array_equal(poff.numpy(), np.asarray(roff))
        for name in ("a", "b", "s"):
            assert pt[name].to_pylist() == rt[name].to_pylist() or \
                np.allclose(np.array(pt[name].to_pylist(), float),
                            np.array(rt[name].to_pylist(), float), equal_nan=True)


@pytest.mark.parametrize("bits,k", [(1 << 10, 1), (1 << 12, 3), (1 << 16, 7)])
def test_bloom_bits_and_probes_equal_the_reference(bits, k):
    ref, port = _frames(2)
    rb = rbloom.BloomFilter(bits, k).add([ref["a"], ref["s"]])
    pb = bloom.BloomFilter(bits, k).add([port["a"], port["s"]])
    np.testing.assert_array_equal(pb.bits.numpy(), np.asarray(rb.bits))
    assert pb.fill_ratio() == rb.fill_ratio()
    probe = np.random.default_rng(3).integers(-2 * 10 ** 6, 2 * 10 ** 6, N)
    ref2, port2 = _frames(2)
    got = pb.maybe_contains([Column.from_numpy(probe, device=CPU), port2["s"]])
    exp = rb.maybe_contains([RC.from_numpy(probe), ref2["s"]])
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    assert bool(pb.maybe_contains([port["a"], port["s"]]).all())     # no false negative


def _nested_pair():
    rows = [[1, 2], None, [], [3, None, 5]] * 10
    return rlists.from_pylists(rows), lists.from_pylists(rows, device=CPU)


def test_pack_bytes_equal_the_reference_blob():
    ref, port = _frames(4)
    rl, pl = _nested_pair()
    rd = rdict.encode(RC.from_strings(["x", "yy", "x", "zzz"] * 10))
    pd_ = encode(Column.from_strings(["x", "yy", "x", "zzz"] * 10, device=CPU))
    unscaled = np.arange(40, dtype=np.int64) * 12345 - 99
    rdec = RC(rdt.decimal_dtype(-2), 40, data=jnp.asarray(unscaled))
    pdec = Column(dt.decimal_dtype(-2), 40, torch.from_numpy(unscaled))
    rpk = rpack.pack(RT({"l": rl, "d": rd, "m": rdec}))
    ppk = pack.pack(Table({"l": pl, "d": pd_, "m": pdec}))
    assert ppk.metadata == rpk.metadata
    np.testing.assert_array_equal(ppk.gpu_data.numpy(), np.asarray(rpk.gpu_data))
    rpk, ppk = rpack.pack(ref), pack.pack(port)
    assert ppk.metadata == rpk.metadata
    np.testing.assert_array_equal(ppk.gpu_data.numpy(), np.asarray(rpk.gpu_data))


def test_pack_round_trip_of_nested_dictionary_and_decimal_columns():
    rows = [[1, 2], None, [], [3, None, 5]] * 3
    st = structs.from_pydicts([{"x": 1, "y": "a"}, None, {"x": None, "y": ""}] * 4, device=CPU)
    dec128 = from_decimals128([decimal.Decimal("1.5"), None, decimal.Decimal(2) ** 70] * 4,
                              device=CPU)
    assert dec128.children                      # two limbs: the high one a child
    table = Table({"l": lists.from_pylists(rows, device=CPU), "st": st, "dec": dec128,
                   "d": encode(Column.from_strings(["b", "a", None, "b"] * 3, device=CPU)),
                   "f": Column.from_numpy(np.linspace(-1, 1, 12), device=CPU),
                   "s": Column.from_strings(["", "ñ", None] * 4, device=CPU)})
    packed = pack.pack(table)
    assert packed.gpu_data.dtype == torch.uint8 and packed.gpu_data.numel() % 8 == 0
    out = pack.unpack(packed)
    assert out.names == table.names
    for name in table.names:
        got, exp = out[name].to_pylist(), table[name].to_pylist()
        assert str(got) == str(exp), name
    # unpack's buffers are views into the one blob
    base = packed.gpu_data.untyped_storage().data_ptr()
    assert out["f"].data.untyped_storage().data_ptr() == base


def test_contiguous_split_equals_the_reference():
    ref, port = _frames(6)
    rparts = rpack.contiguous_split(ref, [10, 250])
    pparts = pack.contiguous_split(port, [10, 250])
    assert len(pparts) == 3
    for r, p in zip(rparts, pparts):
        assert p.metadata == r.metadata
        np.testing.assert_array_equal(p.gpu_data.numpy(), np.asarray(r.gpu_data))
    back = [pack.unpack(p)["s"].to_pylist() for p in pparts]
    assert sum(back, []) == port["s"].to_pylist()
