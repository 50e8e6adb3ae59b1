"""cudf_tpu_torch core: dtypes, validity bitmasks, Column, Table and
interop round trips, held to the reference package's columns.

``from_buffers`` carries a reference column's numpy buffers into the
port; both columns must then give the same ``to_pandas()`` exactly.
"""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from cudf_tpu.core.column import Column as RefColumn
import cudf_tpu_torch as ct
from cudf_tpu_torch.core import bitmask as bm
from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.core.table import Table

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _values(rng, np_dtype, n):
    if np_dtype == np.bool_:
        return rng.random(n) > 0.5
    if np.issubdtype(np_dtype, np.floating):
        return rng.normal(size=n).astype(np_dtype)
    return rng.integers(-1000, 1000, n).astype(np_dtype)


@pytest.mark.parametrize("np_dtype", [np.int32, np.int64, np.float32,
                                      np.float64, np.bool_])
@pytest.mark.parametrize("with_nulls", [False, True])
def test_from_buffers_matches_reference_column(rng, np_dtype, with_nulls):
    n = 257
    vals = _values(rng, np_dtype, n)
    mask = (rng.random(n) > 0.2) if with_nulls else None
    ref = RefColumn.from_numpy(vals, mask=mask)
    validity = None if ref.validity is None else np.asarray(ref.validity)
    got = ct.from_buffers(repr(ref.dtype), ref.length, np.asarray(ref.data),
                          validity, device=CPU)
    assert got.dtype == dt.dtype(repr(ref.dtype))
    pd.testing.assert_series_equal(got.to_pandas(), ref.to_pandas(),
                                   check_exact=True)


def test_from_buffers_takes_arrow_bitmask(rng):
    n = 45
    vals = rng.normal(size=n)
    valid = rng.random(n) > 0.5
    packed = np.packbits(valid, bitorder="little")
    a = ct.from_buffers("float64", n, vals, packed, device=CPU)
    b = ct.from_buffers("float64", n, vals, valid, device=CPU)
    assert torch.equal(a.validity, b.validity)
    with pytest.raises(ValueError):
        ct.from_buffers("float64", n, vals, valid[:-1], device=CPU)


@pytest.mark.parametrize("n", [0, 1, 8, 13, 1000])
def test_bitmask_pack_unpack_matches_numpy(rng, n):
    valid = rng.random(n) > 0.4
    packed = bm.pack_bools(torch.from_numpy(valid))
    assert packed.numpy().tobytes() == np.packbits(valid, bitorder="little").tobytes()
    assert torch.equal(bm.unpack_bools(packed, n), torch.from_numpy(valid))


@pytest.mark.parametrize("bounds_check", [False, True])
@pytest.mark.parametrize("np_dtype", [np.int64, np.float32, np.bool_])
def test_gather_matches_reference(rng, bounds_check, np_dtype):
    """ops.copying.gather, NULLIFY for out-of-range indices when
    bounds_check, against the reference's gather."""
    from cudf_tpu.ops.copying import gather as ref_gather
    from cudf_tpu_torch.ops.copying import gather

    n = 300
    vals = _values(rng, np_dtype, n)
    mask = rng.random(n) > 0.2
    lo, hi = (-20, n + 20) if bounds_check else (0, n)
    idx = rng.integers(lo, hi, 500)
    ref = ref_gather(RefColumn.from_numpy(vals, mask=mask), jnp.asarray(idx),
                     bounds_check=bounds_check)
    got = gather(ct.from_buffers(np_dtype, n, vals, mask, device=CPU),
                 torch.from_numpy(idx), bounds_check=bounds_check)
    pd.testing.assert_series_equal(got.to_pandas(), ref.to_pandas(), check_exact=True)


def test_filter_indices():
    from cudf_tpu_torch.ops.stream_compaction import filter_indices

    mask = torch.tensor([False, True, True, False, True])
    assert filter_indices(mask).tolist() == [1, 2, 4]
    assert filter_indices(torch.zeros(3, dtype=torch.bool)).tolist() == []


def test_column_from_numpy_nan_is_null_and_copies():
    arr = np.array([1.0, np.nan, 3.0])
    col = Column.from_numpy(arr, device=CPU)
    assert col.validity.tolist() == [True, False, True]
    arr[0] = 99.0
    assert col.data[0].item() == 1.0
    out = col.to_numpy()
    assert np.isnan(out[1]) and out[0] == 1.0


def test_column_to_numpy_null_representations():
    ints = Column(dt.INT64, 3, torch.tensor([1, 2, 3]), torch.tensor([True, False, True]))
    assert ints.to_numpy().dtype == np.float64 and np.isnan(ints.to_numpy()[1])
    bools = Column(dt.BOOL8, 2, torch.tensor([True, False]), torch.tensor([False, True]))
    assert bools.to_numpy().tolist() == [None, False]


def test_column_rejects_bad_buffers():
    with pytest.raises(ValueError):
        Column(dt.INT32, 3, torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError):
        Column(dt.INT32, 3, torch.zeros(3, dtype=torch.int32),
               torch.ones(2, dtype=torch.bool))
    with pytest.raises(ValueError):              # a STRING column needs its offsets
        Column(dt.STRING, 0, torch.zeros(0, dtype=torch.uint8))
    with pytest.raises(ValueError):              # decimal64 holds int64 unscaled values
        Column(dt.decimal_dtype(2), 3, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError):              # a LIST column holds offsets and one child
        Column(dt.list_dtype(dt.INT64), 2, None, offsets=torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError):              # day units hold int32 days
        Column(dt.DType(dt.TypeId.TIMESTAMP_DAYS), 3, torch.zeros(3, dtype=torch.int64))
    with pytest.raises(NotImplementedError):     # interval columns: beyond the reference
        Column(dt.DType(dt.TypeId.INTERVAL), 3, torch.zeros(3, dtype=torch.int64))


def test_torch_storage_mapping():
    for name, td in [("int8", torch.int8), ("int64", torch.int64),
                     ("uint32", torch.uint32), ("float32", torch.float32),
                     ("bool", torch.bool)]:
        assert dt.dtype(name).torch_storage == td
        assert dt.from_torch(td) == dt.dtype(name)


def test_table_checks_lengths_and_devices():
    a = Column.from_tensor(torch.arange(3))
    t = Table({"a": a, "b": Column.from_tensor(torch.ones(3))})
    assert t.names == ("a", "b") and t.num_rows == 3
    assert t.select(["b"]).names == ("b",)
    assert t.insert("c", a, loc=0).names == ("c", "a", "b")
    with pytest.raises(ValueError):
        Table({"a": a, "b": Column.from_tensor(torch.ones(4))})
    with pytest.raises(KeyError):
        t["zz"]


def test_dataframe_pandas_round_trip(rng):
    pdf = pd.DataFrame({"i": rng.integers(0, 9, 50).astype(np.int32),
                        "f": rng.normal(size=50),
                        "b": rng.random(50) > 0.5},
                       index=pd.RangeIndex(10, 60, name="r"))
    pdf.loc[pdf.index[::7], "f"] = np.nan
    df = ct.from_pandas(pdf, device=CPU)
    assert df.device == CPU and len(df) == 50
    pd.testing.assert_frame_equal(df.to_pandas(), pdf)
    pd.testing.assert_series_equal(df["f"].to_pandas(), pdf["f"])
    pd.testing.assert_frame_equal(df[["b", "i"]].to_pandas(), pdf[["b", "i"]])
    pd.testing.assert_frame_equal(df.reset_index().to_pandas(), pdf.reset_index())
    s = ct.from_pandas(pdf["i"], device=CPU)
    pd.testing.assert_series_equal(s.to_pandas(), pdf["i"])


def test_dataframe_device_is_explicit():
    with pytest.raises(ValueError, match="device"):
        ct.DataFrame({"a": np.arange(3)})
    df = ct.DataFrame({"a": np.arange(3)}, device=CPU)
    assert df.device == CPU
    df2 = ct.DataFrame({"a": torch.arange(3), "b": torch.ones(3)})
    assert df2._table.names == ("a", "b")
    with pytest.raises(ValueError, match="device"):
        ct.DataFrame({"a": [1, 2, 3]})
    assert ct.DataFrame({"a": [1, 2, 3]}, device=CPU)._table["a"].data.tolist() == [1, 2, 3]
    with pytest.raises(TypeError):
        ct.DataFrame({"a": {1, 2, 3}}, device=CPU)
