"""The port's column layouts for pandas' extension dtypes
(``cudf_tpu_torch/core/column.py``): the nullable ``string`` and the
``str`` dtypes, Arrow-backed dtypes (``int64[pyarrow]``,
``string[pyarrow]``, ``timestamp[ns][pyarrow]`` ...) and tz-aware
timestamps, each round-tripped through ``Column.from_pandas`` /
``to_pandas`` and held to the input (pandas 3) and to the reference's
``cudf_tpu`` Series on the same seeded values; ``Column.from_arrow`` /
``to_arrow`` against the reference's for the fixed-width, temporal,
string and dictionary layouts.  Every value, null and dtype exact.
"""

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

import torch_jax_cache  # noqa: F401  (the run's shared JAX compile cache)
import cudf_tpu
from cudf_tpu.core.column import Column as RefColumn
import cudf_tpu_torch as ct
from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import Column

torch.set_num_threads(1)

CPU = torch.device("cpu")
N = 40


def _series():
    rng = np.random.default_rng(5)
    words = [str(w) for w in rng.choice(["a", "bb", "ñandú", "", "日本"], N)]
    nulls = rng.random(N) < 0.2
    ints = rng.integers(-1000, 1000, N)
    stamps = pd.to_datetime(rng.integers(0, 2_000_000_000, N), unit="s")
    text = [None if m else w for w, m in zip(words, nulls)]
    return {
        "string": pd.Series(text, dtype="string"),
        "str": pd.Series(text, dtype="str"),
        "string_pyarrow_storage": pd.Series(text, dtype=pd.StringDtype("pyarrow")),
        "int64[pyarrow]": pd.Series([None if m else int(v) for v, m in zip(ints, nulls)],
                                    dtype="int64[pyarrow]"),
        "int8[pyarrow]": pd.Series(ints % 100, dtype="int8[pyarrow]"),
        "float64[pyarrow]": pd.Series([None if m else v / 7 for v, m in zip(ints, nulls)],
                                      dtype="float64[pyarrow]"),
        "bool[pyarrow]": pd.Series([None if m else bool(v % 2) for v, m in zip(ints, nulls)],
                                   dtype="bool[pyarrow]"),
        "string[pyarrow]": pd.Series(text, dtype=pd.ArrowDtype(pa.string())),
        "timestamp[ns][pyarrow]": pd.Series(stamps.where(~nulls), dtype="timestamp[ns][pyarrow]"),
        "timestamp[us, tz][pyarrow]": pd.Series(stamps, dtype=pd.ArrowDtype(
            pa.timestamp("us", tz="Europe/Berlin"))),
        "duration[ms][pyarrow]": pd.Series(pd.to_timedelta(ints, unit="ms"),
                                           dtype="duration[ms][pyarrow]"),
        "tz_new_york_ns": pd.Series(stamps.where(~nulls).astype("datetime64[ns]"))
        .dt.tz_localize("UTC").dt.tz_convert("America/New_York"),
        "tz_utc_us": pd.Series(stamps.astype("datetime64[us]")).dt.tz_localize("UTC"),
    }


SERIES = _series()


@pytest.mark.parametrize("name", list(SERIES))
def test_round_trip_keeps_values_nulls_and_dtype(name):
    s = SERIES[name]
    got = Column.from_pandas(s, device=CPU).to_pandas()
    pd.testing.assert_series_equal(got, s.reset_index(drop=True))
    assert ct.Series(s, device=CPU).to_pandas().dtype == s.dtype


@pytest.mark.parametrize("name", ["string", "str", "int64[pyarrow]", "float64[pyarrow]",
                                  "string[pyarrow]", "tz_new_york_ns", "tz_utc_us"])
def test_matches_the_reference(name):
    """The reference keeps the same values and nulls (its dtypes follow
    the same provenance flags)."""
    s = SERIES[name]
    ours = ct.Series(s, device=CPU).to_pandas()
    ref = cudf_tpu.Series(s).to_pandas()
    assert ours.astype(object).where(ours.notna(), None).tolist() == \
        ref.astype(object).where(ref.notna(), None).tolist()


def test_tz_aware_holds_utc_ticks_and_zone():
    s = SERIES["tz_new_york_ns"]
    col = Column.from_pandas(s, device=CPU)
    assert col.dtype.tz == "America/New_York" and col.dtype.time_unit == "ns"
    utc = s.dt.tz_convert("UTC").dt.tz_localize(None)
    valid = col.validity.numpy()
    assert col.data.numpy()[valid].tolist() == utc[valid].astype("int64").tolist()
    assert repr(col.dtype) == "datetime64[ns, America/New_York]"


def test_nullable_string_is_pandas_string():
    col = Column.from_pandas(SERIES["string"], device=CPU)
    assert col.dtype.is_string and col.dtype.nullable and repr(col.dtype) == "string"
    assert not Column.from_pandas(SERIES["str"], device=CPU).dtype.nullable


def _ref_arrays():
    return {
        "int32": pa.array([1, None, 3], pa.int32()),
        "float64": pa.array([1.5, None, -2.0]),
        "bool": pa.array([True, None, False]),
        "string": pa.array(["x", None, "ñü"]),
        "large_string": pa.array(["a", "", None], pa.large_string()),
        "timestamp_ms": pa.array([0, None, 86_400_000], pa.timestamp("ms")),
        "timestamp_tz": pa.array([0, 3_600_000_000], pa.timestamp("us", tz="Asia/Tokyo")),
        "duration_s": pa.array([5, None], pa.duration("s")),
        "dictionary": pa.array(["b", "a", None, "b"]).dictionary_encode(),
        "sliced": pa.array(["p", "q", None, "r"]).slice(1, 3),
    }


@pytest.mark.parametrize("name", list(_ref_arrays()))
def test_arrow_round_trip_matches_reference(name):
    arr = _ref_arrays()[name]
    col = Column.from_arrow(arr, device=CPU)
    assert col.to_arrow().to_pylist() == arr.to_pylist()
    assert col.to_arrow().to_pylist() == RefColumn.from_arrow(arr).to_arrow().to_pylist()
    if pa.types.is_timestamp(arr.type) and arr.type.tz:
        assert col.dtype.tz == arr.type.tz


def test_what_stays_unported_raises_naming_item_6():
    """Interval and period columns, which the reference lacks too, name
    ROADMAP.md's "beyond the reference" line; day-unit columns are ported
    (int32 days: an int64 buffer is refused)."""
    with pytest.raises(NotImplementedError, match="beyond the reference"):
        Column.from_arrow(pa.array([(1, 2, 3)], pa.month_day_nano_interval()), device=CPU)
    with pytest.raises(NotImplementedError, match="beyond the reference"):
        Column.from_pandas(pd.Series(pd.arrays.IntervalArray.from_breaks([0, 1, 2])),
                           device=CPU)
    with pytest.raises(ValueError):
        Column(dt.DType(dt.TypeId.TIMESTAMP_DAYS), 1, torch.zeros(1, dtype=torch.int64))
