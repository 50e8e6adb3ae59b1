"""``cudf_tpu_torch.ops.hashing`` against the reference's
``cudf_tpu.ops.hashing`` (JAX on the CPU), bit for bit: murmur3 and
xxhash64 over every fixed-width dtype, strings (empty, 1-40 bytes,
non-ASCII, longer than 32 bytes for xxhash64's stripes), nulls, two
columns combined, dictionaries and decimals; the host checksums against
the reference's and hashlib; ``Series`` / ``DataFrame.hash_values``.
Follows ``tests/test_hashing.py``."""

import hashlib

import numpy as np
import pandas as pd
import pytest
import torch

import torch_jax_cache  # noqa: F401  (the run's shared JAX compile cache)
import cudf_tpu.core.column as ref_col
from cudf_tpu.ops import hashing as ref

import cudf_tpu_torch as ct
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.ops import hashing
from cudf_tpu_torch.ops._utils import HOST_ROUTES

torch.set_num_threads(1)

CPU = "cpu"
N = 300
FIXED = ["int8", "int16", "int32", "int64", "uint8", "uint16", "uint32", "uint64", "float32",
         "float64", "bool", "datetime64[ns]", "datetime64[D]"]


def _array(name, rng):
    if name == "bool":
        return rng.random(N) > 0.5
    if name.startswith("float"):
        a = rng.normal(size=N).astype(name)
        a[::7] = 0.0
        a[3] = -0.0
        return a
    if name.startswith("datetime"):
        return rng.integers(-10 ** 4, 10 ** 4, N).astype(name)
    info = np.iinfo(name)
    return rng.integers(info.min, info.max, N, dtype=name, endpoint=True)


def _strings(rng, nulls=True):
    alpha = list("abcxyz 01") + ["é", "漢", "ñ", "\t"]
    out = ["".join(rng.choice(alpha, rng.integers(0, 41))) for _ in range(N)]
    out[1], out[2] = "", "x" * 40
    if nulls:
        for i in range(0, N, 11):
            out[i] = None
    return out


def _pair(name, rng):
    """(reference column, port column) of the same values."""
    if name == "string":
        s = _strings(rng)
        return ref_col.Column.from_strings(s), Column.from_strings(s, device=CPU)
    a = _array(name, rng)
    return ref_col.Column.from_numpy(a), Column.from_numpy(a, device=CPU)


def _bits(col):
    return np.asarray(col.data) if not isinstance(col.data, torch.Tensor) else \
        col.data.numpy()


@pytest.mark.parametrize("seed", [0, 42])
@pytest.mark.parametrize("name", FIXED + ["string"])
@pytest.mark.parametrize("method", ["murmurhash3_x86_32", "xxhash_64"])
def test_hash_of_one_column_equals_the_reference(method, name, seed):
    r, p = _pair(name, np.random.default_rng(seed + len(name)))
    got = getattr(hashing, method)([p], seed)
    exp = getattr(ref, method)([r], seed)
    assert got.dtype.id.name == exp.dtype.id.name
    np.testing.assert_array_equal(_bits(got), _bits(exp))


@pytest.mark.parametrize("method", ["murmurhash3_x86_32", "xxhash_64"])
def test_hash_of_null_rows_and_two_columns_equals_the_reference(method):
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    a = rng.integers(-1000, 1000, N)
    valid = np.arange(N) % 5 != 0              # every fifth row null
    s = _strings(rng)
    r = [ref_col.Column.from_numpy(a).with_validity(jnp.asarray(valid)),
         ref_col.Column.from_strings(s)]
    p = [Column.from_numpy(a, device=CPU).with_validity(torch.from_numpy(valid)),
         Column.from_strings(s, device=CPU)]
    np.testing.assert_array_equal(_bits(getattr(hashing, method)(p, 3)),
                                  _bits(getattr(ref, method)(r, 3)))


@pytest.mark.parametrize("method", ["murmurhash3_x86_32", "xxhash_64"])
def test_hash_of_dictionary_and_decimal_columns(method):
    """A dictionary hashes its decoded values; a decimal its unscaled int64."""
    rng = np.random.default_rng(8)
    keys = np.array(["id001", "id002", "ñandú", ""], dtype=object)
    codes = rng.integers(0, 4, N).astype(np.int32)
    pdict = Column.from_pandas(pd.Series(pd.Categorical.from_codes(codes, keys)), device=CPU)
    plain = Column.from_strings(list(keys[codes]), device=CPU)
    np.testing.assert_array_equal(_bits(getattr(hashing, method)([pdict])),
                                  _bits(getattr(hashing, method)([plain])))
    unscaled = rng.integers(-10 ** 12, 10 ** 12, N)
    dec = Column(ct.core.dtypes.decimal_dtype(-2), N, torch.from_numpy(unscaled))
    np.testing.assert_array_equal(_bits(getattr(hashing, method)([dec])),
                                  _bits(getattr(ref, method)([ref_col.Column.from_numpy(
                                      unscaled)])))


@pytest.mark.parametrize("method", ["md5", "sha1", "sha224", "sha256", "sha384", "sha512"])
def test_checksums_equal_the_reference_and_hashlib(method):
    rng = np.random.default_rng(2)
    s = _strings(rng)
    a = rng.integers(-100, 100, N).astype(np.int32)
    before = sum(HOST_ROUTES.values())
    got = hashing.checksum([Column.from_strings(s, device=CPU), Column.from_numpy(a, device=CPU)],
                           method).to_pylist()
    assert sum(HOST_ROUTES.values()) == before + 1
    exp = ref.checksum([ref_col.Column.from_strings(s), ref_col.Column.from_numpy(a)],
                       method).to_pylist()
    assert got == exp
    fn = getattr(hashlib, method)
    assert got[1] == fn(b"" + a[1].tobytes()).hexdigest()


def test_series_and_dataframe_hash_values():
    rng = np.random.default_rng(4)
    pdf = pd.DataFrame({"a": rng.integers(0, 100, N), "s": _strings(rng, nulls=False)})
    df = ct.DataFrame.from_pandas(pdf, device=CPU)
    rdf = [ref_col.Column.from_numpy(pdf["a"].to_numpy()),
           ref_col.Column.from_strings(list(pdf["s"]))]
    got = df.hash_values()
    assert str(got.dtype) == "uint32" and got.name is None
    np.testing.assert_array_equal(_bits(got._column), _bits(ref.hash_values(rdf)))
    np.testing.assert_array_equal(_bits(df.hash_values("xxhash64", seed=9)._column),
                                  _bits(ref.hash_values(rdf, "xxhash64", 9)))
    s = df["s"].hash_values("sha256")
    assert s.name == "s" and s.tolist() == ref.hash_values([rdf[1]], "sha256").to_pylist()
    with pytest.raises(ValueError, match="unknown hash method"):
        df.hash_values("crc32")
