"""The hashing, partitioning, bloom, pack, t-digest, text, window,
resample, as-of and expression ops on the card, each against the same
call on CPU tensors: nulls, empty strings, empty bins and windows longer
than the column included.

Marked ``cuda``: without a CUDA device every test here skips (decided in
the fixture, never at import).  On a machine with a card run
``python -m pytest tests/test_torch_cuda_ops_windows.py -q --noconftest``.
Hashes, ids, bits, bytes, text and integer results exact; float results
within rtol 1e-12 (the order of atomic adds); every output stays on the
card.
"""

import math

import numpy as np
import pytest
import torch

import cudf_tpu_torch as ct
from cudf_tpu_torch.core.column import Column
from cudf_tpu_torch.core.table import Table
from cudf_tpu_torch.ops import bloom, hashing, pack, partitioning, tdigest
from cudf_tpu_torch.ops import text as text_ops

pytestmark = pytest.mark.cuda

CPU = torch.device("cpu")
N = 20_000


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _strings(rows=N, seed=1):
    rng = np.random.default_rng(seed)
    alpha = list("abc xyé漢\t") + ["  ", "id0"]
    out = ["".join(rng.choice(alpha, rng.integers(0, 30))) for _ in range(rows)]
    for i in range(0, rows, 17):
        out[i] = None
    for i in range(5, rows, 23):
        out[i] = ""
    return out


def _frame(device, seed=1):
    g = torch.Generator().manual_seed(seed)
    v = torch.rand(N, generator=g, dtype=torch.float64) * 100
    v[torch.arange(N) % 11 == 3] = math.nan
    return Table({"k": Column.from_tensor(torch.randint(-50, 50, (N,), generator=g).to(device)),
                  "v": Column.from_tensor(v.to(device),
                                          (torch.arange(N) % 13 != 5).to(device)),
                  "s": Column.from_strings(_strings(), device=device)})


def _on(col, device):
    for t in (col.data, col.validity, col.offsets):
        assert t is None or t.device.type == device.type
    for c in col.children:
        _on(c, device)


def _close(a, b, rtol) -> bool:
    """Host values equal, floats within rtol (NaN and None alike), in
    lists and dicts too."""
    if isinstance(a, float) and a != a:
        a = None
    if isinstance(b, float) and b != b:
        b = None
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(
            _close(x, y, rtol) for x, y in zip(a, b))
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _close(a[k], b[k], rtol) for k in a)
    if isinstance(a, float) and isinstance(b, float):
        return math.isclose(a, b, rel_tol=rtol, abs_tol=0.0) if rtol else a == b
    return a == b


def _eq(got, exp, device, rtol=0.0):
    if isinstance(got, Column):
        _on(got, device)
        got, exp = got.to_pylist(), exp.to_pylist()
    if isinstance(got, torch.Tensor):
        assert got.device.type == device.type
        got, exp = got.cpu(), exp.cpu()
        if got.is_floating_point():
            assert torch.allclose(got, exp, rtol=rtol, atol=0, equal_nan=True)
        else:
            assert torch.equal(got, exp)
        return
    assert _close(got, exp, rtol)


HASHES = {
    "murmur3": lambda t: hashing.murmurhash3_x86_32([t["k"], t["v"], t["s"]], 7),
    "xxhash64": lambda t: hashing.xxhash_64([t["s"], t["k"]], 3),
    "partition_ids": lambda t: partitioning.partition_ids([t["k"], t["s"]], 13),
    "hash_partition": lambda t: partitioning.hash_partition(t, ["k"], 64)[1],
    "round_robin": lambda t: partitioning.round_robin_partition(t, 5, 2)[0]["v"],
    "bloom": lambda t: bloom.BloomFilter(1 << 16, 3).add([t["k"]]).maybe_contains([t["s"]]),
    "pack": lambda t: pack.pack(t).gpu_data,
    "unpack": lambda t: pack.unpack(pack.pack(t))["s"],
    "split": lambda t: pack.unpack(pack.contiguous_split(t, [7, 9000])[1])["v"],
}


@pytest.mark.parametrize("name", list(HASHES))
def test_hashes_partitions_bloom_pack_on_the_card(dev, name):
    _eq(HASHES[name](_frame(dev)), HASHES[name](_frame(CPU)), dev)


TEXT = {
    "count_tokens": lambda s, o: text_ops.count_tokens(s),
    "tokenize": lambda s, o: text_ops.tokenize(s),
    "tokenize_delim": lambda s, o: text_ops.tokenize(s, "a"),
    "character_ngrams": lambda s, o: text_ops.character_ngrams(s, 3),
    "ngrams_tokenize": lambda s, o: text_ops.ngrams_tokenize(s, 2, "__"),
    "minhash": lambda s, o: text_ops.minhash(s, [0, 5, 2 ** 63 + 1], 4),
    "jaccard": lambda s, o: text_ops.jaccard_index(s, o, 3),
    "normalize_spaces": lambda s, o: text_ops.normalize_spaces(s),
    "vocabulary": lambda s, o: text_ops.tokenize_with_vocabulary(
        s, Column.from_strings(["a", "id0", "c", "xy"], device=s.device)),
}


@pytest.mark.parametrize("name", list(TEXT))
def test_text_on_the_card(dev, name):
    def run(device):
        return TEXT[name](Column.from_strings(_strings(), device=device),
                          Column.from_strings(_strings(seed=2), device=device))
    _eq(run(dev), run(CPU), dev)


def _series(device):
    g = torch.Generator().manual_seed(3)
    v = torch.rand(N, generator=g, dtype=torch.float64) * 1e9
    v[torch.arange(N) % 29 == 1] = math.nan
    days = torch.sort(torch.randint(0, 400, (N,), generator=g)).values * 86_400 * 10 ** 9
    idx = ct.Index(Column(ct.Series(np.zeros(1, "datetime64[ns]"), device=CPU).dtype, N,
                          days.to(device)))
    return ct.Series(v.to(device), index=idx)


WINDOWS = {
    **{f"rolling_{fn}": (lambda s, fn=fn: getattr(s.rolling(50), fn)())
       for fn in ("sum", "mean", "var", "std", "min", "max", "count")},
    "center": lambda s: s.rolling(7, min_periods=1, center=True).sum(),
    "longer_than_column": lambda s: s.iloc[:10].rolling(50, min_periods=1).mean(),
    "offset_sum": lambda s: s.rolling("3D").sum(),
    "offset_max": lambda s: s.rolling("3D").max(),
    "offset_std": lambda s: s.rolling("3D").std(),
    "ewm": lambda s: s.ewm(alpha=0.3).mean(),
    "apply": lambda s: s.rolling(8).apply(lambda x: x.sum() * 2.0, raw=True),
    "resample_sum": lambda s: s.resample("12h").sum(),
    "resample_mean": lambda s: s.resample("D").mean(),
    "resample_count": lambda s: s.resample("7h").count(),
}


@pytest.mark.parametrize("name", list(WINDOWS))
def test_windows_and_resample_on_the_card(dev, name):
    got, exp = WINDOWS[name](_series(dev)), WINDOWS[name](_series(CPU))
    _eq(got._column, exp._column, dev, rtol=1e-12)
    _eq(got.index.column(dev).data, exp.index.column(CPU).data, dev)


def test_grouped_rolling_tdigest_asof_query_on_the_card(dev):
    def run(device):
        t = _frame(device)
        df = ct.DataFrame._from(Table({"k": t["k"], "v": t["v"]}), ct.RangeIndex(N))
        rolled = df.groupby("k")["v"].rolling(5, min_periods=2).max()
        digest = df.groupby("k")["v"].agg("tdigest")
        est = tdigest.percentile_approx(tdigest.build_tdigest(t["v"], 50), [0.1, 0.9])
        left = ct.DataFrame({"t": torch.sort(t["k"].data).values, "g": t["k"].data % 3})
        right = ct.DataFrame({"t": torch.sort(t["k"].data[::3]).values,
                              "g": t["k"].data[::3] % 3, "w": torch.arange(len(left) // 3 + 1,
                                                                           device=device)})
        asof = ct.merge_asof(left, right, on="t", by="g", direction="nearest", tolerance=3)
        return rolled, digest, est, asof["w"], df.query("k > 3 and v < 50")["v"]
    for got, exp in zip(run(dev), run(CPU)):
        _eq(got if isinstance(got, Column) else got._column,
            exp if isinstance(exp, Column) else exp._column, dev, rtol=1e-12)


def test_day_units_and_strftime_on_the_card(dev):
    days = np.array(["2024-01-07", "1969-12-31", "NaT", "2000-02-29"], "datetime64[D]")
    got, exp = ct.Series(days, device=dev), ct.Series(days, device=CPU)
    _eq(got.dt.year._column, exp.dt.year._column, dev)
    _eq(got.astype("datetime64[ns]")._column, exp.astype("datetime64[ns]")._column, dev)
    fmt = "%U %W %u %w %G-%V %c %x"
    _eq(got.dt.strftime(fmt)._column, exp.dt.strftime(fmt)._column, dev)
