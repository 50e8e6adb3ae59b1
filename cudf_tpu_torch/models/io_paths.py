"""The file paths on the card, each beside a plain check written apart
from the port's readers and writers.

Data, made on the device from a seed (no bulk copy from the host):

- ``taxi_frame``: one month of 2015 NYC yellow-cab trips in the shape of
  the reference's ``bench.py`` ``bench_parquet_decode`` (BASELINE.md
  config 4, after libcudf's ``parquet_reader_input.cpp``): vendor_id,
  passenger_count (int32), trip_distance, fare_amount, tip_amount,
  total_amount (float64, cents), pickup_datetime (ns, whole seconds in
  January), payment_type (STRING: CSH, CRD, DIS, NOC);
- ``g1_frame``: db-benchmark's ``G1_<n>_1e2_0_0`` (``groupby-datagen.R``):
  id1, id2 over "id001".."id100" and id3 over "id0000000001".. n/100
  (DICTIONARY32), id4, id5 in 1..100, id6 in 1..n/100, v1 in 1..5, v2 in
  1..15 (int32), v3 uniform in [0, 100) rounded to 6 decimals, as the
  script writes it; ``g1_csv`` its CSV text, built on the device
  (``fwrite``'s form: no quotes, v3 without trailing zeros).

``REQUESTS[name](frames)`` is what a user calls (``frames`` holds the
tables and ``dir``, a scratch directory); ``PLAIN[name](frames, result)``
checks the result and returns its max abs error (0.0: bit for bit).
``NEEDS[name]`` are the kernels of A-H a request launches: the joins of
TPC-H q12 and q14 (B, F, G, D, H) and G1's one-key groupbys (q1 and q4
the one-hot tier A, q3 and q5 the radix tier B, F, G, D); the file
formats launch none.  ``ROUTE[name]`` is the ``io.IO_ROUTES`` tier it
takes: "native" for every request (a GPU machine has no pyarrow).
"""

from __future__ import annotations

import os

import torch

from cudf_tpu_torch.core import dtypes as dt
from cudf_tpu_torch.core.column import Column

TAXI_ROWS = 12_700_000
G1_ROWS = 10_000_000
PAYMENT_TYPES = ("CSH", "CRD", "DIS", "NOC")
G1_CSV_DTYPES = {"id1": "category", "id2": "category", "id3": "category",
                 **{n: "int32" for n in ("id4", "id5", "id6", "v1", "v2")}, "v3": "float64"}
ONEHOT = ["onehot_groupby_aggregate"]
RADIX = ["digit_histogram", "tile_sort_data", "merge_scatter", "bucket_aggregate"]
JOIN = RADIX + ["window_probe"]
_JAN_2015_S = 1_420_070_400


def _gamma(shape: int, scale: float, n: int, gen, device) -> torch.Tensor:
    """Gamma(shape, scale) draws of an integer shape: sums of exponentials."""
    u = torch.rand((shape, n), generator=gen, device=device, dtype=torch.float64)
    return -torch.log1p(-u).sum(0) * scale


def _cents(x: torch.Tensor) -> torch.Tensor:
    return torch.round(x * 100) / 100


def fixed_strings(keys, codes: torch.Tensor) -> Column:
    """A STRING column of ``keys[codes]`` for host keys of one width."""
    w = len(keys[0])
    table = torch.tensor([list(k.encode()) for k in keys], dtype=torch.uint8,
                         device=codes.device)
    n = codes.numel()
    offsets = torch.arange(n + 1, dtype=torch.int64, device=codes.device) * w
    return Column(dt.STRING, n, table[codes.long()].reshape(-1), None, offsets)


def taxi_frame(n: int = TAXI_ROWS, seed: int = 11, device="cuda"):
    from cudf_tpu_torch.frame.dataframe import DataFrame

    gen = torch.Generator(device=device).manual_seed(seed)

    def ints(lo, hi):
        return torch.randint(lo, hi, (n,), generator=gen, device=device, dtype=torch.int32)

    pickup = (_JAN_2015_S + torch.randint(0, 31 * 86_400, (n,), generator=gen, device=device))
    tip_on = torch.rand(n, generator=gen, device=device) < 0.6
    return DataFrame({
        "vendor_id": ints(1, 3),
        "passenger_count": ints(1, 7),
        "trip_distance": _cents(_gamma(2, 1.5, n, gen, device)),
        "pickup_datetime": Column(dt.TIMESTAMP_NS, n, pickup * 1_000_000_000),
        "payment_type": fixed_strings(PAYMENT_TYPES, ints(0, len(PAYMENT_TYPES))),
        "fare_amount": _cents(_gamma(3, 4.0, n, gen, device)),
        "tip_amount": _cents(_gamma(1, 2.0, n, gen, device) * tip_on),
        "total_amount": _cents(_gamma(4, 4.0, n, gen, device)),
    })


def g1_frame(n: int = G1_ROWS, seed: int = 7, device="cuda"):
    """G1_<n>_1e2_0_0 on the device; v3 holds the doubles nearest its
    6-decimal text (micro-units over 1e6, one correctly rounded division)."""
    from cudf_tpu_torch.frame.dataframe import DataFrame

    gen = torch.Generator(device=device).manual_seed(seed)
    k, kn = 100, max(n // 100, 1)

    def ints(lo, hi):
        return torch.randint(lo, hi + 1, (n,), generator=gen, device=device,
                             dtype=torch.int32)

    cols = {}
    for name, size, width in (("id1", k, 3), ("id2", k, 3), ("id3", kn, 10)):
        keys = Column.from_strings([f"id{i:0{width}d}" for i in range(1, size + 1)],
                                   device=device)
        cols[name] = Column.from_dictionary(ints(0, size - 1), keys)
    cols.update(id4=ints(1, k), id5=ints(1, k), id6=ints(1, kn), v1=ints(1, 5), v2=ints(1, 15))
    micro = torch.round(torch.rand(n, generator=gen, device=device, dtype=torch.float64) * 1e8)
    cols["v3"] = micro / 1e6
    return DataFrame(cols)


def _int_piece(x: torch.Tensor):
    """(digit matrix [n, w] uint8, lengths) of non-negative ints."""
    x = x.long()
    w = max(len(str(int(x.max()))) if x.numel() else 1, 1)
    lens = torch.ones_like(x)
    for p in range(1, w):
        lens += (x >= 10 ** p).long()
    pos = torch.arange(w, device=x.device)
    power = (lens.unsqueeze(1) - 1 - pos).clamp(min=0)
    digits = (x.unsqueeze(1) // torch.pow(10, power)) % 10
    return (48 + digits).to(torch.uint8), lens


def _frac_piece(micro: torch.Tensor):
    """(".dddddd" without trailing zeros, or nothing, lengths)."""
    f = micro.long() % 1_000_000
    digits = torch.stack([(f // 10 ** (5 - k)) % 10 for k in range(6)], 1)
    keep = torch.zeros_like(f)
    nonzero_seen = torch.zeros_like(f, dtype=torch.bool)
    for k in range(5, -1, -1):
        nonzero_seen |= digits[:, k] != 0
        keep += nonzero_seen.long()
    mat = torch.cat([torch.full_like(f, ord(".")).unsqueeze(1), 48 + digits], 1)
    return mat.to(torch.uint8), torch.where(keep > 0, keep + 1, 0)


def _dict_piece(col: Column):
    keys = col.keys
    w = int(keys.offsets[1] - keys.offsets[0])
    mat = keys.data.view(keys.length, w)[col.data.long()]
    return mat, torch.full((col.length,), w, dtype=torch.int64, device=mat.device)


def g1_csv(df) -> torch.Tensor:
    """uint8 tensor: the G1 frame's CSV text (a header line, then one line
    a row), assembled on the device: each field's bytes as a digit or key
    byte matrix and a length, scattered after the row's earlier fields."""
    t = df._table
    dev = t.device
    n = t.num_rows
    micro = torch.round(t["v3"].data * 1e6)
    comma = (torch.full((n, 1), ord(","), dtype=torch.uint8, device=dev),
             torch.ones(n, dtype=torch.int64, device=dev))
    newline = (torch.full((n, 1), ord("\n"), dtype=torch.uint8, device=dev), comma[1])
    pieces = []
    for name in ("id1", "id2", "id3"):
        pieces += [_dict_piece(t[name]), comma]
    for name in ("id4", "id5", "id6", "v1", "v2"):
        pieces += [_int_piece(t[name].data), comma]
    pieces += [_int_piece(micro // 1_000_000), _frac_piece(micro), newline]
    header = torch.tensor(list(b"id1,id2,id3,id4,id5,id6,v1,v2,v3\n"), dtype=torch.uint8,
                          device=dev)
    row_len = sum(lens for _, lens in pieces)
    starts = torch.cumsum(row_len, 0) - row_len + header.numel()
    out = torch.empty(header.numel() + int(row_len.sum()), dtype=torch.uint8, device=dev)
    out[:header.numel()] = header
    at = starts.clone()
    for mat, lens in pieces:
        for p in range(mat.shape[1]):
            keep = p < lens
            out[(at + p)[keep]] = mat[:, p][keep]
        at += lens
    return out


def write_bytes(path: str, data: torch.Tensor) -> None:
    with open(path, "wb") as f:
        f.write(data.cpu().numpy().tobytes())


# ----------------------------------------------------------------------
# requests
# ----------------------------------------------------------------------

def _path(frames, name):
    return os.path.join(frames["dir"], name)


def _write_taxi(frames):
    frames["taxi"].to_parquet(_path(frames, "taxi.parquet"), compression="snappy")
    return os.path.getsize(_path(frames, "taxi.parquet"))


def _read_taxi(frames):
    from cudf_tpu_torch.io.parquet import read_parquet

    return read_parquet(_path(frames, "taxi.parquet"), device=frames["device"])


def _write_tpch(frames):
    for name in ("lineitem", "orders", "part"):
        frames["tpch"][name].to_parquet(_path(frames, f"{name}.parquet"))
    return sum(os.path.getsize(_path(frames, f"{n}.parquet"))
               for n in ("lineitem", "orders", "part"))


def tpch_files(frames):
    from cudf_tpu_torch.engine import scan_parquet

    return {n: scan_parquet(_path(frames, f"{n}.parquet"), device=frames["device"])
            for n in ("lineitem", "orders", "part")}


def _tpch_query(q):
    def run(frames):
        from cudf_tpu_torch.models import tpch

        return tpch.QUERIES[q](tpch_files(frames))
    return run


def _sink_q1(frames):
    from cudf_tpu_torch.engine import col, lit
    from cudf_tpu_torch.io.parquet import read_parquet
    from cudf_tpu_torch.models import tpch

    lf = tpch_files(frames)["lineitem"].filter(col("l_shipdate") <= lit(tpch.Q1_CUTOFF)) \
        .group_by("l_returnflag", "l_linestatus") \
        .agg(col("l_quantity").sum().alias("sum_qty"),
             col("l_extendedprice").sum().alias("sum_base_price"),
             col("l_quantity").count().alias("count_order")) \
        .sort(["l_returnflag", "l_linestatus"])
    written = lf.sink_parquet(_path(frames, "q1.parquet")).collect()
    return written, read_parquet(_path(frames, "q1.parquet"), device=frames["device"])


def _read_g1_csv(frames):
    from cudf_tpu_torch.io.csv import read_csv

    return read_csv(_path(frames, "g1.csv"), dtype=G1_CSV_DTYPES, device=frames["device"])


def _g1_question(q):
    def run(frames):
        from cudf_tpu_torch.models import g1

        return g1.QUESTIONS[q](frames["g1_csv"])
    return run


def nested_frame(g1df):
    """A LIST<int32> column (``groupby("id4").v1.agg(list)``) and a STRUCT of
    (id4, v3) over G1's rows."""
    from cudf_tpu_torch.frame.dataframe import DataFrame

    lists = g1df.groupby("id4")["v1"].agg(list)
    t = g1df._table
    st = Column(dt.struct_dtype([("id4", t["id4"].dtype), ("v3", t["v3"].dtype)]),
                t.num_rows, None, children=[t["id4"], t["v3"]])
    return DataFrame({"v1": lists._column}), DataFrame({"s": st})


def _nested(kind):
    def run(frames):
        from cudf_tpu_torch.io.parquet import read_parquet

        df = frames[f"nested_{kind}"]
        df.to_parquet(_path(frames, f"{kind}.parquet"))
        return read_parquet(_path(frames, f"{kind}.parquet"), device=frames["device"])
    return run


def _arrow_round_trip(frames):
    from cudf_tpu_torch.frame.dataframe import DataFrame

    return DataFrame.from_arrow(frames["g1"], device=frames["device"])


REQUESTS = {
    "taxi_write": _write_taxi,
    "taxi_read": _read_taxi,
    "tpch_write": _write_tpch,
    "tpch_q1_file": _tpch_query("q1"),
    "tpch_q6_file": _tpch_query("q6"),
    "tpch_q12_file": _tpch_query("q12"),
    "tpch_q14_file": _tpch_query("q14"),
    "tpch_q1_sink": _sink_q1,
    "g1_read_csv": _read_g1_csv,
    **{f"g1_{q}_csv": _g1_question(q) for q in ("q1", "q2", "q3", "q4", "q5")},
    "nested_list": _nested("list"),
    "nested_struct": _nested("struct"),
    "arrow_stream": _arrow_round_trip,
}
GROUPS = {
    "taxi": ["taxi_write", "taxi_read"],
    "tpch": ["tpch_write", "tpch_q1_file", "tpch_q6_file", "tpch_q12_file", "tpch_q14_file",
             "tpch_q1_sink"],
    "g1": ["g1_read_csv", "g1_q1_csv", "g1_q2_csv", "g1_q3_csv", "g1_q4_csv", "g1_q5_csv",
           "nested_list", "nested_struct", "arrow_stream"],
}


# ----------------------------------------------------------------------
# plain checks
# ----------------------------------------------------------------------

class Mismatch(AssertionError):
    pass


def _need(cond, what):
    if not cond:
        raise Mismatch(what)


def same_bits(got: Column, exp: Column, what: str) -> float:
    """Two columns bit for bit: data (NaN and -0.0 included), offsets,
    validity, children; a DICTIONARY against a STRING by its values."""
    if exp.dtype.is_dictionary and got.dtype.is_string:
        exp = exp.decode_dictionary()
    _need(got.length == exp.length, f"{what}: {got.length} rows vs {exp.length}")
    gv, ev = got.validity, exp.validity
    _need((gv is None or bool(gv.all())) == (ev is None or bool(ev.all())) and
          (gv is None or ev is None or torch.equal(gv, ev)), f"{what}: validity differs")
    for a, b, part in ((got.data, exp.data, "data"), (got.offsets, exp.offsets, "offsets")):
        _need((a is None) == (b is None), f"{what}: {part} missing")
        if a is not None:
            if part == "offsets":
                a, b = a - a[0], b - b[0]
            _need(a.dtype == b.dtype and a.shape == b.shape and
                  torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8)),
                  f"{what}: {part} differs ({a.dtype}{list(a.shape)} vs "
                  f"{b.dtype}{list(b.shape)})")
    for i, (a, b) in enumerate(zip(got.children, exp.children)):
        same_bits(a, b, f"{what} child {i}")
    return 0.0


def same_frame(got, exp, what: str) -> float:
    g, e = got._table, exp._table
    _need(list(g.names) == list(e.names), f"{what}: columns {list(g.names)}")
    for n in e.names:
        same_bits(g[n], e[n], f"{what} {n}")
    return 0.0


def _plain_taxi_read(frames, res):
    return same_frame(res, frames["taxi"], "taxi month read back")


def _plain_tpch(q):
    def check(frames, res):
        from cudf_tpu_torch.models import tpch

        return _agree(f"TPC-H {q} from Parquet", tpch.answer(q, res),
                      tpch.PLAIN[q](frames["tpch"]))
    return check


def _agree(what, got, exp) -> float:
    """keys, counts and order exact, floats rtol 1e-9 (tpch.answer's forms)."""
    if isinstance(exp, float):
        _need(abs(got - exp) <= 1e-9 * abs(exp), f"{what}: {got} vs {exp}")
        return abs(got - exp)
    if isinstance(exp, torch.Tensor):
        _need(got.shape == exp.shape, f"{what}: shape {list(got.shape)}")
        if exp.is_floating_point():
            _need(torch.allclose(got.double(), exp.double(), rtol=1e-9, atol=0.0),
                  f"{what}: differs")
            return float((got.double() - exp.double()).abs().max()) if got.numel() else 0.0
        _need(torch.equal(got.long(), exp.long()), f"{what}: differs")
        return 0.0
    if isinstance(exp, dict):
        _need(list(got) == list(exp), f"{what}: columns {list(got)}")
        return max([_agree(f"{what} {k}", got[k], exp[k]) for k in exp] or [0.0])
    if isinstance(exp, tuple):
        return max(_agree(f"{what}[{i}]", g, e) for i, (g, e) in enumerate(zip(got, exp)))
    _need(got == exp, f"{what}: {got} vs {exp}")
    return 0.0


def _plain_sink(frames, res):
    written, back = res
    return same_frame(back, written, "q1 result written and read back")


def _plain_g1_csv(frames, res):
    """ints and strings exact, v3 within 1 ulp; returns the largest v3
    error in ulps."""
    exp = frames["g1"]._table
    got = res._table
    _need(list(got.names) == list(exp.names), f"G1 CSV columns {list(got.names)}")
    for n in ("id1", "id2", "id3"):
        same_bits(got[n].keys, exp[n].keys, f"G1 CSV {n} keys")
        same_bits(got[n].with_validity(None), exp[n], f"G1 CSV {n} codes")
    for n in ("id4", "id5", "id6", "v1", "v2"):
        same_bits(got[n], exp[n], f"G1 CSV {n}")
    ulps = (got["v3"].data.view(torch.int64) - exp["v3"].data.view(torch.int64)).abs()
    worst = int(ulps.max()) if ulps.numel() else 0
    _need(worst <= 1 and got["v3"].validity is None, f"G1 CSV v3: {worst} ulps")
    return float(worst)


def _plain_g1_question(q):
    def check(frames, res):
        from cudf_tpu_torch.models import g1

        exp = g1.QUESTIONS[q](frames["g1"])._table
        got = res._table
        _need(list(got.names) == list(exp.names), f"G1 {q} from CSV: columns")
        err = 0.0
        for n in exp.names:
            a, b = got[n], exp[n]
            if a.dtype.is_dictionary:
                same_bits(a.decode_dictionary(), b.decode_dictionary(), f"G1 {q} {n}")
            elif a.data.is_floating_point():
                _need(torch.allclose(a.data, b.data, rtol=1e-12, atol=0.0),
                      f"G1 {q} {n}: differs")
                err = max(err, float((a.data - b.data).abs().max()))
            else:
                same_bits(a, b, f"G1 {q} {n}")
        return err
    return check


def _plain_nested(kind):
    def check(frames, res):
        return same_frame(res, frames[f"nested_{kind}"], f"nested {kind} read back")
    return check


def _plain_arrow(frames, res):
    return same_frame(res, frames["g1"], "G1 through the Arrow C stream")


PLAIN = {
    "taxi_write": lambda frames, size: 0.0 if size > 0 else float("inf"),
    "taxi_read": _plain_taxi_read,
    "tpch_write": lambda frames, size: 0.0 if size > 0 else float("inf"),
    **{f"tpch_{q}_file": _plain_tpch(q) for q in ("q1", "q6", "q12", "q14")},
    "tpch_q1_sink": _plain_sink,
    "g1_read_csv": _plain_g1_csv,
    **{f"g1_{q}_csv": _plain_g1_question(q) for q in ("q1", "q2", "q3", "q4", "q5")},
    "nested_list": _plain_nested("list"),
    "nested_struct": _plain_nested("struct"),
    "arrow_stream": _plain_arrow,
}
NEEDS = {name: [] for name in REQUESTS}
NEEDS.update({"tpch_q12_file": JOIN, "tpch_q14_file": JOIN, "g1_q1_csv": ONEHOT,
              "g1_q4_csv": ONEHOT, "g1_q3_csv": RADIX, "g1_q5_csv": RADIX})
ROUTE = {name: "native" for name in REQUESTS}
# the frames key a result is kept under for the requests after it; the
# requests not replayed alone
KEEP = {"g1_read_csv": "g1_csv"}
ONCE = {"tpch_q1_sink"}
